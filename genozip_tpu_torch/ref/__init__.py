"""Reference genome store and the host aligner (FASTQ --reference)."""
