"""genozip_tpu_torch: the PyTorch/CUDA port of genozip_tpu.

zip/unzip/cat/ls of FASTQ (single-end or paired), SAM, BAM and VCF, with
or without a reference genome (zip --make-reference, --reference,
--REFERENCE), and of FASTA, GFF, BED, 23andMe, LOCS and generic files, with
every rANS stream of 256 KiB or more coded by the hand-written CUDA kernels
in csrc/rans.cu, and encrypted archives (--password) by the AES-256-CTR
kernel in csrc/aes.cu; `zip --best` (BWT among its codecs), --md5,
--truncate, --tar, --replace, --biopsy, and URL, CRAM, BCF and ORA inputs.
The package imports torch and never jax; archives and reference files are
byte-identical to genozip_tpu's.
"""
