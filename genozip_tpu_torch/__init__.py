"""genozip_tpu_torch: the PyTorch/CUDA port of genozip_tpu.

FASTQ zip/unzip/cat/ls, single-end or paired, with or without a reference
genome (zip --make-reference, --reference, --REFERENCE), with every rANS
stream of 256 KiB or more coded by the hand-written CUDA kernels in
csrc/rans.cu. The package imports torch and never jax; archives and
reference files are byte-identical to genozip_tpu's.
"""
