"""The benchmark of genozip_tpu_torch (the PyTorch and CUDA port): zip and
unzip of whole files on the card, run by `benchmark/run.py`, one cell a
run. It imports neither JAX nor genozip_tpu."""
