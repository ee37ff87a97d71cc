"""Benchmark of ryg_rans_tpu_torch on a CUDA card: run.py runs one cell."""
