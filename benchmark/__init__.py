"""Benchmark of gatb_core_tpu_torch on one CUDA card (see README.md)."""
