"""Batched single-lock ALock tables: the CUDA kernel K2, its plain PyTorch
versions and the ``monte_carlo_cs_entries`` entry point."""
