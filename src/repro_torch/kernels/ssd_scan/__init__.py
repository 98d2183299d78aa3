"""Mamba-2 SSD: the CUDA intra-chunk kernel K6, its plain PyTorch version
and the ``ssd_forward`` entry point."""
