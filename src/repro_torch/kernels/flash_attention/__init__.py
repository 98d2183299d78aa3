"""Flash attention: the CUDA kernels K3 (forward), K4 and K5 (backward),
their plain PyTorch versions and the ``mha`` / ``mha_vjp`` entry points."""
