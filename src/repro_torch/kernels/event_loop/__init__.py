"""The next-event loop: CUDA kernel wrapper, plain version, entry points."""
