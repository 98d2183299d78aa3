"""Root pytest configuration: let the JAX reference import on newer JAX,
and run torch on one intra-op thread.

``repro`` imports ``enable_x64`` / ``disable_x64`` from
``jax.experimental``; recent JAX releases only ship ``jax.enable_x64``.
Pytest loads this file before ``tests/conftest.py``, so aliasing the two
names here keeps the reference package untouched and importable.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.experimental as je  # noqa: E402
import torch  # noqa: E402

# pytest-xdist runs several workers on the host's cores, and the port's CPU
# engines work on tensors of a few hundred elements, far below torch's
# parallel grain: a pool of one thread per core in every worker only adds
# contention (one engine test takes about 5x longer with the default pool)
torch.set_num_threads(1)

if not hasattr(je, "enable_x64"):
    je.enable_x64 = jax.enable_x64
if not hasattr(je, "disable_x64"):
    je.disable_x64 = lambda: jax.enable_x64(False)
