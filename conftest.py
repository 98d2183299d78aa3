"""Root pytest configuration: let the JAX reference import on newer JAX.

``repro`` imports ``enable_x64`` / ``disable_x64`` from
``jax.experimental``; recent JAX releases only ship ``jax.enable_x64``.
Pytest loads this file before ``tests/conftest.py``, so aliasing the two
names here keeps the reference package untouched and importable.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.experimental as je  # noqa: E402

if not hasattr(je, "enable_x64"):
    je.enable_x64 = jax.enable_x64
if not hasattr(je, "disable_x64"):
    je.disable_x64 = lambda: jax.enable_x64(False)
