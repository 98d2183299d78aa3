"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root at first use and loaded with ``ctypes``. The wrapper that
launches a library declares it once, as a ``Library``: its entry points'
``argtypes``, its flags and its launch counts. ``declared()`` lists every
declaration, and ``check_operands`` is the launchers' check of dtypes,
shapes and device. A library's name carries ``build_key``: a hash of its
source, the headers beside it, its flags and ``nvcc --version``, so an
edit or another toolkit rebuilds. A failed build raises. Nothing here
runs at import time: importing this module needs neither ``nvcc`` nor a
CUDA device.

``FLAGS`` leave out ``--use_fast_math``: ``expf``/``logf`` stay the
accurate versions, which the float kernels' tolerances depend on.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
#: ``FLAGS`` and ptxas's report of registers, shared memory and spills per
#: kernel (``BUILD_LOG``): the float kernels' libraries
REPORT_FLAGS = FLAGS + ("-Xptxas", "-v")
#: dynamic shared memory one block may use on Hopper (opt-in above 48 KB;
#: ``cudaDevAttrMaxSharedMemoryPerBlockOptin``): every kernel's planner
#: plans against it
SMEM_LIMIT = 227 * 1024

#: stem -> wall seconds of the last ``nvcc`` run of this process
BUILD_SECONDS: dict[str, float] = {}
#: stem -> what the ``nvcc`` run that built the loaded library printed
#: (ptxas's report, with ``-Xptxas -v`` among the flags); kept beside the
#: library as ``<library>.log``
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked at PATH and /usr/local/cuda/bin/nvcc); "
        "the kernels are built from their CUDA sources at first use and "
        "cannot run without it")


@functools.cache
def nvcc_version() -> str:
    """What ``nvcc --version`` prints; run once per process."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def build_key(source: Path, flags, nvcc_version: str) -> str:
    """The hash a library's name carries: ``source``'s text, every
    ``.cuh`` beside it, ``flags`` and the compiler's version text."""
    parts = [source.read_bytes()]
    parts += [h.read_bytes() for h in sorted(source.parent.glob("*.cuh"))]
    parts += [" ".join(flags).encode(), nvcc_version.encode()]
    return hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]


def library_path(source: Path, stem: str, flags=FLAGS) -> Path:
    """Where the library of ``source`` built with ``flags`` by this
    process's ``nvcc`` lies (``build_dir()``), built or not."""
    tag = build_key(source, flags, nvcc_version())
    return build_dir() / f"lib{stem}_{tag}.so"


def build(source: Path, stem: str, flags=FLAGS) -> Path:
    """Compile ``source`` if no library for its current text, the headers
    beside it, ``flags`` and this ``nvcc`` exists; return the library's
    path. (Add ``-Xptxas -v`` to the flags to see registers, shared memory
    and spills.)"""
    lib = library_path(source, stem, flags)
    out_dir = lib.parent
    log = lib.with_name(lib.name + ".log")
    if lib.exists():
        if log.exists():
            BUILD_LOG[stem] = log.read_text()
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib.name}.{os.getpid()}.{id(source)}.tmp"
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[stem] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {source.name} failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG[stem] = proc.stdout + proc.stderr
    log.write_text(BUILD_LOG[stem])
    os.replace(tmp, lib)        # atomic: concurrent builds agree
    return lib


def build_all(specs) -> dict:
    """Build every ``(source, stem, flags)`` of ``specs`` at once, one
    ``nvcc`` each, all started together; return stem -> library path."""
    specs = list(specs)
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        paths = list(pool.map(lambda s: build(*s), specs))
    return {s[1]: p for s, p in zip(specs, paths)}


def load(source: Path, stem: str, setup, flags=FLAGS) -> ctypes.CDLL:
    """The library of ``source`` (built on first use), after ``setup(lib)``
    has set its ``argtypes``; loaded once per process."""
    if stem not in _LIBS:
        lib = ctypes.CDLL(str(build(source, stem, flags)))
        setup(lib)
        _LIBS[stem] = lib
    return _LIBS[stem]


def loaded_path(stem: str) -> Path:
    """The file of the library ``load`` loaded for ``stem`` (KeyError when
    none is loaded)."""
    return Path(_LIBS[stem]._name)


def bind(lib, signatures: dict) -> None:
    """Set each ``name -> argtypes`` of ``signatures`` on ``lib`` (every
    entry point returns an int) and its ``kernel_error_string``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


#: stem -> its declaration, for every wrapper imported so far
LIBRARIES: dict[str, Library] = {}


class Library:
    """One kernel library, ``csrc/<stem>.cu``, declared by the wrapper that
    launches it: the ``argtypes`` of its entry points (``signatures``), its
    nvcc ``flags`` and a launch count for each name of ``counts`` (one
    count unless the library holds more than one kernel). Declaring it
    registers it in ``LIBRARIES``; a stem is declared once."""

    def __init__(self, stem: str, signatures: dict, flags=FLAGS, *,
                 counts=("launches",)):
        if stem in LIBRARIES:
            raise ValueError(f"the kernel library {stem!r} is declared "
                             f"twice")
        self.stem, self.signatures, self.flags = stem, signatures, flags
        self.source = CSRC / f"{stem}.cu"
        self._launches = dict.fromkeys(counts, 0)
        LIBRARIES[stem] = self

    def build(self) -> Path:
        return build(self.source, self.stem, self.flags)

    def load(self) -> ctypes.CDLL:
        """The library (built on first use), with its ``argtypes`` set;
        loaded once per process."""
        return load(self.source, self.stem,
                    lambda lib: bind(lib, self.signatures), self.flags)

    def count(self, name: str = "launches") -> None:
        """Count one launch; nothing but the library's launchers calls
        it."""
        self._launches[name] += 1

    def launches(self):
        """Launches since the last ``reset_launches()``: an int, or name ->
        int for a library of more than one count."""
        if len(self._launches) == 1:
            return next(iter(self._launches.values()))
        return dict(self._launches)

    def reset_launches(self) -> None:
        for name in self._launches:
            self._launches[name] = 0


def declared() -> dict[str, Library]:
    """Every kernel library, stem -> declaration: imports each module of
    ``repro_torch.kernels``, so that every wrapper has declared its own."""
    import importlib
    import pkgutil
    pkg = importlib.import_module(__package__)
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)
    return dict(LIBRARIES)


def check_launch(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch): a refused launch never
    runs, and a later synchronise would not report it."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, **tensors) -> None:
    """Raise unless every tensor lies on one CUDA device and is
    contiguous: the kernels take nothing else."""
    devs = {t.device for t in tensors.values()}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"{what} needs CUDA tensors, {name} lies on {t.device}; use "
                f"backend='plain' for the PyTorch version")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if len(devs) != 1:
        raise ValueError(f"{what}: all operands must lie on one CUDA device, "
                         f"got {sorted(map(str, devs))}")


def check_operands(what: str, dtype=None, **operands) -> None:
    """Raise ``ValueError`` unless every operand has its dtype and shape
    and all are contiguous tensors on one CUDA device (``require_cuda``).
    An operand is ``(tensor, dtype, shape)``, or a tensor, which must be of
    ``dtype`` and may have any shape."""
    tensors = {}
    for name, op in operands.items():
        t, dt, shape = (op, dtype, None) if isinstance(op, torch.Tensor) \
            else op
        tensors[name] = t
        if t.dtype != dt or (shape is not None
                             and tuple(t.shape) != tuple(shape)):
            want = dt if shape is None else f"{dt} of shape {tuple(shape)}"
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    require_cuda(what, **tensors)
