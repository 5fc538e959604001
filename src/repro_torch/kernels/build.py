"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. No ``--use_fast_math``:
the kernels rely on IEEE division and ``rintf``. The library goes to
``kernels/build/`` (ignored by git) under a name keyed by a hash of the
sources, the headers they include (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
Nothing is built or loaded until a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: argument types in order; each returns cudaGetLastError()
# unless RESTYPES says otherwise.
SIGNATURES = {
    # x, codes, scale, hemi, y, scratch (or null), B, I, S, O, k1, ld,
    # n_levels, half, x_min, step, stream
    "kan_fused_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _F, _P),
    # B, I, S, O -> f64 elements of scratch that kan_fused_launch needs
    "kan_fused_scratch": (_I, _I, _I, _I),
    # v, w, atten, out, scratch (or null), rows_iterated (or null), B, R, C,
    # array_size, lsb, stream
    "cim_mac_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # B, R, C, array_size -> f32 elements of scratch that cim_mac_launch needs
    "cim_mac_scratch": (_I, _I, _I, _I),
    # v, w, gain (or null), atten, out, rows_iterated (or null), B, R, C,
    # array_size, lsb, stream
    "cim_mac_tiled_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                             _P),
    # x, dt, a, B, C, d_skip (or null), init (or null), workspace, its f32
    # elements, y, final, B, T, H, P, N, chunk, x/dt/B/C batch and time
    # strides, stream
    "ssd_scan_launch": (_P,) * 8 + (_L,) + (_P,) * 2 + (_I,) * 6 + (_L,) * 8
                       + (_P,),
    # out, blocks, iters, stream: the rate of ssd_scan's MMA building block
    "ssd_mma_probe": (_P, _I, _I, _P),
    # x, hemi, out, n_inputs, S, k1, ld, n_levels, half, x_min, step, stream
    "kan_basis_launch": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _P),
}
RESTYPES = {"kan_fused_scratch": _L, "cim_mac_scratch": _L}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(tmp / f"{src.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / lib_path.name),
             *(str(tmp / f"{s.stem}.o") for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib_path.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp / lib_path.name, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and return types declared."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
