"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources live in ``csrc/``; the first call on a machine compiles them
with ``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch_kernels/``
under the repository root and loads the library with ``ctypes``.  The
library's file name carries a hash of the source and the flags, so an
edited source builds anew and an unchanged one loads what is there.  The
kernels take plain pointers and a stream, and return a ``cudaError_t``:
``call`` raises on anything but success.

Nothing here runs at import time, so the CPU-only tests import the
wrappers freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "widesa_mm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: dtype codes of the C entry points (``enum DType`` in csrc/widesa_mm.cu)
DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1,
    torch.int8: 2, torch.int16: 3, torch.int32: 4,
}

#: (input, output) dtype pairs the library is compiled for: floats flush
#: to their own dtype (bf16 also to fp32), integers to int32
COMPILED_DTYPES = frozenset({
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.int8, torch.int32),
    (torch.int16, torch.int32),
    (torch.int32, torch.int32),
})

#: the compiled (BM, BN, BK) tiles (``launch_dtype`` in csrc/widesa_mm.cu):
#: for each row count BM, the narrowest BN that still gives a block of
#: 128 threads, with a K slice of 8 (for a column-major B) or 32
COMPILED_TILES = (
    (1, 128, 8), (1, 128, 32),
    (4, 32, 8), (4, 32, 32),
    (16, 32, 8), (16, 32, 32),
    (64, 32, 8), (64, 32, 32),
)
COMPILED_BM = tuple(sorted({t[0] for t in COMPILED_TILES}))

#: the tiles ``chip_smoke.py --tile-sweep`` times: every (BM, BN, BK) of
#: these extents.  A launch at one outside COMPILED_TILES loads a second
#: library, built with ``-DWIDESA_SWEEP_TILES`` on first use.
SWEEP_TILES = tuple(itertools.product((1, 4, 16, 64), (32, 64, 128), (8, 32)))

_ENTRY_ARGS = {
    "widesa_mm_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "widesa_bmm_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
}

_LIBS: dict[bool, ctypes.CDLL] = {}

#: what the last compile printed (register and shared-memory use per
#: kernel, from ``-Xptxas -v``) and how long it took, in seconds
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(sweep: bool = False) -> Path:
    """Build the shared library (with every SWEEP_TILES tile when
    ``sweep``) if this source has not been built yet."""
    global build_log, build_seconds
    flags = NVCC_FLAGS + (("-DWIDESA_SWEEP_TILES",) if sweep else ())
    digest = hashlib.sha1(
        SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libwidesa_mm-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{build_log}")
    os.replace(tmp, out)
    return out


def library(sweep: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    if sweep not in _LIBS:
        lib = ctypes.CDLL(str(library_path(sweep)))
        for name, argtypes in _ENTRY_ARGS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.widesa_error_string.argtypes = [ctypes.c_int]
        lib.widesa_error_string.restype = ctypes.c_char_p
        _LIBS[sweep] = lib
    return _LIBS[sweep]


def call(entry: str, *args, tiles: tuple[int, int, int]) -> None:
    """Launch one kernel entry point at ``tiles`` on the current stream;
    raise if the launch was refused."""
    lib = library(sweep=tiles not in COMPILED_TILES)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(*args, *tiles, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry} failed: CUDA error {err} "
            f"({lib.widesa_error_string(err).decode()})")
