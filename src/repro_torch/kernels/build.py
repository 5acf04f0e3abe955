"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources live in ``csrc/``: ``widesa_mm.cu`` (the mm/bmm GEMMs:
the skinny kernel, the tensor-core ones for floats and integers, and the
tiled one),
``widesa_sp.cu`` (the FIR, conv2d and fused fft2d signal-processing
kernels) and
``widesa_hpc.cu`` (the star stencil and the two MTTKRP kernels).  Each
source is its own shared library; the first call on a machine compiles
every source that is not built yet with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, into
``build/repro_torch_kernels/`` under the repository root, and loads the
libraries with ``ctypes``.  A library's file name carries a hash of its
source and the flags, so an edited source builds anew and an unchanged
one loads what is there.  The kernels take plain pointers and a stream,
and return a ``cudaError_t``: ``call`` raises on anything but success.

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

CSRC = Path(__file__).with_name("csrc")
#: the GEMM source (mm/bmm), the signal-processing source (fir/conv2d/fft2d) and
#: the HPC source (the star stencils and mttkrp)
SOURCE = CSRC / "widesa_mm.cu"
SP_SOURCE = CSRC / "widesa_sp.cu"
HPC_SOURCE = CSRC / "widesa_hpc.cu"
#: library name -> source
SOURCES = {"widesa_mm": SOURCE, "widesa_sp": SP_SOURCE,
           "widesa_hpc": HPC_SOURCE}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: dtype codes of the C entry points (``enum DType`` in both csrc sources)
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
#: every tile a tiled-kernel launch may name
MM_TILES = frozenset(COMPILED_TILES + SWEEP_TILES)
#: the tiled kernel's entry points, whose tile picks the library
_TILED_ENTRIES = ("widesa_mm_launch", "widesa_bmm_launch")

#: compiled FIR output tiles (``BN``, outputs a block computes: 256
#: threads x 1 or 4 outputs) and conv2d output tiles (``BH``, ``BW``: 256
#: threads as 4 rows x 64 columns, 1 or 4 rows a thread); kept equal to
#: ``launch_fir``/``launch_conv2d`` in csrc/widesa_sp.cu
FIR_TILES = (256, 1024)
CONV2D_TILES = ((4, 64), (16, 64))

#: (input, output) dtype pairs of the FIR and conv2d kernels, and of the
#: star stencil and MTTKRP kernels (the int32 grid is jacobi2d_ms's state)
SP_DTYPES = HPC_DTYPES = frozenset({
    (torch.float32, torch.float32),
    (torch.int8, torch.int32),
    (torch.int16, torch.int32),
    (torch.int32, torch.int32),
})

#: the compiled star-stencil output tile (``BH``, ``BW``: 256 threads as 8
#: rows x 32 columns, each 4 rows of 4 columns), for star radii 1 and 2,
#: and the CUDA-core MTTKRP kernel's output tile (``BI``, ``BJ``: 256
#: threads as 16 x 16, each 4 rows of 4 columns); kept equal to
#: ``launch_star`` and ``launch_mttkrp`` in csrc/widesa_hpc.cu.  The
#: tensor-core MTTKRP kernel's geometry is ``runtime.MTTKRP_TC_*``.
STENCIL_TILE = (32, 128)
STENCIL_RADII = (1, 2)
MTTKRP_TILE = (64, 64)

#: entry point -> (library, argument types): pointers, then the ints of
#: the shape, dtype codes and tile, then the stream
_ENTRIES = {
    # the GEMMs: (batch,) shape, A's row pitch, B's layout, dtypes, then
    # the tiled kernel's tile; the skinny kernel's split, K range per block,
    # B's copy width and A's vector flag; the tensor-core kernel's output
    # tile, ring stages and split of K
    "widesa_mm_launch": ("widesa_mm", [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    "widesa_bmm_launch": ("widesa_mm", [ctypes.c_void_p] * 3
                          + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "widesa_skinny_launch": ("widesa_mm", [ctypes.c_void_p] * 3
                             + [ctypes.c_int] * 12 + [ctypes.c_void_p]),
    "widesa_tc_launch": ("widesa_mm", [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 12 + [ctypes.c_void_p]),
    # the integer tensor-core GEMM: A, B, C and the limb planes' scratch,
    # then the shape, B's layout, the input dtype and the configuration
    "widesa_tc_int_launch": ("widesa_mm", [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "widesa_fir_launch": ("widesa_sp", [ctypes.c_void_p] * 3
                          + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "widesa_conv2d_launch": ("widesa_sp", [ctypes.c_void_p] * 3
                             + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    # the fused fft2d: X's planes, F_R's, F_C's, Z's; R, C and the split
    "widesa_fft2d_launch": ("widesa_sp", [ctypes.c_void_p] * 8
                            + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    # the star's (di, dj) pairs come as a host int array
    "widesa_star_launch": ("widesa_hpc", [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "widesa_mttkrp_launch": ("widesa_hpc", [ctypes.c_void_p] * 4
                             + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    # the tensor-core MTTKRP: shape, dtypes, split, X's copy width
    "widesa_mttkrp_tc_launch": ("widesa_hpc", [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
}

_LIBS: dict[tuple[str, bool], ctypes.CDLL] = {}
#: (entry, sweep) -> the bound C function, looked up once
_FNS: dict[tuple[str, bool], ctypes._CFuncPtr] = {}

#: what the last build printed (register and shared-memory use per
#: kernel, from ``-Xptxas -v``) and how long it took on the wall clock,
#: in seconds (the sources compile in parallel)
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


def _flags(sweep: bool) -> tuple[str, ...]:
    return NVCC_FLAGS + (("-DWIDESA_SWEEP_TILES",) if sweep else ())


def _target(name: str, sweep: bool) -> Path:
    digest = hashlib.sha1(
        SOURCES[name].read_bytes() + " ".join(_flags(sweep)).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}{'-sweep' if sweep else ''}-{digest}.so"


def build(names=tuple(SOURCES), sweep: bool = False) -> dict[str, Path]:
    """Build the libraries ``names`` (the mm one with every SWEEP_TILES
    tile when ``sweep``) that are not built yet, one ``nvcc`` each, all
    running at once; return each library's path."""
    global build_log, build_seconds
    out = {name: _target(name, sweep) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *_flags(sweep), "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        logs.append(f"== {SOURCES[name].name}\n{text}")
        if proc.returncode != 0:
            failed.append(SOURCES[name].name)
        else:
            os.replace(tmp, todo[name])
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    return out


def library(name: str, sweep: bool = False) -> ctypes.CDLL:
    """The loaded library ``name``, built at first use."""
    if (name, sweep) not in _LIBS:
        lib = ctypes.CDLL(str(build((name,), sweep)[name]))
        for entry, (owner, argtypes) in _ENTRIES.items():
            if owner == name:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.widesa_error_string.argtypes = [ctypes.c_int]
        lib.widesa_error_string.restype = ctypes.c_char_p
        _LIBS[(name, sweep)] = lib
    return _LIBS[(name, sweep)]


#: the current stream's handle, read without building a
#: ``torch.cuda.Stream`` object on every launch (PyTorch builds without
#: it take the public call)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream() -> int:
    """The handle of the current CUDA stream of the current device."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream().cuda_stream
    return _RAW_STREAM(torch.cuda.current_device())


def call(entry: str, *args, tiles: tuple[int, ...] = ()) -> None:
    """Launch one kernel entry point with ``args`` and ``tiles`` on the
    current stream; raise if the launch was refused.  A tiled-GEMM tile
    outside COMPILED_TILES loads the sweep library."""
    sweep = entry in _TILED_ENTRIES and tiles not in COMPILED_TILES
    fn = _FNS.get((entry, sweep))
    if fn is None:
        fn = _FNS[(entry, sweep)] = getattr(
            library(_ENTRIES[entry][0], sweep), entry)
    err = fn(*args, *tiles, current_stream())
    if err != 0:
        lib = library(_ENTRIES[entry][0], sweep)
        raise RuntimeError(
            f"{entry} failed: CUDA error {err} "
            f"({lib.widesa_error_string(err).decode()})")
