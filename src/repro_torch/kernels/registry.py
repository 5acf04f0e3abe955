"""KernelSpec registry of the port: what executes a plan per recurrence.

The port's counterpart of ``repro.kernels.registry`` for the specs on the
serving paths: ``mm`` and ``bmm`` (every model GEMM), ``fir``, ``conv2d``
and ``fft2d_stage`` (the audio frontend).  Each spec declares its operand
arity, the grid loops of the reference kernel, how a plan's partition
becomes tile kwargs, how those map onto a compiled Hopper tile
(``tiles``), two lowerings — ``hopper`` (the hand-written CUDA kernel, or
for ``fft2d_stage`` a composition over the mm kernel) and ``ref`` (the
plain PyTorch version) — and the chain metadata the fusion pass reads
(``fusable_with``, ``n_outputs``).  ``parity_dtypes``, ``atol`` and the
smoke / bench sizes are the reference's, so one table drives both
packages' tests.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.core import recurrence as ir
from repro_torch.core.partition import MXU_LANES

from . import bmm as _bmm
from . import conv2d as _conv2d
from . import fft2d as _fft2d
from . import fir as _fir
from . import ref, runtime
from . import widesa_mm as _mm

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.mapper import ExecutionPlan
    from repro_torch.core.recurrence import UniformRecurrence


class UnregisteredRecurrenceError(NotImplementedError):
    """Raised when a plan names a recurrence with no registered KernelSpec."""

    def __init__(self, name: str):
        super().__init__(
            f"no KernelSpec registered for recurrence {name!r} in the port; "
            f"registered: {tuple(sorted(_REGISTRY))}")
        self.name = name


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    arity: int
    grid_loops: tuple[Any, ...]
    block_kwargs: Callable[["ExecutionPlan"], dict]
    tiles: Callable[..., "runtime.HopperTiles"]
    hopper: Callable[..., Any]
    ref: Callable[..., Any]
    builder: Callable[..., "UniformRecurrence"]
    fusable_with: tuple[str, ...] = ()
    n_outputs: int = 1
    parity_dtypes: tuple[str, ...] = ("float32", "int8", "int16")
    atol: float = 1e-3
    smoke_args: tuple[int, ...] = ()
    bench_cases: tuple[tuple[str, tuple[int, ...]], ...] = ()


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"KernelSpec {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnregisteredRecurrenceError(name) from None


def _mm_blocks(plan: "ExecutionPlan") -> dict:
    blk = plan.partition.block
    return {
        "bm": blk.get("i", MXU_LANES),
        "bn": blk.get("j", MXU_LANES),
        "bk": blk.get("k", MXU_LANES),
    }


def _gemm_tiles(plan: "ExecutionPlan", a, b) -> "runtime.HopperTiles":
    return runtime.hopper_tiles(plan, b_col_major=not b.is_contiguous())


register(KernelSpec(
    name="mm",
    arity=2,
    grid_loops=("i", "j", "k"),
    block_kwargs=_mm_blocks,
    tiles=_gemm_tiles,
    hopper=_mm.matmul,
    ref=ref.mm,
    builder=ir.matmul,
    fusable_with=("mm",),
    smoke_args=(256, 256, 256),
))

register(KernelSpec(
    name="bmm",
    arity=2,
    grid_loops=("b", "i", "j", "k"),
    block_kwargs=_mm_blocks,
    tiles=_gemm_tiles,
    hopper=_bmm.bmm,
    ref=ref.bmm,
    builder=ir.batched_matmul,
    smoke_args=(4, 128, 128, 64),
))

register(KernelSpec(
    name="fft2d_stage",
    arity=2,
    grid_loops=("i", "j", "k"),
    block_kwargs=_mm_blocks,
    # both DFT stages launch the mm kernel with row-major operands
    tiles=lambda plan, re, im: runtime.hopper_tiles(plan),
    hopper=_fft2d.fft2d,
    ref=ref.fft2d,
    builder=ir.fft2d_stage,
    fusable_with=("fft2d_stage",),
    n_outputs=2,
    # complex data rides as two float32 real planes; int DFT matrices do
    # not exist, so parity runs the float planes only
    parity_dtypes=("float32",),
    atol=1.0,
    smoke_args=(64, 64),
    bench_cases=(("cfloat", (8192, 8192)), ("cint16", (8192, 8192))),
))


def _conv_blocks(plan: "ExecutionPlan") -> dict:
    blk = plan.partition.block
    return {
        "bh": blk.get("h", MXU_LANES),
        "bw": blk.get("w", MXU_LANES),
    }


register(KernelSpec(
    name="conv2d",
    arity=2,
    grid_loops=("h", "w", ("p", "q")),
    block_kwargs=_conv_blocks,
    tiles=lambda plan, img, filt: runtime.conv2d_tile(
        plan, img.shape[0] - filt.shape[0] + 1,
        img.shape[1] - filt.shape[1] + 1),
    hopper=_conv2d.conv2d,
    ref=ref.conv2d,
    builder=ir.conv2d,
    fusable_with=("conv2d",),
    smoke_args=(64, 61, 4, 4),
    bench_cases=(
        ("float32", (10240, 10240, 4, 4)),
        ("int8", (10240, 10240, 8, 8)),
        ("int16", (10240, 10240, 4, 4)),
        ("int32", (10240, 10240, 4, 4)),
    ),
))


def _fir_blocks(plan: "ExecutionPlan") -> dict:
    return {"bn": plan.partition.block.get("n", 1024)}


register(KernelSpec(
    name="fir",
    arity=2,
    grid_loops=("n",),
    block_kwargs=_fir_blocks,
    tiles=lambda plan, x, h: runtime.fir_tile(
        plan, x.shape[0] - h.shape[0] + 1),
    hopper=_fir.fir,
    ref=ref.fir,
    builder=ir.fir,
    smoke_args=(1024, 15),
    bench_cases=(
        ("float32", (1048576, 15)),
        ("int8", (1048576, 15)),
        ("int16", (1048576, 15)),
        ("cfloat", (1048576, 15)),
    ),
))
