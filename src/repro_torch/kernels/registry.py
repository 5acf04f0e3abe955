"""KernelSpec registry of the port: what executes a plan per recurrence.

The port's counterpart of ``repro.kernels.registry``, with every
recurrence the reference registers: ``mm`` and ``bmm`` (every model
GEMM), ``fir``, ``conv2d`` and ``fft2d_stage`` (the audio frontend), the
star stencils ``jacobi2d``, ``jacobi2d_9pt`` and ``jacobi2d_ms``, and
``mttkrp``.  Each spec declares its operand arity and shapes, the grid
loops of the reference kernel, how a plan's partition becomes tile
kwargs, how those map onto a compiled Hopper tile (``tiles``), two
lowerings — ``hopper`` (the hand-written CUDA kernel; for
``fft2d_stage`` the fused kernel up to 64 rows, above it the FFT kernel
where both sides are powers of two, else a composition over the mm
kernel) and ``ref`` (the plain PyTorch version) — the
reference's chip-level hooks (``systolic_lowering``,
``allgather_lowering``, ``fused_systolic_lowering``: the schedules of
``kernels/systolic.py``; ``supports_systolic``) and the chain metadata
the fusion pass reads (``fusable_with``, ``n_outputs``).  ``parity_dtypes``, ``atol`` and the
smoke / bench sizes are the reference's, so one table drives both
packages' tests.  ``operands`` draws a recurrence's operands from a
seeded ``torch.Generator``, as the reference's ``_draw`` does from numpy.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import torch

from repro_torch.core import recurrence as ir
from repro_torch.core.partition import MXU_LANES

from . import bmm as _bmm
from . import conv2d as _conv2d
from . import fft2d as _fft2d
from . import fir as _fir
from . import jacobi2d as _jacobi2d
from . import mttkrp as _mttkrp
from . import ref, runtime
from . import systolic as chip
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
    #: the operands' shapes for a recurrence's extents
    operand_shapes: Callable[["UniformRecurrence"], tuple]
    #: the chip-level schedule hooks, ``(plan, mesh) -> Callable`` (the
    #: ``systolic`` / ``allgather`` backends, ``kernels/systolic.py``)
    systolic_lowering: Callable[..., Callable] | None = None
    allgather_lowering: Callable[..., Callable] | None = None
    fusable_with: tuple[str, ...] = ()
    #: the fused chain's one-mesh schedule, ``(fused_plan, mesh) ->
    #: Callable``, looked up on the chain's last (consumer) spec
    fused_systolic_lowering: Callable[..., Callable] | None = None
    n_outputs: int = 1
    parity_dtypes: tuple[str, ...] = ("float32", "int8", "int16")
    atol: float = 1e-3
    smoke_args: tuple[int, ...] = ()
    bench_cases: tuple[tuple[str, tuple[int, ...]], ...] = ()

    @property
    def supports_systolic(self) -> bool:
        """Whether a chip-level neighbour-stream schedule is registered."""
        return self.systolic_lowering is not None


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


def registered_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def specs() -> tuple[KernelSpec, ...]:
    return tuple(_REGISTRY[n] for n in registered_names())


def autotune_cases(spec: KernelSpec
                   ) -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The (dtype, builder-args) cases a crossover table must cover for
    ``spec``, as the reference's: the smoke case plus every bench case
    (bench sizes double as autotune keys)."""
    return ((spec.parity_dtypes[0], spec.smoke_args), *spec.bench_cases)


def _draw(generator: torch.Generator, shape, dtype: str, device):
    """One operand, as the reference's ``_draw``: integers in [-8, 8),
    anything else (float32, and the complex dtypes' float32 real planes)
    standard normal."""
    if dtype.startswith("int"):
        return torch.randint(-8, 8, shape, generator=generator,
                             device=device, dtype=getattr(torch, dtype))
    return torch.randn(shape, generator=generator, device=device)


def operands(rec: "UniformRecurrence", generator: torch.Generator,
             device="cpu") -> tuple[torch.Tensor, ...]:
    """Seeded operands of ``rec`` on ``device`` (``generator`` lives
    there): the one place the recurrence pipeline and the chip smoke draw
    from."""
    return tuple(_draw(generator, shape, rec.dtype, device)
                 for shape in get(rec.name).operand_shapes(rec))


def _mm_blocks(plan: "ExecutionPlan") -> dict:
    blk = plan.partition.block
    return {
        "bm": blk.get("i", MXU_LANES),
        "bn": blk.get("j", MXU_LANES),
        "bk": blk.get("k", MXU_LANES),
    }


register(KernelSpec(
    name="mm",
    arity=2,
    grid_loops=("i", "j", "k"),
    block_kwargs=_mm_blocks,
    tiles=runtime.gemm_tiles,
    hopper=_mm.matmul,
    ref=ref.mm,
    builder=ir.matmul,
    operand_shapes=lambda r: ((r.extent("i"), r.extent("k")),
                              (r.extent("k"), r.extent("j"))),
    systolic_lowering=chip.cannon_mm,
    allgather_lowering=chip.allgather_mm,
    fused_systolic_lowering=chip.fused_cannon_mm,
    fusable_with=("mm",),
    smoke_args=(256, 256, 256),
    bench_cases=(
        ("float32", (8192, 8192, 8192)),
        ("int8", (10240, 10240, 10240)),
        ("int16", (9600, 9600, 9600)),
        ("int32", (8192, 8192, 8192)),
    ),
))

register(KernelSpec(
    name="bmm",
    arity=2,
    grid_loops=("b", "i", "j", "k"),
    block_kwargs=_mm_blocks,
    tiles=runtime.gemm_tiles,
    hopper=_bmm.bmm,
    ref=ref.bmm,
    builder=ir.batched_matmul,
    operand_shapes=lambda r: ((r.extent("b"), r.extent("i"), r.extent("k")),
                              (r.extent("b"), r.extent("k"), r.extent("j"))),
    systolic_lowering=chip.cannon_bmm,
    allgather_lowering=chip.allgather_bmm,
    smoke_args=(4, 128, 128, 64),
    bench_cases=(
        ("float32", (64, 4096, 4096, 4096)),
        ("int8", (64, 4096, 4096, 4096)),
        ("int16", (64, 4096, 4096, 4096)),
    ),
))

register(KernelSpec(
    name="fft2d_stage",
    arity=2,
    grid_loops=("i", "j", "k"),
    block_kwargs=_mm_blocks,
    # the fused kernel or the FFT kernel where the runtime routes the grid
    # to one, else the composition over the mm kernels with the plan's
    # tiled tile as the fallback of its products
    tiles=runtime.fft2d_tile,
    hopper=_fft2d.fft2d,
    ref=ref.fft2d,
    builder=ir.fft2d_stage,
    operand_shapes=lambda r: ((r.extent("i"), r.extent("j")),) * 2,
    systolic_lowering=chip.cannon_fft2d,
    allgather_lowering=chip.allgather_fft2d,
    fused_systolic_lowering=chip.fused_cannon_fft2d,
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
    operand_shapes=lambda r: (
        (r.extent("h") + r.extent("p") - 1, r.extent("w") + r.extent("q") - 1),
        (r.extent("p"), r.extent("q"))),
    systolic_lowering=chip.chain_conv2d,
    allgather_lowering=chip.allgather_conv2d,
    fused_systolic_lowering=chip.fused_halo_chain,
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
        plan, x.shape[0] - h.shape[0] + 1, x.element_size()),
    hopper=_fir.fir,
    ref=ref.fir,
    builder=ir.fir,
    operand_shapes=lambda r: ((r.extent("n") + r.extent("t") - 1,),
                              (r.extent("t"),)),
    systolic_lowering=chip.chain_fir,
    allgather_lowering=chip.allgather_fir,
    smoke_args=(1024, 15),
    bench_cases=(
        ("float32", (1048576, 15)),
        ("int8", (1048576, 15)),
        ("int16", (1048576, 15)),
        ("cfloat", (1048576, 15)),
    ),
))


def _jacobi_blocks(plan: "ExecutionPlan") -> dict:
    blk = plan.partition.block
    return {
        "bh": blk.get("i", MXU_LANES),
        "bw": blk.get("j", MXU_LANES),
    }


def _stencil_tiles(plan: "ExecutionPlan", grid, weights):
    return runtime.stencil_tile(plan)


def _star_shapes(offsets, pad: int, sweeps: bool):
    def shapes(r):
        grid = (r.extent("i") + 2 * pad, r.extent("j") + 2 * pad)
        w = (r.extent("t"), len(offsets)) if sweeps else (len(offsets),)
        return grid, w

    return shapes


register(KernelSpec(
    name="jacobi2d",
    arity=2,
    # the stencil kernel contracts all 5 star points in one visit: the
    # reduction loop s never reaches the grid
    grid_loops=("i", "j"),
    block_kwargs=_jacobi_blocks,
    tiles=_stencil_tiles,
    hopper=_jacobi2d.jacobi2d,
    ref=ref.jacobi2d,
    builder=ir.jacobi2d,
    operand_shapes=_star_shapes(ir.JACOBI2D_OFFSETS, 1, sweeps=False),
    systolic_lowering=chip.halo_stencil,
    allgather_lowering=chip.allgather_stencil,
    fused_systolic_lowering=chip.fused_halo_chain,
    fusable_with=("conv2d", "jacobi2d", "jacobi2d_9pt"),
    smoke_args=(126, 126),
    bench_cases=(
        ("float32", (10238, 10238)),
        ("int8", (10238, 10238)),
        ("int16", (10238, 10238)),
    ),
))

register(KernelSpec(
    name="jacobi2d_ms",
    arity=2,
    # the sweep loop t runs T_b sweeps a launch of the multi-sweep kernel,
    # the launches in order (its flow dependence forbids both space mapping
    # and grid parallelism); the per-sweep weights W[t, s] carry the sweep
    # count in-operand
    grid_loops=("i", "j"),
    block_kwargs=_jacobi_blocks,
    tiles=_stencil_tiles,
    hopper=_jacobi2d.jacobi2d_ms,
    ref=ref.jacobi2d_ms,
    builder=ir.jacobi2d_multisweep,
    operand_shapes=_star_shapes(ir.JACOBI2D_OFFSETS, 1, sweeps=True),
    systolic_lowering=chip.halo_stencil,
    allgather_lowering=chip.allgather_stencil,
    smoke_args=(62, 62, 3),
    bench_cases=(
        ("float32", (4094, 4094, 8)),
        ("int8", (4094, 4094, 8)),
        ("int16", (4094, 4094, 8)),
    ),
))

register(KernelSpec(
    name="jacobi2d_9pt",
    arity=2,
    # the radius-2 star: a compile-time case of the one-sweep star kernel
    grid_loops=("i", "j"),
    block_kwargs=_jacobi_blocks,
    tiles=_stencil_tiles,
    hopper=_jacobi2d.jacobi2d_9pt,
    ref=ref.jacobi2d_9pt,
    builder=ir.jacobi2d_9pt,
    operand_shapes=_star_shapes(ir.JACOBI2D_9PT_OFFSETS, 2, sweeps=False),
    systolic_lowering=chip.halo_stencil,
    allgather_lowering=chip.allgather_stencil,
    fused_systolic_lowering=chip.fused_halo_chain,
    fusable_with=("conv2d", "jacobi2d", "jacobi2d_9pt"),
    smoke_args=(64, 64),
    bench_cases=(
        ("float32", (10236, 10236)),
        ("int8", (10236, 10236)),
        ("int16", (10236, 10236)),
    ),
))


def _mttkrp_blocks(plan: "ExecutionPlan") -> dict:
    blk = plan.partition.block
    return {
        "bi": blk.get("i", MXU_LANES),
        "bj": blk.get("j", MXU_LANES),
        "bk": blk.get("k", 16),
        "bl": blk.get("l", 16),
    }


register(KernelSpec(
    name="mttkrp",
    arity=3,
    grid_loops=("i", "j", "k", "l"),
    block_kwargs=_mttkrp_blocks,
    tiles=lambda plan, x, b, c: runtime.mttkrp_tile(plan, x, b),
    hopper=_mttkrp.mttkrp,
    ref=ref.mttkrp,
    builder=ir.mttkrp,
    operand_shapes=lambda r: (
        (r.extent("i"), r.extent("k"), r.extent("l")),
        (r.extent("k"), r.extent("j")),
        (r.extent("l"), r.extent("j"))),
    systolic_lowering=chip.ring_mttkrp,
    allgather_lowering=chip.allgather_mttkrp,
    smoke_args=(128, 64, 16, 8),
    bench_cases=(
        ("float32", (4096, 400, 256, 256)),
        ("int8", (4096, 400, 256, 256)),
        ("int16", (4096, 400, 256, 256)),
    ),
))
