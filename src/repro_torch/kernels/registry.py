"""KernelSpec registry of the port: what executes a plan per recurrence.

The port's counterpart of ``repro.kernels.registry`` for the two specs on
the serving path, ``mm`` and ``bmm``.  Each spec declares its operand
arity, the grid loops of the reference kernel, how a plan's partition
becomes tile kwargs, and two lowerings: ``hopper`` (the hand-written CUDA
kernel) and ``ref`` (the plain PyTorch version).  ``parity_dtypes`` and
``atol`` are the reference's, so one table drives both packages' tests.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.core import recurrence as ir
from repro_torch.core.partition import MXU_LANES

from . import bmm as _bmm
from . import ref
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
    hopper: Callable[..., Any]
    ref: Callable[..., Any]
    builder: Callable[..., "UniformRecurrence"]
    parity_dtypes: tuple[str, ...] = ("float32", "int8", "int16")
    atol: float = 1e-3


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


register(KernelSpec(
    name="mm",
    arity=2,
    grid_loops=("i", "j", "k"),
    block_kwargs=_mm_blocks,
    hopper=_mm.matmul,
    ref=ref.mm,
    builder=ir.matmul,
))

register(KernelSpec(
    name="bmm",
    arity=2,
    grid_loops=("b", "i", "j", "k"),
    block_kwargs=_mm_blocks,
    hopper=_bmm.bmm,
    ref=ref.bmm,
    builder=ir.batched_matmul,
))
