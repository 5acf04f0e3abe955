"""Sharding rules: logical axes -> mesh axes (the port of
``repro.parallel.sharding``).

Model code names the axes of its parameters, caches and batches
*logically* ("batch", "heads", "ff", "experts", "vocab", "d_model", ...);
the rules map those names to the axes of a mesh (``parallel/mesh.py``):

  * batch      -> ('pod', 'data'), or 'data' on one pod (data parallel)
  * heads / kv_heads / ff / experts / vocab / ssm_heads -> 'model'
  * d_model    -> 'data' with ``fsdp`` (the weights' FSDP shard)
  * seq        -> replicated; 'seq_sp' -> 'model' (sequence parallel)

``mesh_context(mesh)`` makes a ``MeshCtx`` current for a block (nested
contexts restore the outer one on exit, exceptions included; ``None``
clears it).  Under it the MoE blocks take their mesh paths
(``models/moe.py``), and the trainer resolves its spec trees against it.

The port holds whole tensors on one controller and splits them onto a
mesh's members only inside the mesh programs that need it (the MoE
paths, ``parallel/pipeline.py``, the chip-level schedules), so
``constrain`` returns its input unchanged, under a context as well as
without one.  ``logical_to_sharding`` and ``spec_tree_to_shardings``
give ``NamedSharding`` pairs (a mesh and a ``P``) in place of JAX's, and
the checkpoint's restore places each leaf on its sharding's mesh after
``guard_spec``.

Spec trees are nested dicts and lists whose leaves are tuples of logical
names (``P`` leaves once resolved), the structure of the port's
parameter trees (``tree.py``); a leaf that is neither a tuple nor a
container (``None``) passes through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable

from .mesh import Mesh, P


@dataclasses.dataclass
class MeshCtx:
    mesh: Mesh | None
    rules: dict[str, object]  # logical name -> mesh axis (str | tuple | None)
    fsdp: bool = True

    def spec(self, *logical: str | None) -> P:
        return P(*(None if name is None else self.rules.get(name)
                   for name in logical))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec over its axes (JAX's
    ``NamedSharding``)."""

    mesh: Mesh
    spec: P


_STATE = threading.local()


def default_rules(multi_pod: bool = False, fsdp: bool = True) -> dict:
    batch = ("pod", "data") if multi_pod else "data"
    return {
        "batch": batch,
        "seq": None,          # replicated by default; SP applies locally
        "seq_sp": "model",    # sequence-parallel sections
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "vocab": "model",
        "d_model": "data" if fsdp else None,  # FSDP shard of weight matrices
        "layers": None,
        "ssm_heads": "model",
        "state": None,
    }


def hierarchical_rules(outer_axes: tuple[str, str] = ("dp", "tp"),
                       fsdp: bool = False) -> dict:
    """Logical -> mesh-axis rules for the outer level of a two-level plan
    (``core.hierarchy.HierarchicalTarget``): the independent dims ride
    the data-parallel axis, the Megatron-split dims the tensor-parallel
    axis."""
    dp, tp = outer_axes
    return {
        "batch": dp,
        "seq": None,
        "seq_sp": tp,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "experts": tp,
        "vocab": tp,
        "d_model": dp if fsdp else None,
        "layers": None,
        "ssm_heads": tp,
        "state": None,
    }


def use_mesh_ctx(ctx: MeshCtx | None):
    _STATE.ctx = ctx


@contextlib.contextmanager
def mesh_context(mesh: Mesh | None, rules: dict | None = None, fsdp=True,
                 multi_pod: bool = False):
    prev = getattr(_STATE, "ctx", None)
    if mesh is None:
        _STATE.ctx = None
    else:
        _STATE.ctx = MeshCtx(
            mesh, rules or default_rules(multi_pod=multi_pod, fsdp=fsdp),
            fsdp)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def current_mesh() -> MeshCtx | None:
    return getattr(_STATE, "ctx", None)


def carry_context(fn):
    """``fn`` bound to the caller's mesh context: it runs under that
    context on whatever thread calls it.  The context is thread-local, and
    autograd's engine recomputes a checkpointed layer on its own thread
    for a CUDA backward, where a MoE block would otherwise take the
    single-device path and save other tensors than its forward did."""
    ctx = current_mesh()

    def run(*args, **kwargs):
        prev = current_mesh()
        use_mesh_ctx(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            use_mesh_ctx(prev)

    return run


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= mesh.shape[e]
        return n
    return mesh.shape[entry]


def guard_spec(mesh, spec: P, shape: tuple[int, ...]) -> P:
    """Drop mesh axes whose size does not divide the array dim (e.g. GQA
    kv_heads=8 on a model axis of 16 falls back to replication)."""
    parts = []
    for i, entry in enumerate(spec):
        if i >= len(shape):
            parts.append(None)
            continue
        if shape[i] % max(_axis_size(mesh, entry), 1) == 0:
            parts.append(entry)
        else:
            parts.append(None)
    return P(*parts)


def constrain(x, *logical: str | None):
    """The reference's sharding constraint: the port keeps whole tensors
    on one controller, so ``x`` itself (module docstring)."""
    del logical
    return x


def logical_to_sharding(logical: tuple[str | None, ...]):
    """Logical axes -> ``NamedSharding`` under the active context (or
    None)."""
    ctx = current_mesh()
    if ctx is None or ctx.mesh is None:
        return None
    return NamedSharding(ctx.mesh, ctx.spec(*logical))


def map_spec_tree(fn: Callable, tree) -> Any:
    """``fn`` over a spec tree's tuple leaves (``P`` included); dicts and
    lists are containers, any other leaf passes through."""
    if isinstance(tree, dict):
        return {k: map_spec_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_spec_tree(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return fn(tree)
    return tree


def spec_tree_to_shardings(mesh, spec_tree):
    """A tree of ``P`` -> a tree of ``NamedSharding``; leaves that are
    not a ``P`` are left alone."""
    return map_spec_tree(
        lambda s: NamedSharding(mesh, s) if isinstance(s, P) else s,
        spec_tree)


def logical_spec_tree(ctx: MeshCtx, logical_tree):
    """A tree of logical-axis tuples -> a tree of ``P``."""
    return map_spec_tree(lambda ax: ctx.spec(*ax), logical_tree)
