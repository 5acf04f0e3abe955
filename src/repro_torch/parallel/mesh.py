"""Single-controller device meshes for the chip-level schedules.

The port's counterpart of ``repro.compat.make_mesh`` / ``shard_map`` /
``PartitionSpec`` and of ``jax.lax.ppermute`` / ``all_gather`` /
``axis_index``.  One Python process drives every member of a mesh, as
JAX's single controller does:

  * ``Mesh`` — an ndarray of ``torch.device`` with axis names;
    ``mesh.shape[name]`` is an axis's width, as in JAX.
  * ``P`` — a partition spec: one entry per operand dimension, ``None``
    (whole), an axis name, or a tuple of axis names (the dimension split
    over their linearised, row-major product).
  * ``shard(mesh, x, spec)`` splits a global tensor into one block per
    member, each a contiguous copy on that member's device;
    ``unshard(mesh, blocks, spec, device)`` joins the blocks back on the
    caller's device (a replicated axis contributes its first member's
    block, as ``shard_map``'s unchecked out_specs do).  Blocks are
    ``numpy`` object arrays of the mesh's shape.
  * ``ppermute(mesh, blocks, axes, perm)`` has JAX's semantics: ``perm``
    lists (source, destination) pairs over the linearised ``axes``, the
    other axes' coordinates stay fixed, and a member that receives
    nothing gets zeros.  Every block received is a copy onto the
    destination member's device (peer to peer across cards, device to
    device on one card), never an alias of the sender's.
  * ``all_gather(mesh, blocks, axis, dim, tiled=True)`` gives every
    member the blocks of its ``axis`` group joined along ``dim``
    (stacked on a new ``dim`` with ``tiled=False``).
  * ``psum`` / ``pmax`` / ``pmean(mesh, blocks, axes)`` give every member
    its ``axes`` group's sum (added in axis order), elementwise maximum or
    mean; ``all_to_all(mesh, blocks, axis, split_axis, concat_axis,
    tiled=True)`` splits each member's block into one chunk per member of
    its ``axis`` group along ``split_axis`` and gives member j every
    member's j-th chunk, joined along ``concat_axis`` in axis order
    (``tiled=False``: the split dimension, of the group's width, is
    removed and the chunks stacked on a new ``concat_axis``), as
    ``jax.lax`` has them.
  * ``map_members(mesh, fn, *blocks)`` runs ``fn(member, *its blocks)``
    member after member; ``axis_index(mesh, member, axis)`` is
    ``jax.lax.axis_index``.

The schedules (``kernels/systolic.py``) run in lockstep: the step loop
is outside, each member's compute inside it, issued member after member.
A ``shard_map`` body cannot be run one member at a time once it calls a
collective midway, so every collective here takes all members' blocks
at once.

``moved`` counts the bytes the collectives carried between two members
(a member's copy to itself moves nothing), by collective (``pmean`` under
``psum``), and ``calls`` the collectives called, one a call whatever the
mesh's size; ``moved_clear`` zeroes both.  The chip smoke holds the bytes
to ``parallel/collectives.py``'s byte models, and the dry run reads both
(``core.roofline.collective_bytes``).

Everything here is plain tensor operations (slices, copies, adds,
concatenations), so autograd runs through a mesh program: ``shard``'s
blocks pass their gradients back into the global tensor (a replicated
axis's copies summed), and a collective's into the blocks it read.
``unshard`` returns a replicated axis's first member's block, and its
gradient goes to every member of that axis in equal shares, as the
transpose of ``shard_map`` with unchecked ``out_specs`` divides an
unmentioned axis's cotangent: a value the members disagree on (a MoE
block's per-shard load-balance term) then gets the gradient of their
mean.

The logical device count is the counterpart of XLA's forced host device
count: the number of devices ``devices()`` and ``local_device_count()``
report.  By default it is the number of physical devices of the
caller's type, ``torch.cuda.device_count()`` on the card and 1 on the
CPU; ``logical_devices(n)`` sets it, and only tests, the chip smoke and
the dry run do.  Logical device ``i`` is physical card ``i % cards``: on
one card all of them are ``cuda:0``, and a 2 x 2 mesh's members all
compute on it, one after another.  A mesh of other devices (the dry
run's fake ``cuda`` ones, with or without a card) is built from an
explicit list (``make_mesh``'s ``devices_list``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import numpy as np
import torch

#: the logical device count set by ``logical_devices`` (None: physical)
_LOGICAL: int | None = None

#: bytes carried between two members, by collective (module docstring)
moved = {"ppermute": 0, "all_gather": 0, "psum": 0, "pmax": 0,
         "all_to_all": 0}
#: collectives called, by collective (module docstring)
calls = dict.fromkeys(moved, 0)


def moved_clear() -> None:
    for key in moved:
        moved[key] = 0
        calls[key] = 0


def default_kind() -> str:
    """The caller's device type: the card where there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def physical_count(kind: str | None = None) -> int:
    """Physical devices of ``kind``: the cards, or 1 for the CPU."""
    kind = kind or default_kind()
    return torch.cuda.device_count() if kind == "cuda" else 1


def local_device_count(kind: str | None = None) -> int:
    """The logical device count (module docstring)."""
    return _LOGICAL if _LOGICAL is not None else physical_count(kind)


def devices(kind: str | None = None) -> list[torch.device]:
    """The logical devices of ``kind``: logical device ``i`` on physical
    device ``i % physical_count(kind)``."""
    kind = kind or default_kind()
    n, phys = local_device_count(kind), physical_count(kind)
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if phys < 1:
        raise RuntimeError("no CUDA device for a mesh of cards")
    return [torch.device(kind, i % phys) for i in range(n)]


@contextlib.contextmanager
def logical_devices(n: int):
    """The logical device count set to ``n`` for the duration of a
    block (module docstring)."""
    global _LOGICAL
    if n < 1:
        raise ValueError(f"logical device count must be >= 1, got {n}")
    old, _LOGICAL = _LOGICAL, n
    try:
        yield
    finally:
        _LOGICAL = old


class Mesh:
    """An ndarray of ``torch.device`` with axis names."""

    def __init__(self, devices_arr: np.ndarray, axis_names: Sequence[str]):
        arr = np.asarray(devices_arr, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device array for axes "
                             f"{tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def members(self):
        """Every member's coordinates, in row-major order."""
        return np.ndindex(self.devices.shape)

    def device(self, member) -> torch.device:
        return self.devices[member]

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={w}" for n, w in self.shape.items())
        return f"Mesh({axes}; {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices_list: Sequence[torch.device] | None = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of
    ``devices_list`` (default ``devices()``), row-major."""
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axes {names} differ in "
                         "length")
    devs = list(devices() if devices_list is None else devices_list)
    need = math.prod(shape)
    if len(devs) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"devices, {len(devs)} available")
    arr = np.empty(need, dtype=object)
    for i, dev in enumerate(devs[:need]):
        arr[i] = torch.device(dev)
    return Mesh(arr.reshape(shape), names)


class P(tuple):
    """A partition spec (module docstring)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_index(mesh: Mesh, member, axis) -> int:
    """The member's index along ``axis`` (a name, or a tuple of names
    linearised row-major)."""
    idx = 0
    for name in _axes(axis):
        pos = mesh.axis_names.index(name)
        idx = idx * mesh.devices.shape[pos] + member[pos]
    return idx


def _width(mesh: Mesh, axis) -> int:
    return math.prod(mesh.shape[name] for name in _axes(axis))


def _with_index(mesh: Mesh, member, axis, idx: int) -> tuple:
    """``member`` with its coordinates along ``axis`` set to the
    linearised index ``idx``."""
    out = list(member)
    for name in reversed(_axes(axis)):
        pos = mesh.axis_names.index(name)
        idx, out[pos] = divmod(idx, mesh.devices.shape[pos])
    return tuple(out)


def blocks_like(mesh: Mesh) -> np.ndarray:
    return np.empty(mesh.devices.shape, dtype=object)


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``."""
    if t.device == device:
        return t.clone(memory_format=torch.contiguous_format)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _slices(mesh: Mesh, member, spec, shape) -> tuple:
    """The member's block of a tensor of ``shape`` under ``spec``."""
    out = []
    for dim, extent in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        width = _width(mesh, entry)
        if extent % width:
            raise ValueError(f"dimension {dim} of extent {extent} does not "
                             f"divide over the {width}-wide mesh axes "
                             f"{_axes(entry)}")
        size = extent // width
        i = axis_index(mesh, member, entry)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard(mesh: Mesh, x: torch.Tensor, spec) -> np.ndarray:
    """One block of ``x`` per member under ``spec``, each a contiguous
    copy on the member's device."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {tuple(spec)} for a {x.dim()}-D operand")
    out = blocks_like(mesh)
    for member in mesh.members():
        out[member] = _copy_to(x[_slices(mesh, member, spec, x.shape)],
                               mesh.device(member))
    return out


def _replicas(mesh: Mesh, member, named: set) -> list:
    """The members that differ from ``member`` on unnamed axes only."""
    free = [pos for pos, name in enumerate(mesh.axis_names)
            if name not in named]
    out = []
    for idx in np.ndindex(*(mesh.devices.shape[pos] for pos in free)):
        other = list(member)
        for pos, i in zip(free, idx):
            other[pos] = i
        out.append(tuple(other))
    return out


def _first_of(blocks: list, device: torch.device) -> torch.Tensor:
    """The first of replicated ``blocks``: its value, and with autograd
    recording, the gradient split evenly over all of them (module
    docstring)."""
    first = blocks[0]
    if len(blocks) == 1 or not torch.is_grad_enabled() or not any(
            b.requires_grad for b in blocks):
        return first
    mean = sum(_copy_to(b, device) for b in blocks) / len(blocks)
    return _copy_to(first.detach(), device) + (mean - mean.detach())


def unshard(mesh: Mesh, blocks: np.ndarray, spec,
            device: torch.device) -> torch.Tensor:
    """The global tensor of ``blocks`` under ``spec`` on ``device``."""
    named = {name for entry in spec for name in _axes(entry)}
    first = blocks.flat[0]
    shape = [first.shape[d] * (_width(mesh, spec[d]) if d < len(spec)
                               and spec[d] is not None else 1)
             for d in range(first.dim())]
    out = torch.empty(shape, dtype=first.dtype, device=device)
    for member in mesh.members():
        if any(member[pos] for pos, name in enumerate(mesh.axis_names)
               if name not in named):
            continue  # a replicated axis: its first member's block
        block = _first_of([blocks[m] for m in _replicas(mesh, member, named)],
                          device)
        out[_slices(mesh, member, spec, shape)].copy_(block)
    return out


def map_members(mesh: Mesh, fn: Callable, *blocks: np.ndarray):
    """``fn(member, *that member's blocks)`` member after member: one
    object array of results, or a tuple of them where ``fn`` returns a
    tuple."""
    results = {member: fn(member, *(b[member] for b in blocks))
               for member in mesh.members()}
    sample = next(iter(results.values()))
    if isinstance(sample, tuple):
        outs = tuple(blocks_like(mesh) for _ in sample)
        for member, res in results.items():
            for arr, value in zip(outs, res):
                arr[member] = value
        return outs
    out = blocks_like(mesh)
    for member, res in results.items():
        out[member] = res
    return out


def ppermute(mesh: Mesh, blocks: np.ndarray, axes, perm) -> np.ndarray:
    """``jax.lax.ppermute`` over ``axes`` (module docstring)."""
    width = _width(mesh, axes)
    src_of: dict[int, int] = {}
    for src, dst in perm:
        if not (0 <= src < width and 0 <= dst < width):
            raise ValueError(f"ppermute pair {(src, dst)} outside the "
                             f"{width} members of {_axes(axes)}")
        if dst in src_of:
            raise ValueError(f"ppermute: member {dst} receives twice")
        src_of[dst] = src
    if len(set(src_of.values())) != len(src_of):
        raise ValueError("ppermute: a member sends twice")
    calls["ppermute"] += 1
    out = blocks_like(mesh)
    for member in mesh.members():
        dev = mesh.device(member)
        src = src_of.get(axis_index(mesh, member, axes))
        if src is None:
            out[member] = torch.zeros_like(blocks[member], device=dev)
            continue
        sender = _with_index(mesh, member, axes, src)
        out[member] = _copy_to(blocks[sender], dev)
        if sender != member:
            moved["ppermute"] += out[member].numel() \
                * out[member].element_size()
    return out


def all_gather(mesh: Mesh, blocks: np.ndarray, axis: str, dim: int,
               tiled: bool = True) -> np.ndarray:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=tiled)``: every
    member receives its ``axis`` group's blocks in axis order."""
    width = mesh.shape[axis]
    calls["all_gather"] += 1
    out = blocks_like(mesh)
    for member in mesh.members():
        dev = mesh.device(member)
        parts = []
        for i in range(width):
            sender = _with_index(mesh, member, axis, i)
            part = blocks[sender]
            if sender != member:
                part = _copy_to(part, dev)
                moved["all_gather"] += part.numel() * part.element_size()
            parts.append(part)
        out[member] = (torch.cat(parts, dim=dim) if tiled
                       else torch.stack(parts, dim=dim))
    return out


def _group(mesh: Mesh, blocks: np.ndarray, member, axes, key: str) -> list:
    """``member``'s ``axes`` group's blocks in axis order, each on the
    member's device (those of other members copied, counted under
    ``key``)."""
    dev = mesh.device(member)
    parts = []
    for i in range(_width(mesh, axes)):
        sender = _with_index(mesh, member, axes, i)
        part = blocks[sender]
        if sender != member:
            part = _copy_to(part, dev)
            moved[key] += part.numel() * part.element_size()
        parts.append(part)
    return parts


def _reduce(mesh: Mesh, blocks: np.ndarray, axes, key: str,
            combine: Callable) -> np.ndarray:
    calls[key] += 1
    out = blocks_like(mesh)
    for member in mesh.members():
        parts = _group(mesh, blocks, member, axes, key)
        acc = parts[0]
        for part in parts[1:]:
            acc = combine(acc, part)
        out[member] = acc
    return out


def psum(mesh: Mesh, blocks: np.ndarray, axes) -> np.ndarray:
    """``jax.lax.psum`` over ``axes``: the group's blocks added in axis
    order."""
    return _reduce(mesh, blocks, axes, "psum", torch.add)


def pmax(mesh: Mesh, blocks: np.ndarray, axes) -> np.ndarray:
    """``jax.lax.pmax`` over ``axes``."""
    return _reduce(mesh, blocks, axes, "pmax", torch.maximum)


def pmean(mesh: Mesh, blocks: np.ndarray, axes) -> np.ndarray:
    """``jax.lax.pmean`` over ``axes``: ``psum`` over the group's width."""
    width = _width(mesh, axes)
    out = psum(mesh, blocks, axes)
    for member in mesh.members():
        out[member] = out[member] / width
    return out


def all_to_all(mesh: Mesh, blocks: np.ndarray, axis, split_axis: int,
               concat_axis: int, tiled: bool = True) -> np.ndarray:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled)``
    (module docstring)."""
    width = _width(mesh, axis)
    for member in mesh.members():
        extent = blocks[member].shape[split_axis]
        if (extent % width) if tiled else (extent != width):
            raise ValueError(f"all_to_all: split dimension {split_axis} of "
                             f"extent {extent} over {width} members of "
                             f"{_axes(axis)}")
    calls["all_to_all"] += 1
    out = blocks_like(mesh)
    for member in mesh.members():
        dev = mesh.device(member)
        j = axis_index(mesh, member, axis)
        parts = []
        for i in range(width):
            sender = _with_index(mesh, member, axis, i)
            size = blocks[sender].shape[split_axis] // width
            chunk = blocks[sender].narrow(split_axis, j * size, size)
            if sender != member:
                chunk = _copy_to(chunk, dev)
                moved["all_to_all"] += chunk.numel() * chunk.element_size()
            parts.append(chunk if tiled else chunk.squeeze(split_axis))
        out[member] = (torch.cat(parts, dim=concat_axis) if tiled
                       else torch.stack(parts, dim=concat_axis))
    return out
