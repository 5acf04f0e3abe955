"""Checkpoints with an atomic commit and asynchronous writes (the port of
``repro.ckpt.checkpoint``, one device).

Layout:  <dir>/step_<N>/
            manifest.json       step, leaf paths, shapes, dtypes
            leaf_<i>.npy        one file per tree leaf (``tree.leaves``
                                order)

Leaves numpy has no dtype for (bfloat16, float8) are stored as their raw
bytes, [..., itemsize] uint8, as the reference stores them.  Leaves are
written into ``step_<N>.tmp`` and the directory is renamed last, so a
checkpoint exists completely or not at all; ``latest_step`` ignores
``.tmp`` directories.  ``restore_checkpoint`` rejects a leaf whose shape
or dtype differs from the caller's and places each leaf on the caller's
leaf's device, or with ``shardings`` (a tree of
``parallel.sharding.NamedSharding`` of the same structure) on its
sharding's mesh: the spec clamped to the leaf's shape by ``guard_spec``
(so a checkpoint written under one mesh restores onto a smaller one),
the whole tensor on the mesh's first device, where the single
controller holds it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import leaves, paths, tree_map, unflatten


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class _HostLeaf:
    """A leaf copied to the host: its dtype's name, its shape, and the
    array ``np.save`` writes."""

    dtype: str
    shape: list
    array: np.ndarray


def _to_host(t: torch.Tensor) -> _HostLeaf:
    """A host copy: native numpy dtypes as they are, others as raw bytes
    [..., itemsize] uint8."""
    t = t.detach().cpu().contiguous()
    try:
        arr = t.numpy().copy()
    except TypeError:
        arr = t.view(torch.uint8).reshape(
            *t.shape, t.element_size()).numpy().copy()
    return _HostLeaf(_dtype_name(t.dtype), list(t.shape), arr)


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` (tensors or host arrays from ``AsyncCheckpointer``)
    as ``step_<N>``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "paths": paths(tree), "leaves": []}
    for i, leaf in enumerate(leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = _to_host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf.array)
        meta["leaves"].append({"shape": leaf.shape, "dtype": leaf.dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _mesh_device(sharding, shape) -> torch.device:
    """The device a leaf of ``shape`` restores to under ``sharding``
    (module docstring); a spec naming an axis the mesh lacks raises."""
    from repro_torch.parallel.sharding import guard_spec

    mesh = sharding.mesh
    try:
        guard_spec(mesh, sharding.spec, shape)
    except KeyError as e:
        raise ValueError(f"spec {tuple(sharding.spec)} names an axis the "
                         f"mesh {mesh} lacks: {e}") from None
    return mesh.devices.flat[0]


def restore_checkpoint(directory: str, step: int, like_tree,
                       shardings=None):
    """Restore into the structure of ``like_tree``: every leaf's shape
    and dtype must match, and it lands on that leaf's device, or on its
    sharding's mesh (module docstring)."""
    path = os.path.join(directory, f"step_{step:08d}")
    like = leaves(like_tree)
    targets = (leaves(shardings) if shardings is not None
               else [None] * len(like))
    if len(targets) != len(like):
        raise ValueError(f"{len(targets)} shardings for {len(like)} leaves")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    if len(meta["leaves"]) != len(like):
        raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                         f"expected {len(like)}")
    out = []
    for i, (ref, info, sh) in enumerate(zip(like, meta["leaves"],
                                            targets)):
        shape, dtype = tuple(info["shape"]), info["dtype"]
        if shape != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {shape} != {tuple(ref.shape)}")
        if dtype != _dtype_name(ref.dtype):
            raise ValueError(f"leaf {i}: checkpoint dtype {dtype} != "
                             f"{_dtype_name(ref.dtype)}")
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        t = torch.from_numpy(arr)
        if t.dtype != ref.dtype:  # raw bytes of a non-numpy dtype
            t = t.view(ref.dtype).reshape(shape)
        out.append(t.to(ref.device if sh is None
                        else _mesh_device(sh, shape)))
    return unflatten(like_tree, out)


class AsyncCheckpointer:
    """Saves on a worker thread; ``wait()`` drains them.  Tensors are
    copied to the host on the caller's thread, before the next step
    replaces them, and written on the worker; only the newest ``keep``
    checkpoints stay."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []

    def save(self, step: int, tree):
        host_tree = tree_map(_to_host, tree)
        fut = self._pool.submit(self._do_save, step, host_tree)
        self._pending.append(fut)
        return fut

    def _do_save(self, step, host_tree):
        path = save_checkpoint(self.directory, step, host_tree)
        self._gc()
        return path

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        for f in self._pending:
            f.result()
        self._pending.clear()

    def close(self):
        self.wait()
        self._pool.shutdown()
