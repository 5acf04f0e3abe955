"""Fake ``cuda`` tensors for the dry run: shapes, dtypes and strides on a
``cuda`` device, and no memory behind them.

``fake_cuda()`` opens a ``FakeTensorMode``: every tensor made under it
is a ``FakeTensor`` whose ``device`` reads ``cuda:0`` whether or not a
card is present, so the code under it takes the card's path (the
planned facade, ``runtime``'s routes, the wrappers up to their launch
boundary, ``widesa_mm.launch``), while no kernel runs and nothing is
allocated.  Random draws take a CPU ``torch.Generator``
(``torch.Generator(device="cuda")`` needs a card).  A host sync
(``.item()``, ``bool()`` of a tensor, ``.tolist()``) raises
``DataDependentOutputException``: a fake tensor holds no values.

A build of PyTorch without CUDA registers no CUDA device guard, and the
Python bindings that open one (``Tensor.__getitem__``, ``__setitem__``,
``copy_``, ``contiguous``, ``__invert__`` and ``to`` with a device)
raise "PyTorch is not linked with support for cuda devices" on a fake
``cuda`` tensor, although the aten operators behind them run.  On such a
build ``fake_cuda()`` also opens ``_GuardFreeBindings``, a
``TorchFunctionMode`` that runs those bindings as the aten operators
they stand for (basic indexing as ``select``/``slice``/``unsqueeze``,
advanced indexing as ``aten.index`` and ``aten.index_put_``, as
PyTorch's own indexing does).  A build with CUDA needs none of it and
runs the bindings as they are.  Its autograd cannot run on fake ``cuda``
tensors at all (``launch/dryrun.py``: the train cells).
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

aten = torch.ops.aten


def _consumed(i) -> int:
    """The dimensions of the indexed tensor that index ``i`` takes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return i.dim()
    return 1


def _basic(x: torch.Tensor, idx) -> tuple[torch.Tensor, dict]:
    """``x`` under the basic part of ``idx`` (a view) and the advanced
    indices, by the view's dimension they index."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if sum(i is Ellipsis for i in idx) > 1:
        raise IndexError("an index can only have a single ellipsis")
    rest = x.dim() - sum(_consumed(i) for i in idx)
    if rest < 0:
        raise IndexError(f"too many indices for a {x.dim()}-D tensor")
    expanded = []
    for i in idx:
        expanded.extend([slice(None)] * rest if i is Ellipsis else [i])
    adv: dict[int, torch.Tensor] = {}
    dim = 0
    for i in expanded:
        if i is None:
            x = x.unsqueeze(dim)
            dim += 1
        elif isinstance(i, bool):
            raise IndexError("boolean scalar indices are data dependent")
        elif isinstance(i, (int, torch.SymInt)):
            x = x.select(dim, i)
        elif isinstance(i, slice):
            if i != slice(None):
                step = 1 if i.step is None else i.step
                x = aten.slice.Tensor(x, dim, i.start, i.stop, step)
            dim += 1
        else:
            t = i if isinstance(i, torch.Tensor) else torch.as_tensor(
                i, device=x.device)
            if t.dtype == torch.bool:
                raise IndexError("boolean mask indices are data dependent")
            adv[dim] = t
            dim += 1
    return x, adv


def _adv_list(adv: dict) -> list:
    return [adv.get(d) for d in range(max(adv) + 1)]


def _getitem(x: torch.Tensor, idx) -> torch.Tensor:
    view, adv = _basic(x, idx)
    return aten.index.Tensor(view, _adv_list(adv)) if adv else view


def _setitem(x: torch.Tensor, idx, value) -> None:
    view, adv = _basic(x, idx)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=view.dtype, device=view.device)
    elif value.dtype != view.dtype:
        value = value.to(view.dtype)
    if adv:
        aten.index_put_.default(view, _adv_list(adv), value)
    else:
        aten.copy_.default(view, value)


def _to(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    device, dtype, _, _ = torch._C._nn._parse_to(*args, **kwargs)
    device = x.device if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    dtype = x.dtype if dtype is None else dtype
    if device == x.device and dtype == x.dtype and not kwargs.get("copy"):
        return x
    return aten._to_copy.default(x, dtype=dtype, device=device)


def _contiguous(x: torch.Tensor,
                memory_format=torch.contiguous_format) -> torch.Tensor:
    if x.is_contiguous(memory_format=memory_format):
        return x
    return aten.clone.default(x, memory_format=memory_format)


class _GuardFreeBindings(TorchFunctionMode):
    """The bindings that open a CUDA device guard, as aten operators
    (module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        if func is torch.Tensor.__setitem__:
            return _setitem(*args)
        if func is torch.Tensor.copy_:
            return aten.copy_.default(*args, **kwargs)
        if func is torch.Tensor.to:
            return _to(*args, **kwargs)
        if func is torch.Tensor.contiguous:
            return _contiguous(*args, **kwargs)
        if func is torch.Tensor.__invert__:
            return aten.bitwise_not.default(*args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_cuda():
    """A ``FakeTensorMode`` whose tensors may lie on ``cuda`` without a
    card (module docstring); yields the mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mode)
        if torch.version.cuda is None:
            stack.enter_context(_GuardFreeBindings())
        yield mode
