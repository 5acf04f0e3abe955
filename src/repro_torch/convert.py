"""Parameters for the port: from the reference's tree, or drawn fresh.

``params_from_jax(np_tree, cfg, device)`` takes the reference model's
parameter tree with every leaf already converted to a numpy array (the
dense layers stacked along a leading L axis under ``dense_layers``) and
returns the port's dict, one entry of ``layers`` per layer.  bfloat16
leaves (numpy's ``bfloat16`` extension dtype) keep their bits.

``init_params(cfg, generator, device)`` draws full-width weights on the
device from a seeded ``torch.Generator`` (``models/transformer.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.transformer import init_params

__all__ = ["init_params", "params_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device)


def params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port runs dense "
            "decoders")
    stacked = np_tree["dense_layers"]
    p = {
        "embed": _tensor(np_tree["embed"], device),
        "ln_f": _tree(np_tree["ln_f"], device),
        "layers": [_tree(stacked, device, i) for i in range(cfg.n_layers)],
    }
    if "lm_head" in np_tree:
        p["lm_head"] = _tensor(np_tree["lm_head"], device)
    return p
