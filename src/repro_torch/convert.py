"""Parameters for the port: from the reference's tree, or drawn fresh.

``params_from_jax(np_tree, cfg, device)`` takes the reference model's
parameter tree with every leaf already converted to a numpy array (the
layers stacked along a leading L axis: ``dense_layers`` and, for the MoE
family, ``moe_layers``; ``enc_layers``/``dec_layers`` for encdec;
``trunk`` for SSM and hybrid) and returns the port's dict, one entry per
layer in ``layers`` (dense and MoE: the dense layers first, as the
reference runs them, each layer's ``attn`` GQA's or MLA's leaves as the
reference has them; a vlm's ``patch_proj`` beside them), in
``enc_layers``/``dec_layers`` (encdec) or in ``trunk`` (SSM and hybrid,
beside the hybrid's one ``shared`` block).
bfloat16 leaves (numpy's ``bfloat16`` extension dtype) keep their bits.

``init_params(cfg, generator, device)`` draws full-width weights on the
device from a seeded ``torch.Generator`` (``models/transformer.py`` for
dense, vlm and MoE, ``models/encdec.py`` for encdec, ``models/hybrid.py`` for
SSM and hybrid).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import encdec, hybrid, transformer

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


def init_params(cfg, generator, device="cuda") -> dict:
    """Seeded full-width random weights for ``cfg``'s family."""
    if cfg.family == "encdec":
        return encdec.init_params(cfg, generator, device)
    if cfg.family in ("ssm", "hybrid"):
        return hybrid.init_params(cfg, generator, device)
    return transformer.init_params(cfg, generator, device)


def params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    if cfg.family == "encdec":
        return {
            "enc_layers": [_tree(np_tree["enc_layers"], device, i)
                           for i in range(cfg.n_enc_layers)],
            "dec_layers": [_tree(np_tree["dec_layers"], device, i)
                           for i in range(cfg.n_layers)],
            **{k: _tree(np_tree[k], device)
               for k in ("embed", "pos_dec", "ln_enc", "ln_f")},
        }
    if cfg.family in ("ssm", "hybrid"):
        return {"trunk": [_tree(np_tree["trunk"], device, i)
                          for i in range(cfg.n_layers)],
                **{k: _tree(np_tree[k], device)
                   for k in ("embed", "ln_f", "lm_head", "shared")
                   if k in np_tree}}
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port runs dense, vlm "
            "and MoE decoders, SSM and hybrid models, and encdec")
    layers = []
    for group, n in zip(("dense_layers", "moe_layers"),
                        transformer.layer_split(cfg)):
        layers += [_tree(np_tree[group], device, i) for i in range(n)]
    p = {
        "embed": _tensor(np_tree["embed"], device),
        "ln_f": _tree(np_tree["ln_f"], device),
        "layers": layers,
    }
    for key in ("lm_head", "patch_proj"):
        if key in np_tree:
            p[key] = _tensor(np_tree[key], device)
    return p
