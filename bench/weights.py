"""Random weights from the seed, on the card, in the port's parameter
layout and the dtype they are served in.

Every leaf is a view into one flat buffer per dtype, drawn by one
``normal_`` a leaf from a generator seeded by (seed, leaf index), with
the port's scales: N(0, 1/d_in) for dense kernels and experts, N(0, 0.02)
for the embedding and the router, ones for norm gains.  Because each
leaf has its own generator, ``leaf(...)`` draws any one leaf again, bit
for bit, without the others: the training check reads the starting
weights that way after the program has replaced them.
"""

from __future__ import annotations

import math

def layout(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(path, shape, kind) of every leaf of the port's dense/MoE decoder
    (``models/transformer.py``'s tree), in a fixed order; a kind is
    ("normal", scale, dtype) or ("ones", dtype)."""
    d, h, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    dt = cfg.get("dtype", "bfloat16")
    out = [("embed", (cfg["vocab"], d), ("normal", 0.02, dt)),
           ("ln_f/w", (d,), ("ones", dt))]
    for i in range(cfg["n_layers"]):
        p = f"layers/{i}"
        out += [(f"{p}/ln1/w", (d,), ("ones", dt)),
                (f"{p}/ln2/w", (d,), ("ones", dt))]
        for name, d_in, d_out in (("wq", d, h * hd), ("wk", d, hkv * hd),
                                  ("wv", d, hkv * hd), ("wo", h * hd, d)):
            out.append((f"{p}/attn/{name}", (d_in, d_out),
                        ("normal", 1 / math.sqrt(d_in), dt)))
        if cfg.get("qk_norm"):
            out += [(f"{p}/attn/q_norm", (hd,), ("ones", dt)),
                    (f"{p}/attn/k_norm", (hd,), ("ones", dt))]
        if cfg.get("moe_num_experts"):
            e, ff = cfg["moe_num_experts"], cfg["moe_d_ff"]
            out += [(f"{p}/moe/router", (d, e), ("normal", 0.02, "float32")),
                    (f"{p}/moe/wg", (e, d, ff), ("normal", 1 / math.sqrt(d), dt)),
                    (f"{p}/moe/wu", (e, d, ff), ("normal", 1 / math.sqrt(d), dt)),
                    (f"{p}/moe/wd", (e, ff, d), ("normal", 1 / math.sqrt(ff), dt))]
        else:
            ff = cfg["d_ff"]
            out += [(f"{p}/mlp/wg", (d, ff), ("normal", 1 / math.sqrt(d), dt)),
                    (f"{p}/mlp/wu", (d, ff), ("normal", 1 / math.sqrt(d), dt)),
                    (f"{p}/mlp/wd", (ff, d), ("normal", 1 / math.sqrt(ff), dt))]
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head", (d, cfg["vocab"]),
                    ("normal", 1 / math.sqrt(d), dt)))
    return out


def _dtype(torch, name):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _generator(torch, seed: int, index: int, device):
    g = torch.Generator(device=device)
    # one stream per leaf: the seed and the leaf's index, mixed
    g.manual_seed((seed * 1_000_003 + index * 7_919) % (2**63 - 1))
    return g


def _fill(torch, view, kind, seed, index, device):
    if kind[0] == "ones":
        view.fill_(1.0)
    else:
        view.normal_(0.0, kind[1], generator=_generator(torch, seed, index,
                                                          device))


def make(torch, cfg: dict, seed: int, device) -> dict:
    """The parameter tree: one flat buffer per dtype, a view per leaf."""
    lay = layout(cfg)
    sizes: dict[str, int] = {}
    for _, shape, kind in lay:
        sizes[kind[-1]] = sizes.get(kind[-1], 0) + math.prod(shape)
    flat = {dt: torch.empty(n, dtype=_dtype(torch, dt), device=device)
            for dt, n in sizes.items()}
    offset = dict.fromkeys(sizes, 0)
    tree: dict = {}
    for index, (path, shape, kind) in enumerate(lay):
        dt = kind[-1]
        n = math.prod(shape)
        view = flat[dt][offset[dt]:offset[dt] + n].view(shape)
        offset[dt] += n
        _fill(torch, view, kind, seed, index, device)
        _put(tree, path, view)
    return tree


def leaf(torch, cfg: dict, seed: int, path: str, device):
    """One leaf of ``make``'s tree, drawn again."""
    for index, (p, shape, kind) in enumerate(layout(cfg)):
        if p == path:
            t = torch.empty(shape, dtype=_dtype(torch, kind[-1]),
                            device=device)
            _fill(torch, t, kind, seed, index, device)
            return t
    raise KeyError(path)


def _put(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        if k == "layers":
            node = node.setdefault("layers", [])
            continue
        if isinstance(node, list):
            idx = int(k)
            while len(node) <= idx:
                node.append({})
            node = node[idx]
            continue
        node = node.setdefault(k, {})
    node[keys[-1]] = value
