"""The benchmark's yardstick: the H100's published peaks, the operations
and bytes of a GEMM from its shape (an expert's from the rows routed to
it, not the capacity it is padded to), the GEMMs of one captured decode
step from a configuration's widths, and a model's FLOPs per token.

Nothing here reads the program: the peaks are NVIDIA's data sheet
(H100 SXM, dense, 700 W), and every count is worked out from shapes, so
no change to the program can move the yardstick.
"""

from __future__ import annotations

import math
import re

#: dense bf16/fp16 tensor-core peak (FLOP/s): the fastest floating-point
#: rate the card has, used as the bound of every GEMM in every dtype, so a
#: float32 or 3xTF32 GEMM can never read above 100 %
PEAK_FLOPS = 989e12
#: HBM3 bandwidth (bytes/s)
PEAK_BYTES = 3.35e12


def gemm_flops(shape) -> int:
    """2 * z * m * n * k of an ``mm`` shape (m, n, k) or a ``bmm`` shape
    (z, m, n, k): the facade's own shape records."""
    z, m, n, k = (1, *shape) if len(shape) == 3 else shape
    return 2 * z * m * n * k


def gemm_bytes(shape, in_bytes: int, out_bytes: int) -> int:
    """Each operand read once and the output written once."""
    z, m, n, k = (1, *shape) if len(shape) == 3 else shape
    return z * ((m * k + k * n) * in_bytes + m * n * out_bytes)


def site_bytes(site: str) -> tuple[int, int]:
    """(operand, output) element sizes of a planned site: the MoE router
    runs in float32 forward and backward, the forward attention scores
    flush float32 from bf16 operands, everything else is bf16 (a bmm's
    backward casts its cotangent to the operands' dtype)."""
    if site.startswith("moe.router"):
        return 4, 4
    if "scores" in site and "/bwd" not in site:
        return 2, 4
    return 2, 2


def gemm_bound_s(site: str, shape) -> float:
    """The least time the card could take for one GEMM: the larger of its
    FLOPs at ``PEAK_FLOPS`` and its bytes at ``PEAK_BYTES``."""
    a, c = site_bytes(site)
    return max(gemm_flops(shape) / PEAK_FLOPS,
               gemm_bytes(shape, a, c) / PEAK_BYTES)


#: the expert stack's projections and their backward products: one bmm
#: over [experts, capacity] rows whose rows past the tokens routed to an
#: expert are padding
EXPERT_SITE = re.compile(r"^moe\.(gate|up|down)(/bwd_(da|db))?$")


def experts_touched(cfg, tokens: int) -> float:
    """Experts that ``tokens`` tokens reach, expected when each picks its
    top-k distinct experts uniformly: E * (1 - (1 - k / E) ** tokens)."""
    e, k = cfg["moe_num_experts"], cfg["moe_top_k"]
    return e * (1 - (1 - k / e) ** tokens)


def tokens_of_capacity(cfg, cap: int) -> int:
    """The fewest tokens whose batch gives an expert ``cap`` rows (the
    inverse of ``capacity``: the tokens themselves where capacity factor
    times top-k equals the experts, as dropless serving sets it)."""
    per = cfg["moe_top_k"] * cfg["moe_capacity_factor"] / cfg["moe_num_experts"]
    return max(1, math.floor((cap - 1) / per + 1e-9) + 1)


def expert_bound_s(site: str, shape, cfg, tokens: int) -> float:
    """The least time of one expert-stack product from what its inputs
    need, whatever the capacity it was padded to: the ``tokens`` x top-k
    routed rows' FLOPs, each touched expert's weight (or, for ``/bwd_db``,
    weight gradient) once, and the routed rows of the activations in and
    out.  ``shape`` is the facade's record: (E, capacity, n, k) for the
    forward and ``/bwd_da``, (E, m, n, capacity) for ``/bwd_db``."""
    a, c = site_bytes(site)
    rows = tokens * cfg["moe_top_k"]
    touched = experts_touched(cfg, tokens)
    if site.endswith("/bwd_db"):
        _, m, n, _ = shape
        flops = 2 * rows * m * n
        nbytes = rows * (m + n) * a + touched * m * n * c
    else:
        _, _, n, k = shape
        flops = 2 * rows * n * k
        nbytes = (rows * k + touched * k * n) * a + rows * n * c
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def bound_s(site: str, shape, cfg=None, tokens: int | None = None) -> float:
    """``gemm_bound_s``, except for an expert-stack product
    (``EXPERT_SITE``), whose work counts the rows routed: ``tokens``
    tokens, else those that give its recorded capacity."""
    if cfg is None or not cfg.get("moe_num_experts") or not EXPERT_SITE.match(site):
        return gemm_bound_s(site, shape)
    if tokens is None:
        cap = shape[3] if site.endswith("/bwd_db") else shape[1]
        tokens = tokens_of_capacity(cfg, cap)
    return expert_bound_s(site, shape, cfg, tokens)


def decode_gemms(cfg, lanes: int, max_seq: int) -> list[tuple[str, tuple]]:
    """The (site, shape) of every GEMM in one paged decode step over
    ``lanes`` lanes whose gathered K/V hold ``max_seq`` rows: the
    projections, the GQA scores and readout over all rows, the MLP pair
    or the router and expert stack (capacity from the configuration's
    capacity factor, as launched; ``bound_s`` counts its routed rows),
    then the head."""
    d, h, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    group = h // hkv
    layer = [("attn.q", (lanes, h * hd, d)), ("attn.k", (lanes, hkv * hd, d)),
             ("attn.v", (lanes, hkv * hd, d)),
             ("attn.paged_scores", (lanes * hkv, group, max_seq, hd)),
             ("attn.paged_values", (lanes * hkv, group, hd, max_seq)),
             ("attn.out", (lanes, d, h * hd))]
    if cfg.get("moe_num_experts"):
        e, ff = cfg["moe_num_experts"], cfg["moe_d_ff"]
        cap = capacity(cfg, lanes)
        layer += [("moe.router", (lanes, e, d)), ("moe.gate", (e, cap, ff, d)),
                  ("moe.up", (e, cap, ff, d)), ("moe.down", (e, cap, d, ff))]
    else:
        ff = cfg["d_ff"]
        layer += [("mlp.gate", (lanes, ff, d)), ("mlp.up", (lanes, ff, d)),
                  ("mlp.down", (lanes, d, ff))]
    return layer * cfg["n_layers"] + [("lm_head", (lanes, cfg["vocab"], d))]


def capacity(cfg, tokens: int) -> int:
    """Rows an expert holds for a batch of ``tokens`` tokens: max(1,
    ceil(tokens * top_k * capacity_factor / experts))."""
    return max(1, math.ceil(tokens * cfg["moe_top_k"]
                            * cfg["moe_capacity_factor"]
                            / cfg["moe_num_experts"]))


def active_params(cfg) -> int:
    """Parameters a token's forward multiplies by: each layer's attention
    projections, its MLP or router plus top-k experts, and the head (the
    embedding is a lookup)."""
    d, h, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    attn = d * h * hd * 2 + d * hkv * hd * 2
    if cfg.get("moe_num_experts"):
        ffn = d * cfg["moe_num_experts"] + cfg["moe_top_k"] * 3 * d * cfg["moe_d_ff"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn) + d * cfg["vocab"]


def attention_flops(cfg, context: int) -> int:
    """One token's scores and readout over ``context`` positions, every
    layer: 4 * heads * head_dim * context."""
    d, h = cfg["d_model"], cfg["n_heads"]
    hd = cfg.get("head_dim") or d // h
    return 4 * h * hd * context * cfg["n_layers"]


def prefill_flops(cfg, tokens: int, head_rows: int | None = None) -> int:
    """The forward of a causal prompt of ``tokens`` tokens: the
    parameters' 2 N per token, each token's attention over itself and the
    tokens before it, and the head over ``head_rows`` rows (all of them
    by default, as training computes it; a served prefill's head reads
    its last row only)."""
    head = cfg["d_model"] * cfg["vocab"]
    rows = tokens if head_rows is None else head_rows
    return (2 * (active_params(cfg) - head) * tokens + 2 * head * rows
            + attention_flops(cfg, tokens * (tokens + 1) // 2))


def decode_flops(cfg, context: int) -> int:
    """One generated token that attends over ``context`` positions."""
    return 2 * active_params(cfg) + attention_flops(cfg, context)


def report_work(report: dict, cfg=None,
                tokens: int | None = None) -> tuple[int, float]:
    """(launches, least seconds) of the GEMMs in a ``planned_report``
    delta: every recorded (site, shape) times its count, an expert-stack
    product's from its routed rows (``bound_s``)."""
    launches, bound = 0, 0.0
    for site, entry in report.items():
        for shape, count in entry.get("shapes", {}).items():
            dims = tuple(int(x) for x in shape.strip("()").split(",")
                         if x.strip())
            launches += count
            bound += count * bound_s(site, dims, cfg, tokens)
    return launches, bound
