"""The roofline, FLOP and byte arithmetic against hand-computed decode
shapes of both configurations."""

import pytest

import tiny  # noqa: F401
import harness
import yardstick as Y


def _port(cell):
    return harness.cell(cell)["config"]["port"]


def test_gemm_flops_bytes_bound():
    assert Y.gemm_flops((16, 2048, 2048)) == 2 * 16 * 2048 * 2048
    assert Y.gemm_flops((64, 16, 1024, 2048)) == 2 * 64 * 16 * 1024 * 2048
    assert Y.gemm_bytes((16, 2048, 2048), 2, 2) == (
        16 * 2048 + 2048 * 2048 + 16 * 2048) * 2
    # the decode expert gate of olmoe: 64 experts' [2048, 1024] bf16 read
    b = Y.gemm_bytes((64, 16, 1024, 2048), 2, 2)
    assert b == 64 * (16 * 2048 * 2 + 2048 * 1024 * 2 + 16 * 1024 * 2)
    assert Y.gemm_bound_s("moe.gate", (64, 16, 1024, 2048)) == pytest.approx(
        b / 3.35e12)
    # a large square GEMM is bounded by its FLOPs
    assert Y.gemm_bound_s("attn.q", (8192, 8192, 8192)) == pytest.approx(
        2 * 8192**3 / 989e12)
    assert Y.site_bytes("moe.router") == (4, 4)
    assert Y.site_bytes("attn.paged_scores") == (2, 4)
    assert Y.site_bytes("attn.scores/bwd_da") == (2, 2)


def test_olmoe_decode_step_shapes():
    cfg = _port("olmoe-chat")
    g = Y.decode_gemms(cfg, 16, 2048)
    assert len(g) == 16 * 10 + 1
    layer = dict(g[:10])
    assert layer["attn.q"] == (16, 2048, 2048)
    assert layer["attn.paged_scores"] == (16 * 16, 1, 2048, 128)
    assert layer["attn.paged_values"] == (16 * 16, 1, 128, 2048)
    assert layer["moe.router"] == (16, 64, 2048)
    # dropless: capacity 16 rows an expert at 16 lanes
    assert layer["moe.gate"] == (64, 16, 1024, 2048)
    assert layer["moe.down"] == (64, 16, 2048, 1024)
    assert g[-1] == ("lm_head", (16, 50304, 2048))
    # the expert stack's bytes: its weights, 3 x 64 x 2048 x 1024 x 2, and
    # each expert's 16 rows in (2048 or 1024 wide) and out
    experts = sum(Y.gemm_bytes(d, 2, 2) for s, d in g[:10]
                  if s in ("moe.gate", "moe.up", "moe.down"))
    assert experts == 3 * 64 * 2048 * 1024 * 2 + 3 * 64 * 16 * 3072 * 2


def test_stablelm_decode_step_shapes():
    cfg = _port("stablelm-batch")
    g = Y.decode_gemms(cfg, 16, 2048)
    assert len(g) == 40 * 9 + 1
    layer = dict(g[:9])
    assert layer["attn.q"] == (16, 32 * 160, 5120)
    assert layer["attn.k"] == (16, 8 * 160, 5120)
    assert layer["attn.paged_scores"] == (16 * 8, 4, 2048, 160)
    assert layer["mlp.gate"] == (16, 13824, 5120)
    assert layer["mlp.down"] == (16, 5120, 13824)
    weights = sum(Y.gemm_bytes(d, 2, 2) for s, d in g
                  if not s.startswith("attn.paged"))
    # ~24.3 GB of weights less the embedding, read once a step
    assert weights / 1e9 == pytest.approx(
        (24.3e9 - 100352 * 5120 * 2) / 1e9, rel=0.02)


def test_active_params_and_flops():
    olmoe = _port("olmoe-chat")
    # 16 x (4 x 2048^2 + 2048 x 64 + 8 x 3 x 2048 x 1024) + 2048 x 50304
    want = 16 * (4 * 2048**2 + 2048 * 64 + 8 * 3 * 2048 * 1024) + 2048 * 50304
    assert Y.active_params(olmoe) == want
    assert Y.decode_flops(olmoe, 100) == 2 * want + 4 * 16 * 128 * 100 * 16
    assert Y.prefill_flops(olmoe, 10, head_rows=1) == (
        2 * (want - 2048 * 50304) * 10 + 2 * 2048 * 50304
        + 4 * 16 * 128 * 55 * 16)
    dense = _port("stablelm-batch")
    assert Y.active_params(dense) == 40 * (
        2 * 5120 * 5120 + 2 * 5120 * 1280 + 3 * 5120 * 13824) + 5120 * 100352
    assert Y.capacity(olmoe, 16) == 16
    assert Y.capacity(_port("olmoe-train"), 4096) == 640


def _expert_report(cfg, tokens):
    """A facade report of one MoE layer's forward and backward over
    ``tokens`` tokens, at the capacity the configuration pads to."""
    e, ff, d = cfg["moe_num_experts"], cfg["moe_d_ff"], cfg["d_model"]
    c = Y.capacity(cfg, tokens)
    shapes = {"moe.gate": (e, c, ff, d), "moe.up": (e, c, ff, d),
              "moe.down": (e, c, d, ff), "moe.gate/bwd_da": (e, c, d, ff),
              "moe.down/bwd_db": (e, ff, d, c),
              "moe.router": (tokens, e, d)}
    return {s: {"shapes": {str(v): 2}} for s, v in shapes.items()}


def test_expert_bound_counts_routed_rows():
    cfg = _port("olmoe-chat")
    touched = 64 * (1 - (1 - 8 / 64) ** 16)
    assert Y.experts_touched(cfg, 16) == pytest.approx(touched)
    assert Y.experts_touched(cfg, 4096) == pytest.approx(64)
    # decode at 16 lanes: 128 routed rows, the touched experts' weights
    want = max(2 * 128 * 1024 * 2048 / 989e12,
               ((128 * 2048 + touched * 2048 * 1024) * 2 + 128 * 1024 * 2)
               / 3.35e12)
    assert Y.bound_s("moe.gate", (64, 16, 1024, 2048), cfg, 16) == \
        pytest.approx(want)
    # a 512-token prefill: dropless capacity is the prompt's length, 8 x
    # the rows routed; the bound counts the routed ones
    flops = 2 * 512 * 8 * 1024 * 2048
    assert Y.bound_s("moe.gate", (64, 512, 1024, 2048), cfg) == pytest.approx(
        max(flops / 989e12, ((4096 * 2048 + 64 * 2048 * 1024) * 2
                             + 4096 * 1024 * 2) / 3.35e12), rel=1e-6)
    # the weight gradient: both operands routed rows, the output a weight
    assert Y.bound_s("moe.down/bwd_db", (64, 1024, 2048, 512), cfg) == \
        pytest.approx(max(flops / 989e12, (4096 * (1024 + 2048) * 2
                                           + 64 * 1024 * 2048 * 2) / 3.35e12),
                      rel=1e-6)
    # other sites keep the shape's own count
    assert Y.bound_s("moe.router", (16, 64, 2048), cfg, 16) == \
        Y.gemm_bound_s("moe.router", (16, 64, 2048))


@pytest.mark.parametrize("tokens", [16, 37, 512, 1536, 4096])
def test_expert_bound_does_not_change_with_capacity_factor(tokens):
    base = _port("olmoe-chat")
    bounds = []
    for factor in (1.0, 1.25, 8.0):
        cfg = dict(base, moe_capacity_factor=factor)
        decode = sum(Y.bound_s(s, d, cfg, tokens)
                     for s, d in Y.decode_gemms(cfg, tokens, 2048))
        launches, eager = Y.report_work(_expert_report(cfg, tokens), cfg,
                                        tokens)
        assert launches == 12
        bounds.append((decode, eager))
    for b in bounds[1:]:
        assert b == pytest.approx(bounds[0])


def test_tokens_of_capacity_inverts_capacity():
    dropless = _port("olmoe-chat")
    trained = _port("olmoe-train")
    for t in (1, 16, 37, 512, 1536, 4096):
        assert Y.tokens_of_capacity(dropless, Y.capacity(dropless, t)) == t
        got = Y.tokens_of_capacity(trained, Y.capacity(trained, t))
        assert Y.capacity(trained, got) == Y.capacity(trained, t)
        assert got <= t
    # a record read without its tokens counts those of its capacity
    rep = _expert_report(dropless, 700)
    assert Y.report_work(rep, dropless) == Y.report_work(rep, dropless, 700)
