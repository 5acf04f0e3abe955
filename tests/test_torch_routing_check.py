"""``chip_smoke.routing_explains_grads`` on the CPU: the escape hatch of
the card's MoE gradient check (a), which lets a gradient miss pass only
where the router's top-k flipped at a near-tie.

olmoe-1b-7b's SMOKE in float32.  The "kernel" path is the model under
planning (``planned.override(enabled=True)``), the plain path the model
with planning disabled, as on the card; here both run the plain
versions, so the kernel path's differences are planted by wrapping the
MoE module's facade calls: a near-tie at token 0 of every layer's router
logits (the (k+1)-th expert's logit shifted to ``gap`` below the k-th's
on both paths, a detached shift that changes no gradient), the k-th's
lowered by a ``nudge`` on the kernel path only (so the two paths' top-k
differ in one expert while the renormalised weights of the experts both
keep are the same, and only the tie bound can reject a wide flip), and a
``fault`` factor on the kernel path's ``moe.down`` output.  The check must explain a flip at a near-tie
and nothing else: not a flip past ``ROUTER_ATOL``, not a near-tie flip
beside a fault of the expert GEMMs, not such a fault alone, and not a
run without any flip.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import planned  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.train.loop import batch_tensors  # noqa: E402


@pytest.fixture(scope="module")
def olmoe():
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = batch_tensors(
        SyntheticPipeline(cfg, ShapeSpec("t", "train", 16, 2)).batch(0),
        "cpu")
    return cfg, params, batch


def _plant(monkeypatch, cfg, gap, nudge, fault=1.0):
    dense, bmm = moe.planned_dense, moe.planned_bmm
    k = cfg.moe_top_k

    def router(x, w, *, site="dense"):
        logits = dense(x, w, site=site)
        if site != "moe.router" or gap is None:
            return logits
        row = logits[0].detach()
        order = row.argsort(descending=True)
        kth, nxt = order[k - 1], order[k]
        shift = torch.zeros_like(logits)
        shift[0, nxt] = row[kth] - row[nxt] - gap
        if planned.planned_enabled():
            shift[0, kth] -= nudge
        return logits + shift

    def expert(a, b, *, site="bmm", out_dtype=None):
        y = bmm(a, b, site=site, out_dtype=out_dtype)
        if site == "moe.down" and planned.planned_enabled():
            y = y * fault
        return y

    monkeypatch.setattr(moe, "planned_dense", router)
    monkeypatch.setattr(moe, "planned_bmm", expert)


# (gap on both paths, nudge on the kernel path, fault, explained): the
# near-tie flips at a probability gap of ~1e-6 against ROUTER_ATOL 1e-3;
# the clear flip at ~0.05; the fault moves every expert output by 1 % (and
# with it the next layer's routing, a genuine near-tie flip there)
CASES = {
    "near-tie flip": (1e-5, 2e-5, 1.0, True),
    "flip past the tie bound": (0.5, 1.0, 1.0, False),
    "near-tie flip beside an expert-GEMM fault": (1e-5, 2e-5, 1.01, False),
    "expert-GEMM fault alone": (None, 0.0, 1.01, False),
    "no flip": (None, 0.0, 1.0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_explains_only_near_tie_flips(olmoe, monkeypatch, case):
    gap, nudge, fault, explained = CASES[case]
    cfg, params, batch = olmoe
    _plant(monkeypatch, cfg, gap, nudge, fault)
    ok, why = chip_smoke.routing_explains_grads(torch, cfg, params, batch)
    assert ok is explained, why
    if gap is not None:  # the planted flip: layer 0, token 0
        assert "[(0, 0, " in why, why
    if case == "no flip":
        assert why.startswith("0 routing flips"), why
