"""FLOP, byte and memory accounting of the dry run (the port of
``repro.launch.accounting``).

The reference reads XLA's ``cost_analysis``, which counts a while loop's
(``lax.scan``'s) body once, and so lowers the big archs as two probe
programs, L = 1 and L = 2 unrolled layers at the full global shapes,
combined as ``probe(1) + (L - 1) * delta`` (``probe_configs``,
``combine_probe``), and adds blockwise attention's chunk scans
analytically (``attention_adjustment``).  Those three are copied here
unchanged; the tests hold them to the reference's.

The port runs eagerly, so its counts are exact at any depth: a dry-run
cell runs the step itself on fake tensors (``launch/fakecuda.py``) under
``StepCounter``, and the attention's chunk loops are counted, not added.
The probes remain for time: a mesh program runs member after member,
256-512 times a layer, and the probes run two layers where the model has
up to 64.  ``combine_linear`` extends the probe correction to the peak
and the kernel tally.

``StepCounter`` is a ``TorchDispatchMode`` that counts every aten
operator the step dispatches:

* **FLOPs.**  Matrix products, convolutions and fused attention by
  ``torch.utils.flop_counter``'s registered formulas (2·M·N·K a product:
  ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` and the
  ``scaled_dot_product_*`` kernels); every other operator one FLOP for
  each element of its largest operand or output (XLA's
  ``HloCostAnalysis`` convention of a FLOP an element, reductions by
  their input).  Zero for view operators, for operators with no tensor
  input (factories, random draws) and for the data movement of
  ``ZERO_FLOP_OPS`` (copies, casts, concatenation, gathers, scatters,
  indexing, padding, fills).  An operator with no tensor output (a
  metadata query such as ``prim.device``) counts nothing at all.
* **Bytes.**  Each operator's tensor inputs read once and its outputs
  written once (a broadcast input's distinct elements; nothing for views
  and ``empty``): the port's eager, unfused bytes, which exceed XLA's
  fused count by design, since every elementwise step of an eager
  program goes to memory and back.
* **Peak live bytes.**  Each new storage an operator allocates is live
  until the last tensor the step saw over it is freed
  (``weakref.finalize``; a tensor kept by autograd lives on).  Tensors
  that exist before the mode opens are the step's arguments and are not
  counted here (``dryrun`` counts them from the spec trees).
* **Kernels.**  Each launch of the GEMM wrappers on fake operands
  (``kernels.widesa_mm.fake_launch``): launches by ``kernel/variant``,
  and the product's FLOPs and bytes, which no aten operator carries.
* **Collectives.**  The deltas of ``parallel.mesh.moved`` and ``calls``
  over the counted block.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels import widesa_mm
from repro_torch.models.layers import BLOCKWISE_SEQ_THRESHOLD
from repro_torch.parallel import mesh as pm

_COLL_KEYS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: operators that move or make data and compute nothing (0 FLOPs)
ZERO_FLOP_OPS = frozenset({
    "_to_copy", "copy_", "copy", "clone", "cat", "stack", "index",
    "index_select", "gather", "scatter", "index_put", "index_put_",
    "embedding", "fill_", "fill", "zero_", "constant_pad_nd",
    "slice_scatter", "select_scatter", "masked_scatter", "repeat",
    "_unsafe_index", "lift_fresh", "lift_fresh_copy", "flip", "roll",
    "contiguous", "_local_scalar_dense",
})

#: operators that allocate without writing (0 bytes)
_EMPTY_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})


def probe_configs(cfg: ModelConfig) -> tuple[ModelConfig, ModelConfig,
                                             int, int]:
    """(probe_small, probe_big, L_small, L_real_scaling_count).

    moe:    first_dense kept, moe layers 1 vs 2 — delta = one MoE layer.
    hybrid: 1 vs 2 full segments (attn_every SSM blocks + 1 shared block),
            remainder blocks kept in both probes — delta = one segment.
    dense / vlm / ssm: layers 1 vs 2 — delta = one layer.
    """
    if cfg.family == "moe":
        fd = min(cfg.moe_first_dense, 1)
        small = dataclasses.replace(
            cfg, n_layers=fd + 1, moe_first_dense=fd,
            scan_unroll=True, logit_chunk=0)
        big = dataclasses.replace(
            cfg, n_layers=fd + 2, moe_first_dense=fd,
            scan_unroll=True, logit_chunk=0)
        scaling = (cfg.n_layers - cfg.moe_first_dense) - 1
        return small, big, fd + 1, scaling
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        every = cfg.attn_every
        n_seg = cfg.n_layers // every
        rem = cfg.n_layers - n_seg * every
        small = dataclasses.replace(
            cfg, n_layers=every + rem, scan_unroll=True, logit_chunk=0)
        big = dataclasses.replace(
            cfg, n_layers=2 * every + rem, scan_unroll=True,
            logit_chunk=0)
        return small, big, every + rem, n_seg - 1
    small = dataclasses.replace(cfg, n_layers=1, scan_unroll=True,
                                logit_chunk=0)
    big = dataclasses.replace(cfg, n_layers=2, scan_unroll=True,
                              logit_chunk=0)
    return small, big, 1, cfg.n_layers - 1


def combine_probe(cost1: dict, coll1: dict, cost2: dict, coll2: dict,
                  scaling: int) -> tuple[float, float, dict]:
    """corrected = probe1 + scaling * (probe2 - probe1)."""
    f1, f2 = float(cost1.get("flops", 0)), float(cost2.get("flops", 0))
    b1 = float(cost1.get("bytes accessed", 0))
    b2 = float(cost2.get("bytes accessed", 0))
    flops = f1 + scaling * max(f2 - f1, 0.0)
    nbytes = b1 + scaling * max(b2 - b1, 0.0)
    coll = {}
    for k in _COLL_KEYS:
        c1, c2 = float(coll1.get(k, 0)), float(coll2.get(k, 0))
        coll[k] = c1 + scaling * max(c2 - c1, 0.0)
    return flops, nbytes, coll


def combine_linear(v1: dict, v2: dict, scaling: int) -> dict:
    """``combine_probe``'s correction key by key over two count dicts (the
    peak, the kernel tally, the collective calls)."""
    return {k: v1.get(k, 0) + scaling * max(v2.get(k, 0) - v1.get(k, 0), 0)
            for k in sorted(set(v1) | set(v2))}


# ---------------------------------------------------------------------------
# analytic blockwise-attention adjustment (global flops, all layers)
# ---------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    if cfg.family == "encdec":
        return 0  # handled specially (enc self + dec self + cross)
    return 0  # ssm


def attention_adjustment(cfg: ModelConfig, shape: ShapeSpec,
                         kind: str) -> float:
    """Analytic flops of blockwise attention (einsum QK^T + PV), global,
    summed over layers, with fwd/bwd/remat multipliers.  Returns 0 when
    the sequence is short enough for the exact sdpa path."""
    s = shape.seq_len
    b = shape.global_batch
    if kind == "decode":
        return 0.0  # decode attention is unscanned, exact in HLO
    if s <= BLOCKWISE_SEQ_THRESHOLD:
        return 0.0

    def one(sq, skv, h, dqk, dv, layers):
        return 2.0 * b * h * sq * skv * (dqk + dv) * layers

    if cfg.family == "encdec":
        # encoder self (frames, short -> sdpa, exact), decoder self (s x s)
        # + cross (s x frames)
        fwd = one(s, s, cfg.n_heads, cfg.hd, cfg.hd, cfg.n_layers)
        if max(s, cfg.enc_frames) > BLOCKWISE_SEQ_THRESHOLD:
            fwd += one(s, cfg.enc_frames, cfg.n_heads, cfg.hd, cfg.hd,
                       cfg.n_layers)
    elif cfg.use_mla:
        dqk = cfg.nope_head_dim + cfg.rope_head_dim
        fwd = one(s, s, cfg.n_heads, dqk, cfg.v_head_dim,
                  _attn_layers(cfg))
    elif cfg.family == "ssm":
        return 0.0
    else:
        fwd = one(s, s, cfg.n_heads, cfg.hd, cfg.hd, _attn_layers(cfg))

    if kind == "train":
        mult = 3.5 + (1.0 if cfg.remat == "full" else 0.0)
    else:  # prefill
        mult = 1.0
    if cfg.causal_block_skip:
        mult *= 0.5  # triangular schedule visits ~half the kv blocks
    return fwd * mult


# ---------------------------------------------------------------------------
# the port's counter
# ---------------------------------------------------------------------------

def _distinct(t: torch.Tensor) -> int:
    """Elements of ``t`` in memory: a broadcast (stride 0) dimension
    counts once."""
    n = 1
    for extent, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= extent
    return n


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, the live-byte peak, kernel launches and
    collectives of the block it is open over (module docstring).

    ``flops`` is split by source: ``kernel`` (the GEMM wrappers' fake
    launches), ``matmul`` and ``attention`` (``flop_counter``'s formulas:
    the blockwise attention's ``torch.matmul`` products count under
    ``matmul``) and ``other`` (a FLOP an element).
    """

    def __init__(self):
        super().__init__()
        self.flops = {"kernel": 0, "matmul": 0, "attention": 0, "other": 0}
        self.bytes = 0
        self.kernels: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.moved: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self._storages: dict[int, list] = {}

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    def __enter__(self):
        self._moved0, self._calls0 = dict(pm.moved), dict(pm.calls)
        widesa_mm.fake_sinks.append(self._launch)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            widesa_mm.fake_sinks.remove(self._launch)
            self.moved = {k: pm.moved[k] - self._moved0[k] for k in pm.moved}
            self.calls = {k: pm.calls[k] - self._calls0[k] for k in pm.calls}

    def _launch(self, record: dict) -> None:
        key = f"{record['kernel']}/{record['variant']}"
        self.kernels[key] = self.kernels.get(key, 0) + 1
        self.flops["kernel"] += record["flops"]
        self.bytes += record["bytes"]

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._storages[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _memory(self, ins: list, outs: list) -> None:
        read = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key not in self._storages:
                if key in read:
                    continue  # an argument's storage, written in place
                nbytes = t.untyped_storage().nbytes()
                self._storages[key] = [nbytes, 0]
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            self._hold(t, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out  # a metadata query (``prim.device``, sizes)
        name = func.overloadpacket.__name__
        if func.is_view:
            for t in outs:
                key = _storage_key(t)
                if key in self._storages:
                    self._hold(t, key)
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            kind = "attention" if "attention" in name else "matmul"
            self.flops[kind] += int(formula(*args, **kwargs, out_val=out))
        elif ins and name not in ZERO_FLOP_OPS:
            self.flops["other"] += max(t.numel() for t in ins + outs)
        if name not in _EMPTY_OPS:
            seen = {id(t): t for t in ins}
            self.bytes += sum(_distinct(t) * t.element_size()
                              for t in seen.values())
            self.bytes += sum(_distinct(t) * t.element_size() for t in outs)
        self._memory(ins, outs)
        return out
