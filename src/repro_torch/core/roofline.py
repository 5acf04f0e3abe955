"""Three-term roofline analysis of a dry-run cell (the port of
``repro.core.roofline``), and the outer-link term of the hierarchical
cost model.

The reference reads its terms from a compiled XLA module; PyTorch has
none, so the port reads them from the dry run's own counts
(``launch/accounting.py``, ``launch/dryrun.py``):

    compute    = FLOPs            / peak FLOP rate
    memory     = bytes accessed   / HBM rate
    collective = collective bytes / link rate

each per chip.  ``analyze`` takes the per-chip FLOPs and bytes as
``cost`` (``{"flops": ..., "bytes accessed": ...}``, the reference's
keys) and the collective bytes as ``coll``, keyed by the reference's
five collective names plus ``_counts`` (calls by name), which
``collective_bytes`` builds from ``parallel.mesh.moved`` and ``calls``.

The defaults are the card's: the NVIDIA H100 SXM 80GB data sheet's dense
peaks at its 700 W limit (989 TFLOP/s bf16, 1979 TOP/s int8, HBM3 at
3.35 TB/s, NVLink 900 GB/s both ways, 450 GB/s each way), the card that
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` names
``NVIDIA H100 80GB HBM3, 700.00 W`` on the machine the port is measured
on.  A card set below 700 W reaches less.  They are published peaks, not
measurements; ``analyze`` takes others through ``peak_flops``,
``hbm_bw`` and ``link_bw``.

``LINK_BYTES_PER_S`` and ``collective_time_s`` are another matter: they
are the copied planner's cost-model parameter, the reference's default
outer-link rate (its TPU ``ICI_BW``), which ``core/hierarchy.py`` prices
its outer splits with so that both packages rank them alike.  They are
not a rate of any card, and nothing in the roofline reads them; nothing
in ``core/`` reads ``NVLINK_BW``.
"""

from __future__ import annotations

import dataclasses

# --- NVIDIA H100 SXM 80GB, per card, at 700 W (module docstring) ----------
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_INT8 = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9  # bytes a second each way

#: the reference's default outer-link rate, bytes a second (its
#: ``ICI_BW``): a cost-model parameter (module docstring)
LINK_BYTES_PER_S = 50e9

_COLL_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``parallel.mesh``'s collectives under the reference's names (``pmean``
#: is counted under ``psum``; the port has no reduce-scatter)
MESH_COLLECTIVES = {
    "ppermute": "collective-permute",
    "all_gather": "all-gather",
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "all_to_all": "all-to-all",
}


def collective_bytes(moved: dict, calls: dict | None = None) -> dict:
    """The reference's collective dict from ``parallel.mesh.moved`` (and
    ``calls``) deltas: bytes by collective name, ``_counts`` the calls.

    The port reports the bytes its collectives actually carried between
    two members (``parallel.mesh``: a member's block copied to another),
    summed over all members.  The reference reports, per device, the
    result shapes of each collective in the compiled HLO with an
    all-reduce weighted 2x (a ring's ~2 payloads).  The port does not
    apply that weight: its all-reduce bytes are the copies it made.
    ``reduce-scatter`` is 0 (the port's mesh has none).
    """
    out: dict = dict.fromkeys(_COLL_OPS, 0)
    counts = dict.fromkeys(_COLL_OPS, 0)
    for name, nbytes in moved.items():
        out[MESH_COLLECTIVES[name]] += int(nbytes)
    for name, n in (calls or {}).items():
        counts[MESH_COLLECTIVES[name]] += int(n)
    out["_counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6*N*D (global, useful)
    useful_ratio: float           # model_flops / (flops_per_chip*chips)
    coll_breakdown: dict

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float:
        """How close the dominant term says we are to the compute roofline:
        T_compute / T_bound (1.0 = compute-bound at peak)."""
        if self.t_bound == 0:
            return 0.0
        return self.t_compute / self.t_bound

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops/chip": f"{self.flops_per_chip:.3e}",
            "bytes/chip": f"{self.bytes_per_chip:.3e}",
            "coll_bytes/chip": f"{self.coll_bytes_per_chip:.3e}",
            "t_comp_s": f"{self.t_compute:.4e}",
            "t_mem_s": f"{self.t_memory:.4e}",
            "t_coll_s": f"{self.t_collective:.4e}",
            "bound": self.bottleneck,
            "useful": f"{self.useful_ratio:.3f}",
            "roofline_frac": f"{self.roofline_fraction():.3f}",
        }


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    coll: dict,
    model_flops: float,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BW,
    link_bw: float = NVLINK_BW,
) -> Roofline:
    """The three terms of one cell (module docstring): ``cost`` per chip,
    ``coll`` as ``collective_bytes`` gives it."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll_total = float(sum(v for k, v in coll.items() if k != "_counts"))

    t_comp = flops / peak_flops
    t_mem = nbytes / hbm_bw
    t_coll = coll_total / link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)  # type: ignore[arg-type]
    useful = model_flops / (flops * chips) if flops > 0 else 0.0
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_chip=flops,
        bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll_total,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=useful,
        coll_breakdown=coll,
    )


def collective_time_s(nbytes: float,
                      link_gbps: float = LINK_BYTES_PER_S / 1e9) -> float:
    """Wire time for ``nbytes`` over a ``link_gbps`` GB/s interconnect:
    the outer-level term of the hierarchical combined cost model."""
    if nbytes <= 0:
        return 0.0
    return float(nbytes) / (link_gbps * 1e9)


def format_table(rows: list[Roofline]) -> str:
    if not rows:
        return "(empty)"
    cols = list(rows[0].row().keys())
    data = [list(r.row().values()) for r in rows]
    widths = [
        max(len(c), *(len(row[i]) if isinstance(row[i], str) else len(str(row[i]))
                      for row in data))
        for i, c in enumerate(cols)
    ]

    def fmt(vals):
        return " | ".join(str(v).ljust(w) for v, w in zip(vals, widths))
    lines = [fmt(cols), "-|-".join("-" * w for w in widths)]
    lines += [fmt(row) for row in data]
    return "\n".join(lines)
