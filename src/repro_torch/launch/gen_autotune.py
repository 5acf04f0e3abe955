"""Generate the port's crossover table on the card (the port of the
reference's ``tools/gen_autotune.py``).

Races the hand kernel (``pallas``) against the plain version (``xla``),
and, where the card's logical devices build the key's mesh (1 x 1 on one
card: one member), the chip-level schedules (``systolic``,
``allgather``; ``fused_systolic`` for the fused chains), as the
reference's race does on its host's devices,
for every registered spec's smoke and bench cases at the spec's smoke
proxy shape, for the serving census of the smoke configs (every
``(kind, shape, dtype)`` the planned facade plans in a forward of
qwen1.5-0.5b's and whisper-base's SMOKE over a 2 x 12 batch, run on the
CPU; single GEMMs keyed at their real shape and raced at the proxy, the
fused MLP pairs at their real shape), on meshes 1x1 and 1x8, and writes
the table; it writes none where an entry lacks the hand kernel's timing.
The table's ``note`` names the card and its power limit.

Two-level plans add one more key family, as in the reference:
``--hierarchy`` (on by default) races each serving GEMM case under
``core.SERVING_HIERARCHICAL_TARGET`` (outer 1 x 2 over the facade's inner
1 x 8 target) at its real shape, the compositions of the hand kernel and
of the plain version (``hierarchy.lower_hierarchical``), and writes the
five-field ``...|outer1x2|mesh1x8`` keys; shapes with no legal outer
split are skipped.  ``--merge`` loads the table at ``--out``, keeps its
entries byte for byte and races only the keys it lacks.

    python -m repro_torch.launch.gen_autotune \
        [--out src/repro_torch/core/default_autotune.json] [--reps 3] \
        [--warmup 1] [--mesh RxC ...] [--no-serving] [--no-hierarchy] \
        [--merge] [--device cuda]

Run it from the repository root with ``PYTHONPATH=src``.
"""

from __future__ import annotations

import argparse
import subprocess

#: Smoke configs whose forward stands in for serving traffic: one GLU
#: decoder (dense mm sites) and one non-GLU enc-dec (the fused MLP pair).
SERVING_ARCHS = ("qwen1.5-0.5b", "whisper-base")


def serving_cases() -> tuple[tuple, tuple]:
    """(single GEMM cases, fused-chain cases) the planned facade plans in
    a no-grad forward and loss of each ``SERVING_ARCHS`` SMOKE config on
    the CPU (tokens [2, 12], whisper's frames [2, 8, d]): the reference's
    abstract trace, run on small tensors."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import planned
    from repro_torch.models import build_model

    from repro_torch.core.autotune import PlanPolicy

    planned.observed_clear()
    with torch.no_grad(), planned.override(
            enabled=True, policy=PlanPolicy(mode="modelled")):
        for arch in SERVING_ARCHS:
            cfg = get_smoke_config(arch)
            api = build_model(cfg, "cpu")
            params = api.init(torch.Generator().manual_seed(0))
            toks = torch.zeros((2, 12), dtype=torch.int32)
            batch = {"tokens": toks, "labels": toks}
            if not cfg.mlp_glu:  # enc-dec batches carry audio frames
                batch["frames"] = torch.zeros((2, 8, cfg.d_model))
            api.loss(params, batch)
    extra, chains = [], []
    for kind, shape, dtype in planned.observed_requests():
        (chains if "+" in kind else extra).append((kind, shape, dtype))
    return tuple(extra), tuple(chains)


def hierarchy_entries(cases: tuple, policy, skip=frozenset()) -> dict:
    """Race each single-GEMM serving case under the serving hierarchical
    target and return ``{five-field key: entry}``; keys in ``skip`` and
    shapes with no legal outer split (``HierarchyError``) are left out."""
    from repro_torch.core import autotune
    from repro_torch.core.hierarchy import (SERVING_HIERARCHICAL_TARGET,
                                            HierarchyError)
    from repro_torch.kernels import registry

    ht = SERVING_HIERARCHICAL_TARGET
    out: dict[str, dict] = {}
    for kind, args, dtype in cases:
        if "+" in kind:
            continue  # chains never compose hierarchically
        rec = registry.get(kind).builder(*args, dtype)
        key = autotune.autotune_key(rec, ht.mesh_shape,
                                    outer_shape=ht.outer_shape)
        if key in skip or key in out:
            continue
        try:
            entry = autotune.race(rec, ht, policy)
        except HierarchyError as e:
            print(f"  hier  {kind:13s} {dtype:8s} {args} skipped: {e}",
                  flush=True)
            continue
        out[key] = entry
        print(f"  raced hier {kind:8s} {dtype:8s} {args} outer"
              f"{'x'.join(str(o) for o in ht.outer_shape)} "
              f"-> {entry['backend']:6s} {entry['us']}", flush=True)
    return out


def where(device: str) -> str:
    """The card and its power limit (``nvidia-smi``), or the CPU."""
    if device == "cpu":
        return "the CPU (plain versions on both backends)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card_note(device: str) -> str:
    """The table's note: what generated it, on which card at which power
    limit, or the CPU."""
    return ("the port's crossover table: pallas (the hand kernel) against "
            "xla (the plain PyTorch version) and, at mesh1x1, the "
            "chip-level schedules (systolic, allgather, fused_systolic) on "
            "a 1x1 mesh, whose timings are one member's, each spec's cases "
            "raced at its smoke proxy shape, median of reps after warmup, "
            f"measured on {where(device)}; regenerate with python -m "
            "repro_torch.launch.gen_autotune")


def main(argv=None) -> int:
    import torch

    from repro_torch.core import autotune

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(autotune.DEFAULT_TABLE_PATH))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--mesh", action="append", default=None,
                    help="mesh RxC to key entries under (repeatable; "
                         "default: 1x1 and 1x8)")
    ap.add_argument("--serving", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--hierarchy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also race the serving GEMMs under the serving "
                         "hierarchical target (five-field outer|mesh keys)")
    ap.add_argument("--merge", action="store_true",
                    help="load the table at --out and race only the keys "
                         "it lacks (its entries stay byte for byte)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("gen_autotune: no CUDA device; pass --device cpu "
                         "to race on the CPU")
    if args.device != "cpu":
        from repro_torch.kernels import build

        for lib in build.build(tuple(build.SOURCES)):
            build.library(lib)
    meshes = (tuple(tuple(int(d) for d in m.split("x")) for m in args.mesh)
              if args.mesh else ((1, 1), (1, 8)))
    policy = autotune.PlanPolicy(mode="measured", reps=args.reps,
                                 warmup=args.warmup, device=args.device)
    extra, chains = (serving_cases() if args.serving or args.hierarchy
                     else ((), ()))
    print(f"gen_autotune: serving census -> {len(extra)} GEMM shapes, "
          f"{len(chains)} fused chains; racing on {args.device}", flush=True)
    if args.merge:
        import copy

        # load_table memoizes by (path, mtime): copy before adding to it
        table = copy.deepcopy(autotune.load_table(args.out))
        print(f"gen_autotune: merge mode, keeping the "
              f"{len(table['entries'])} entries of {args.out}", flush=True)
    else:
        print(f"gen_autotune: racing backends for meshes {meshes}",
              flush=True)
        table = autotune.build_default_table(
            meshes=meshes, policy=policy,
            extra_cases=extra if args.serving else (),
            chain_cases=chains if args.serving else (),
            note=card_note(args.device))
    if args.hierarchy:
        print("gen_autotune: racing the serving GEMMs under the "
              "hierarchical target", flush=True)
        added = hierarchy_entries(extra, policy, skip=set(table["entries"]))
        table["entries"].update(added)
        if args.merge and added:
            table["note"] += (f"; {len(added)} two-level keys (outer "
                              f"1x2) merged later on {where(args.device)}")
    untimed = sorted(k for k, e in table["entries"].items()
                     if "pallas" not in e["us"])
    if untimed:
        raise SystemExit(f"gen_autotune: the hand kernel has no timing for "
                         f"{untimed}; no table written")
    autotune.save_table(args.out, table)
    winners: dict[str, int] = {}
    for e in table["entries"].values():
        winners[e["backend"]] = winners.get(e["backend"], 0) + 1
    print(f"gen_autotune: wrote {args.out} ({len(table['entries'])} "
          f"entries; winners: {winners})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
