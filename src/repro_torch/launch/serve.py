"""Serving launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --max-new 8 [--full] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --stream-audio [--full] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --engine paged [--block-size 16] [--num-blocks N] [--full]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --full --max-seq 528 [--engine paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --full --max-seq 528 [--engine paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --full --max-seq 528 [--engine paged]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b [--engine paged] [--device cpu]

``--full`` serves the published full-width configuration instead of the
reduced smoke one (olmoe-1b-7b: 13.8 GB of weights; mamba2-780m, the SSM
family, and zamba2-1.2b, the hybrid one, prefill at the exact prompt
length on either engine); weights are drawn
from a ``torch.Generator`` seeded with 0 on ``--device``.  A model whose
weights outgrow one card (deepseek-v2-236b: 235.7 B parameters, 471.6 GB
in bf16) is refused under ``--full`` with a line that says so; it serves
at its smoke config (``chip_smoke.py`` serves it at full width cut to 8
of its 60 layers).  ``--stream-audio`` (encdec archs) submits
synthesized int16 audio streams of ``1 + i % (enc_frames //
frames_per_chunk)`` chunks for request ``i`` through the planned
frontend chunk by chunk, and checks after the drain that the frontend's
planned stages ran; without it an encdec arch serves text requests
that each carry precomputed frames ([enc_frames, d_model] drawn from
the request stream's numpy generator and rounded to bf16), prefilled
offline.  ``--engine paged`` serves through the block-paged
engine (``--slots`` lanes, ``--block-size`` rows a KV block,
``--num-blocks`` blocks in the pool: by default every lane at full
horizon) and prints its stats; its decode step is captured once in
``load()``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def bf16_frames(rng, cfg) -> torch.Tensor:
    """One request's precomputed frames [enc_frames, d_model]: standard
    normal float64 draws from ``rng``, rounded as the reference rounds
    them (to float32, then to bfloat16 to nearest even)."""
    x = rng.standard_normal((cfg.enc_frames, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


#: the memory of the card the port targets (an 80 GB H100), the bound of
#: ``--full`` where no card is visible
CARD_BYTES = 80 * 10 ** 9


def weight_bytes(cfg) -> tuple[int, int]:
    """(parameters, bytes) of ``cfg``'s weights, from their shapes alone
    (drawn on the meta device)."""
    from repro_torch import tree
    from repro_torch.models import build_model

    params = build_model(cfg, "meta").init(torch.Generator())
    leaves = tree.leaves(params)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="lanes for either engine")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--engine", default="slot", choices=["slot", "paged"])
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block granularity (paged engine)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV blocks in the pool (paged engine; default "
                         "every lane at full horizon)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke config")
    ap.add_argument("--stream-audio", action="store_true",
                    help="submit synthesized audio streams through the "
                         "planned frontend (encdec archs only)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import planned
    from repro_torch.serve import make_engine, synth_samples

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    device = torch.device(args.device)
    if args.full:
        card = (torch.cuda.get_device_properties(device).total_memory
                if device.type == "cuda" else CARD_BYTES)
        n, need = weight_bytes(cfg)
        if need > card:
            raise SystemExit(
                f"{args.arch} at full width holds {n / 1e9:.1f} B parameters"
                f", {need / 1e9:.1f} GB of {cfg.dtype} weights: more than "
                f"the card's {card / 1e9:.1f} GB; serve it without --full")
    if args.engine == "paged":
        kw = dict(max_lanes=args.slots, block_size=args.block_size,
                  num_blocks=args.num_blocks)
    else:
        kw = dict(max_slots=args.slots)
    eng = make_engine(cfg, kind=args.engine, max_seq=args.max_seq,
                      device=args.device, **kw)
    gen = torch.Generator(device=args.device).manual_seed(0)
    eng.load(eng.api.init(gen))

    if args.stream_audio and eng.frontend is None:
        raise SystemExit(
            f"--stream-audio needs an encdec arch; {args.arch} has no "
            "audio frontend")

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        if args.stream_audio:
            n_chunks = 1 + i % (cfg.enc_frames
                                // eng.frontend.cfg.frames_per_chunk)
            eng.submit_audio_stream(
                synth_samples(eng.frontend.cfg, n_chunks, seed=i),
                max_new_tokens=args.max_new)
            continue
        plen = int(rng.integers(4, 16))
        extra = None
        if cfg.family == "encdec":  # audio models decode against frames
            extra = {"frames": bf16_frames(rng, cfg)}
        eng.submit_text(rng.integers(0, cfg.vocab, plen),
                        max_new_tokens=args.max_new, extra=extra)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {eng.device}")
    print("planned GEMM call sites (site: planned/fallback calls, "
          "backends):")
    rows = planned.planned_report()
    for site, st in rows.items():
        mix = ",".join(f"{b}={n}" for b, n in sorted(st["backends"].items()))
        print(f"  {site}: {st['planned']}/{st['fallback']}  [{mix or '-'}]")
    if args.stream_audio:
        front = sorted(s for s, st in rows.items()
                       if s.startswith("frontend.") and st["planned"])
        if not front:
            raise SystemExit("audio streaming executed no planned frontend "
                             "stages")
        print(f"planned frontend stages: {front}")
    if args.engine == "paged":
        print(f"paged stats: {eng.stats}")
        if eng.stats["decode_compiles"] != 1:
            raise SystemExit("in-flight traffic re-captured the decode "
                             "step")
    if planned.planned_enabled() and not any(
            st["planned"] for st in rows.values()):
        raise SystemExit("serving executed no planned GEMMs")
    return done


if __name__ == "__main__":
    main()
