"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --shape train_4k --steps 100 --ckpt-dir DIR [--smoke] [--device cpu]

The reference's flags (``repro.launch.train``) plus ``--device`` (default
``cuda``).  ``--smoke`` takes the reduced config and a 64 x 4 shape, so
the whole driver (checkpoints, resume, the straggler watchdog) runs on
the CPU.  Every ported family trains; ``--mesh single|multi`` trains
under ``make_production_mesh`` (16x16 or 2x16x16 logical devices: run it
under ``parallel.mesh.logical_devices(256)`` or ``(512)``, else the mesh
raises for want of devices, as the reference's does on fewer).  The
checkpoint directory defaults to ``widesa_ckpt`` under the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "widesa_ckpt"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.train import TrainConfig, Trainer

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        shape = ShapeSpec("smoke", "train", 64, 4)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
    mesh = None
    multi_pod = args.mesh == "multi"
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=multi_pod)
    tcfg = TrainConfig(base_lr=args.lr, total_steps=max(args.steps, 1),
                       ckpt_every=max(args.steps // 4, 1))
    trainer = Trainer(cfg, shape, ckpt_dir=args.ckpt_dir, tcfg=tcfg,
                      mesh=mesh, multi_pod=multi_pod, device=args.device)
    trainer.install_signal_handlers()
    trainer.run(args.steps, resume=True)
    print("done")


if __name__ == "__main__":
    main()
