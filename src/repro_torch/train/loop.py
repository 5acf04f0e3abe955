"""Fault-tolerant training driver on one device (the port of
``repro.train.loop``).

  * checkpoint/restart: asynchronous checkpoints with an atomic commit;
    ``run(resume=True)`` restores the latest complete step's parameters;
  * preemption: SIGTERM/SIGINT saves at the next step boundary, then
    exits with code 99 ("resumable");
  * stragglers: a step slower than ``straggler_factor`` times the running
    median is counted and logged;
  * replay: batches are a pure function of (seed, step), so a resumed run
    sees the stream it would have seen.

  * elasticity: with a ``mesh`` (``parallel/mesh.py``) init and every
    step run under ``mesh_context(mesh)``, and a resume restores onto
    the current mesh (``restore_checkpoint(shardings=...)``), so a run
    checkpointed on one mesh resumes on a smaller one (``rebuild``).

The parameters are the port's own ``init_params`` drawn on ``device``
from a ``torch.Generator`` seeded with ``TrainConfig.seed``.  The port
holds whole tensors on one controller, so under a mesh only the MoE
blocks compute differently (their TP and EP mesh paths,
``models/moe.py``); the parameter, optimizer and batch spec trees are
resolved against the mesh's rules as the reference's are
(``param_shardings``, ``opt_shardings``, ``batch_shardings``) and the
parameters' place a restore.
"""

from __future__ import annotations

import collections
import dataclasses
import signal
import statistics
import time

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data import SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamWState, adamw_init, opt_state_logical
from repro_torch.parallel.mesh import P
from repro_torch.parallel.sharding import (NamedSharding, logical_spec_tree,
                                           mesh_context,
                                           spec_tree_to_shardings)

from .step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    base_lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    straggler_warmup: int = 8


def batch_tensors(batch: dict, device) -> dict:
    """A pipeline batch's numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *, ckpt_dir: str,
                 tcfg: TrainConfig | None = None, mesh=None,
                 multi_pod: bool = False, fsdp: bool = True, device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainConfig()
        self.device = torch.device(device)
        self.api = build_model(cfg, self.device)
        self.mesh = mesh
        self.multi_pod = multi_pod
        self.fsdp = fsdp
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=self.tcfg.ckpt_keep)
        self.ckpt_dir = ckpt_dir
        self.data = SyntheticPipeline(cfg, shape, seed=self.tcfg.seed)
        self._preempted = False
        self.straggler_events = 0
        self._step_times: collections.deque = collections.deque(maxlen=50)
        self.step_fn = make_train_step(self.api, cfg, tcfg=self.tcfg)
        self._build()

    # -- construction ------------------------------------------------------
    def _ctx(self):
        return mesh_context(self.mesh, fsdp=self.fsdp,
                            multi_pod=self.multi_pod)

    def _build(self):
        """The spec trees of the parameters, the optimizer state and a
        batch under the mesh's rules (None without a mesh)."""
        self.param_shardings = self.opt_shardings = None
        self.batch_shardings = None
        with self._ctx() as ctx:
            if ctx is None:
                return
            p_log = self.api.param_logical()
            o_log = opt_state_logical(p_log)
            self.param_shardings = spec_tree_to_shardings(
                self.mesh, logical_spec_tree(ctx, p_log))
            self.opt_shardings = AdamWState(
                m=spec_tree_to_shardings(self.mesh,
                                         logical_spec_tree(ctx, o_log.m)),
                v=spec_tree_to_shardings(self.mesh,
                                         logical_spec_tree(ctx, o_log.v)),
                count=NamedSharding(self.mesh, P()))
            self.batch_shardings = spec_tree_to_shardings(
                self.mesh, logical_spec_tree(ctx, self.api.batch_logical()))

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        with self._ctx():
            params = self.api.init(gen)
            return params, adamw_init(params)

    # -- fault handling ----------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def _watchdog(self, dt: float) -> bool:
        self._step_times.append(dt)
        if len(self._step_times) < self.tcfg.straggler_warmup:
            return False
        if dt > self.tcfg.straggler_factor * statistics.median(
                self._step_times):
            self.straggler_events += 1
            return True
        return False

    # -- main loop ---------------------------------------------------------
    def run(self, n_steps: int, *, resume: bool = True):
        params, opt_state = self.init_state()
        start = 0
        last = latest_step(self.ckpt_dir)
        if resume and last is not None:
            shardings = (None if self.param_shardings is None
                         else {"p": self.param_shardings})
            params = restore_checkpoint(self.ckpt_dir, last, {"p": params},
                                        shardings=shardings)["p"]
            start = last
            print(f"[trainer] resumed from step {last}")
        history = []
        for step in range(start, start + n_steps):
            t0 = time.perf_counter()
            batch = batch_tensors(self.data.batch(step), self.device)
            with self._ctx():
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch, step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self._watchdog(dt)
            history.append(loss)
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step={step} loss={loss:.4f} "
                      f"dt={dt * 1e3:.0f}ms" + (" STRAGGLER" if slow else ""))
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, {"p": params})
            if self._preempted:
                print("[trainer] preemption: saving + exiting")
                self.ckpt.save(step + 1, {"p": params})
                self.ckpt.wait()
                raise SystemExit(99)
        self.ckpt.save(start + n_steps, {"p": params})
        self.ckpt.wait()
        return params, opt_state, history

    # -- elastic restart ---------------------------------------------------
    def rebuild(self, new_mesh):
        """Point the trainer at another mesh (the survivors); the next
        ``run(resume=True)`` restores onto it."""
        self.mesh = new_mesh
        self._build()
