"""Fault-tolerant training loop on the snapshot-checkpoint chain (PyTorch
port of ``repro.train.trainer``).

Production concerns implemented here:

* **checkpoint/restart** — every ``ckpt_every`` steps the full training
  state (params, optimizer, data-pipeline step) is delta-saved into the
  snapshot chain (only dirty pages are written — ``checkpoint/``);
  ``Trainer.resume()`` restores from the chain (direct access by default,
  or any method of ``store.materialize``, the kernel methods included)
  and continues from the recorded step. ``crash_after`` in ``run()``
  exercises the path under test.
* **straggler mitigation** — a per-step deadline (EWMA × tolerance);
  overruns are logged as straggler events and counted into goodput.
* **streaming policy** — the checkpointer compacts its chain past the
  provider threshold (paper §3), bounding restore cost and pool growth.

The state saved is ``dict(params=..., opt=..., step=int32 scalar)``; the
checkpointer lays its leaves out in JAX's pytree order, so the same state
gives the JAX trainer's chain word for word. Everything lives on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint.snapstore_ckpt import SnapshotCheckpointer
from repro_torch.data import pipeline as data_lib
from repro_torch.device import as_device
from repro_torch.models.api import LM
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    page_size: int = 2048
    straggler_tolerance: float = 3.0
    accum_steps: int = 1
    log_every: int = 10


class Trainer:
    def __init__(self, model: LM, opt_cfg: adamw.AdamWConfig,
                 data_cfg: data_lib.DataConfig, tcfg: TrainerConfig,
                 *, seed: int = 0, device="cuda"):
        """The parameters are drawn on ``device`` from
        ``torch.Generator(device).manual_seed(seed)`` (other numbers than
        the JAX trainer's ``PRNGKey(seed)`` draw: to start from JAX's state,
        set ``params`` and ``opt_state`` from
        ``convert.train_state_from_jax`` before the first step)."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = as_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = model.init(gen, device=self.device)
        self.opt_state = adamw.init(self.params)
        self.step = 0
        self._step_fn = make_train_step(model, opt_cfg,
                                        accum_steps=tcfg.accum_steps)
        self.ckpt = SnapshotCheckpointer(
            self._state(), page_size=tcfg.page_size, device=self.device
        )
        self.events: list[dict] = []
        self._ewma: Optional[float] = None
        self.straggler_steps = 0
        self.losses: list[float] = []

    def _state(self):
        return dict(params=self.params, opt=self.opt_state,
                    step=torch.tensor(self.step, dtype=torch.int32,
                                      device=self.device))

    def _batch(self, step: int):
        return data_lib.batch_at(self.data_cfg, step, device=self.device)

    def run(self, *, crash_after: Optional[int] = None) -> dict:
        t_useful = 0.0
        t_total0 = time.perf_counter()
        while self.step < self.tcfg.total_steps:
            t0 = time.perf_counter()
            batch = self._batch(self.step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])
            self.losses.append(loss)
            dt = time.perf_counter() - t0
            t_useful += dt
            # straggler watchdog: EWMA deadline
            if self._ewma is None:
                self._ewma = dt
            deadline = self._ewma * self.tcfg.straggler_tolerance
            if dt > deadline:
                self.straggler_steps += 1
                self.events.append(dict(kind="straggler", step=self.step,
                                        dt=dt, deadline=deadline))
            self._ewma = 0.9 * self._ewma + 0.1 * dt
            self.step += 1
            if self.step % self.tcfg.ckpt_every == 0:
                st = self.ckpt.save(self._state())
                self.events.append(dict(kind="ckpt", step=self.step, **st))
            if crash_after is not None and self.step >= crash_after:
                raise RuntimeError(f"simulated crash at step {self.step}")
        wall = time.perf_counter() - t_total0
        return dict(
            steps=self.step,
            final_loss=self.losses[-1] if self.losses else float("nan"),
            goodput=t_useful / max(wall, 1e-9),
            straggler_steps=self.straggler_steps,
            ckpt_chain_length=int(self.ckpt.chain.length),
        )

    def resume(self, *, method: str = "direct") -> int:
        """Restore the latest checkpoint from the chain; returns the step.

        The live state is dropped first; the restored leaves are views of
        the one restored page image (no copy)."""
        self.params = self.opt_state = None
        state = self.ckpt.restore(method=method)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = int(state["step"])
        return self.step
