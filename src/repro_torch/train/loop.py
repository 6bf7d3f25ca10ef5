"""The train loop: checkpoint / restart, straggler watchdog, metrics log
(the reference's ``repro.train.loop``).

Host-side orchestration around a train step ``(state, batch) -> (state,
metrics)``:

* auto-resume from the newest *valid* checkpoint (crash recovery);
* periodic async checkpoints;
* straggler watchdog: per-step wall time tracked with an EWMA; a step slower
  than ``straggler_factor`` x the EWMA is recorded;
* a metrics log (jsonl).

A step's wall time includes waiting for the device: the timed span ends
after the step's metrics are read back (``float`` of each 0-d tensor waits
for the step's device work), the reference's ``jax.block_until_ready``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from ..checkpoint.checkpointer import Checkpointer


@dataclass
class WatchdogStats:
    ewma_s: float = 0.0
    n_steps: int = 0
    stragglers: list[int] = field(default_factory=list)

    def update(self, step: int, dt: float, factor: float = 3.0) -> bool:
        is_straggler = self.n_steps > 5 and dt > factor * self.ewma_s
        alpha = 0.1
        self.ewma_s = dt if self.n_steps == 0 else (1 - alpha) * self.ewma_s + alpha * dt
        self.n_steps += 1
        if is_straggler:
            self.stragglers.append(step)
        return is_straggler


def _host(metrics: dict) -> dict:
    """The metrics as Python floats (waits for the device)."""
    return {k: float(v.item() if isinstance(v, torch.Tensor) else v) for k, v in metrics.items()}


@dataclass
class TrainLoop:
    train_step: Callable  # (state, batch) -> (state, metrics)
    data_iter: Iterator[dict]
    checkpointer: Checkpointer | None = None
    ckpt_every: int = 100
    log_path: str | None = None
    straggler_factor: float = 3.0

    def run(self, state, n_steps: int, start_step: int = 0) -> tuple[Any, list[dict]]:
        watchdog = WatchdogStats()
        logs: list[dict] = []
        logf = open(self.log_path, "a") if self.log_path else None
        step = start_step
        try:
            for _ in range(n_steps):
                batch = next(self.data_iter)
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                values = _host(metrics)  # waits for the step's device work
                dt = time.perf_counter() - t0
                slow = watchdog.update(step, dt, self.straggler_factor)
                rec = {"step": step, "dt_s": round(dt, 4), "straggler": slow}
                rec.update(values)
                logs.append(rec)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                step += 1
                if self.checkpointer and step % self.ckpt_every == 0:
                    self.checkpointer.save(step, state)
        finally:
            if self.checkpointer:
                self.checkpointer.wait()
            if logf:
                logf.close()
        return state, logs

    @staticmethod
    def resume_or_init(checkpointer: Checkpointer | None, state):
        """Crash recovery: the newest valid checkpoint, else the fresh state."""
        if checkpointer is None:
            return state, 0
        try:
            return checkpointer.restore_latest_valid(state)
        except FileNotFoundError:
            return state, 0
