"""Fault-tolerant training runtime.

The port of ``repro.runtime.trainer``:

* **Checkpoint/restart** — atomic checkpoints every N steps; restart
  resumes bitwise (the data stream is deterministic per (seed, step), and
  the train step uses only deterministic operations on the card: the
  embedding backward is ``F.embedding``'s sorted segment sum, not an
  atomic ``index_put_``).
* **Failure injection** — a hook raising mid-run lets tests kill step K and
  assert the restarted run converges to the identical state.
* **Straggler mitigation** — per-step deadline derived from a running median;
  a step exceeding ``straggler_factor`` x median is recorded and the
  mitigation hook fires.
* **Re-placement** — ``reshard_for`` moves a restored state leaf by leaf
  onto other devices, so training continues after membership changes.

Batches stay numpy until the step: each is moved to the device of the
state's first leaf (in the reference's leaf order) inside the timed region.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    min_history: int = 8


class Trainer:
    def __init__(self, step_fn: Callable, init_state, data_stream_fn: Callable[[int], Iterator],
                 cfg: TrainerConfig, *,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[int, float], None]] = None):
        """step_fn(state, batch) -> (state, metrics). data_stream_fn(start_step)
        must be deterministic in step (resume-safe)."""
        self.step_fn = step_fn
        self.state = init_state
        self.cfg = cfg
        self.data_stream_fn = data_stream_fn
        self.failure_hook = failure_hook
        self.straggler_hook = straggler_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.step_times = []
        self.stragglers = []
        self.metrics_log = []

    # -- fault tolerance -------------------------------------------------------

    def try_restore(self) -> int:
        restored, step = self.ckpt.restore(self.state)
        if restored is not None:
            self.state = restored
            return int(step)
        return 0

    def reshard_for(self, devices):
        """Elastic restart: move the state onto ``devices``, a matching tree
        of ``torch.device``s (the reference's ``state_shardings``)."""
        self.state = tree_map(lambda x, d: x.to(d), self.state, devices)
        return self.state

    # -- loop -------------------------------------------------------------------

    def run(self, *, resume: bool = True) -> dict:
        start = self.try_restore() if resume else 0
        stream = self.data_stream_fn(start)
        step = start
        for step in range(start, self.cfg.total_steps):
            batch = next(stream)
            if self.failure_hook is not None:
                self.failure_hook(step)  # may raise to simulate a node loss
            t0 = time.perf_counter()
            dev = leaves(self.state)[0].device
            batch = tree_map(lambda x: torch.as_tensor(x).to(dev), batch)
            self.state, metrics = self.step_fn(self.state, batch)
            logged = {k: float(v) for k, v in metrics.items()}   # waits for the step
            dt = time.perf_counter() - t0
            self._track_step(step, dt)
            self.metrics_log.append({"step": step, **logged})
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(self.state, step + 1)
        if (step + 1) % self.cfg.ckpt_every:
            self.ckpt.save(self.state, step + 1)
        return {"final_step": step + 1, "stragglers": self.stragglers,
                "metrics": self.metrics_log}

    def _track_step(self, step: int, dt: float):
        hist = self.step_times
        if len(hist) >= self.cfg.min_history:
            med = statistics.median(hist[-64:])
            if dt > self.cfg.straggler_factor * med:
                self.stragglers.append((step, dt, med))
                if self.straggler_hook is not None:
                    self.straggler_hook(step, dt / med)
        hist.append(dt)
