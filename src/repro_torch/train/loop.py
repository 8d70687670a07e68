"""Fault-tolerant training loop (port of ``repro.train.loop``).

Beyond calling the train step:

* auto-resume from the newest committed checkpoint (params + optimizer
  state + step; the data stream is indexed by step, so it replays exactly);
* periodic async checkpointing;
* NaN/inf guard: a non-finite loss drops the step, restores the last
  checkpoint and skips the offending data step;
* straggler monitor: an EWMA of the host-measured step time; steps slower
  than ``straggler_factor`` x the EWMA are logged.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

from repro_torch.ckpt import CheckpointManager

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    keep: int = 3
    straggler_factor: float = 2.0
    nan_recovery: bool = True


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,          # (params, opt_state, batch, step) -> (params, opt_state, metrics)
        batch_fn: Callable,         # step -> batch
        loop_cfg: TrainLoopConfig,
        log_fn: Callable = print,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = loop_cfg
        self.log = log_fn
        self.mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep) if loop_cfg.ckpt_dir else None
        self.step_times: list = []
        self.straggler_events: list = []

    def _restore(self, step: int, params, opt_state):
        restored = self.mgr.restore(step, {"params": params, "opt": opt_state})
        return restored["params"], restored["opt"]

    def run(self, params: Any, opt_state: Any, start_step: int = 0):
        cfg = self.cfg
        step = start_step

        # ---- auto-resume -------------------------------------------------
        if self.mgr is not None:
            latest = self.mgr.latest_step()
            if latest is not None and latest > start_step:
                params, opt_state = self._restore(latest, params, opt_state)
                step = latest
                self.log(f"[loop] resumed from checkpoint step {step}")

        ewma = None
        history = []
        while step < cfg.total_steps:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            new_params, new_opt, metrics = self.step_fn(params, opt_state, batch, step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)

            # ---- NaN guard -------------------------------------------
            if not math.isfinite(loss):
                self.log(f"[loop] step {step}: non-finite loss {loss!r}")
                if cfg.nan_recovery and self.mgr is not None:
                    latest = self.mgr.latest_step()
                    if latest is not None:
                        params, opt_state = self._restore(latest, params, opt_state)
                        self.log(f"[loop] rolled back to step {latest}, skipping data step {step}")
                        step += 1  # skip the poisonous batch
                        continue
                raise FloatingPointError(f"non-finite loss at step {step}")

            params, opt_state = new_params, new_opt
            step += 1
            history.append(loss)

            # ---- straggler monitor -----------------------------------
            if ewma is None:
                ewma = dt
            else:
                if dt > cfg.straggler_factor * ewma:
                    self.straggler_events.append((step, dt, ewma))
                    self.log(f"[loop] straggler: step {step} took {dt*1e3:.0f} ms (ewma {ewma*1e3:.0f} ms)")
                ewma = 0.9 * ewma + 0.1 * dt

            if step % cfg.log_every == 0:
                self.log(f"[loop] step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms/step)")
            if self.mgr is not None and step % cfg.ckpt_every == 0:
                self.mgr.save(step, {"params": params, "opt": opt_state})

        if self.mgr is not None:
            self.mgr.save(cfg.total_steps, {"params": params, "opt": opt_state}, blocking=True)
            self.mgr.wait()
        return params, opt_state, history
