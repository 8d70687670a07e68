"""Fault-tolerant checkpointing (port of ``repro.ckpt.manager``).

* **Atomic**: written to ``<dir>/tmp.<step>/`` then ``os.rename``d, so a
  crash mid-save never corrupts the latest checkpoint; restore scans for
  the newest COMMITTED step.
* **Keep-k**: older checkpoints are removed after a commit.
* **Async**: the device-to-host copy happens on the caller's thread,
  serialization on a background thread.
* **Portable**: arrays are saved as numpy (``arrays.npz``) with a manifest
  of leaf paths (``repro_torch.tree``); ``restore`` puts each leaf on the
  device and in the dtype of the caller's target tree.  bfloat16 leaves are
  stored as float32.  Resharding onto a mesh (``shardings=``) is not ported
  yet.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths

__all__ = ["CheckpointManager"]


def _to_host(v) -> np.ndarray:
    t = torch.as_tensor(v).detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False):
        paths, vals, _ = flatten_with_paths(tree)
        host_vals = [_to_host(v) for v in vals]  # device -> host now
        self.wait()  # one in-flight save at a time

        def _write():
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": v for i, v in enumerate(host_vals)})
            manifest = {"step": step, "paths": paths, "time": time.time()}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point
            self._gc()

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``target``: each leaf on the device
        and in the dtype of ``target``'s leaf."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) reshards onto a device mesh, which is not ported yet: "
                "ROADMAP Queue 1 item 12(b) (model sharding)"
            )
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        saved = {p: data[f"a{i}"] for i, p in enumerate(manifest["paths"])}

        paths, vals, rebuild = flatten_with_paths(target)
        out = []
        for p, v in zip(paths, vals):
            if p not in saved:
                raise KeyError(f"checkpoint missing leaf {p!r}")
            arr = saved[p]
            v = torch.as_tensor(v)
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {p}: {arr.shape} vs {tuple(v.shape)}")
            out.append(torch.as_tensor(arr).to(device=v.device, dtype=v.dtype))
        return rebuild(out)

    def restore_latest(self, target: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings)
