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
  stored as float32.
* **Sharded**: a ``DTensor`` leaf (a rank's block, ``parallel.shard_params``)
  is gathered whole (``comm.full_tensor``) by every rank, and rank 0 alone
  writes.  ``restore`` loads each whole array and returns this rank's block
  as a ``DTensor``, per ``shardings=`` (``policy.param_shardings(meta)``,
  a tree like the target's or like its ``"params"`` subtree) or per the
  target leaf's own placements; so a run saved on one mesh restores on
  another, or in one process.
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


def _spec(v):
    """A DTensor's placements as a spec: per tensor dim, the mesh axes that
    split it, in mesh order."""
    from torch.distributed.tensor import Shard

    names = v.device_mesh.mesh_dim_names
    entries = [()] * v.ndim
    for i, pl in enumerate(v.placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (names[i],)
    return tuple(e[0] if len(e) == 1 else (e or None) for e in entries)


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_host(v) -> np.ndarray:
    if _is_dtensor(v):
        from repro_torch.parallel.comm import full_tensor

        v = full_tensor(v)
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
        host_vals = [_to_host(v) for v in vals]  # device -> host now (sharded leaves gathered)
        self.wait()  # one in-flight save at a time
        if _rank() != 0:  # every rank gathers, rank 0 writes
            return

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
        and in the dtype of ``target``'s leaf.  With ``shardings`` (a tree
        of ``parallel.NamedSharding`` like ``target``, or like its
        ``"params"`` subtree) a leaf becomes this rank's block of the whole
        saved array, in a ``DTensor``; a ``DTensor`` leaf of ``target`` is
        cut by its own placements."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        saved = {p: data[f"a{i}"] for i, p in enumerate(manifest["paths"])}

        paths, vals, rebuild = flatten_with_paths(target)
        shard_of = {}
        if shardings is not None:
            sub = isinstance(target, dict) and "params" in target and not (
                isinstance(shardings, dict) and "params" in shardings)
            sp, shs, _ = flatten_with_paths({"params": shardings} if sub else shardings)
            shard_of = dict(zip(sp, shs))
        out = []
        for p, v in zip(paths, vals):
            if p not in saved:
                raise KeyError(f"checkpoint missing leaf {p!r}")
            arr = saved[p]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {p}: {arr.shape} vs {tuple(v.shape)}")
            sh = shard_of.get(p)
            if sh is None and _is_dtensor(v):
                from repro_torch.parallel.sharding import NamedSharding

                sh = NamedSharding(v.device_mesh, _spec(v))
            local = v.to_local() if _is_dtensor(v) else torch.as_tensor(v)
            whole = torch.as_tensor(arr).to(device=local.device, dtype=local.dtype)
            if sh is None:
                out.append(whole)
                continue
            from torch.distributed.tensor import DTensor

            out.append(DTensor.from_local(sh.shard(whole, p), sh.mesh, sh.placements, run_check=False,
                                          shape=whole.shape, stride=whole.stride()))
        return rebuild(out)

    def restore_latest(self, target: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings)
