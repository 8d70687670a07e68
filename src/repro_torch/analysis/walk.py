"""What one step does on the device, counted op by op (the port's
counterpart of ``repro.analysis.hlo_walk``).

The JAX package compiles its step and walks the post-SPMD HLO, resolving
while-loop trip counts.  The port has no HLO: eager PyTorch runs every op
through the dispatcher, so :class:`StepWalk` (a ``TorchDispatchMode``)
counts them as they run, on real tensors or on fake ones
(``torch._subclasses.fake_tensor.FakeTensorMode``, which the dry-run uses).
Python loops run, so there are no trip counts to resolve.

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmul, bmm, baddbmm,
  the products that einsum lowers to, convolutions, attention), op by op
  as ``FlopCounterMode`` counts them, decomposing an op without a formula
  as it does, so the two agree exactly on the same step.  They include
  every recomputation the step really runs: checkpointed units in the
  backward (``remat``) and flash attention's recomputing backward.
* HBM bytes: input plus output bytes of every op that is not a view (eager
  PyTorch fuses nothing, so each op reads its inputs and writes its
  outputs: the counterpart of JAX's CPU-fusion ``hbm_bytes``).  An
  indexed write (``index_copy_``, ``index_put_``, ``index_add_``,
  ``scatter_``) counts twice its source, the slice it reads and writes,
  as the HLO walk counts a ``dynamic-update-slice``.  Allocations
  (``empty``) and collectives (``c10d``; their bytes are the collective
  term, ``repro_torch.parallel.comm``) count none.
* Peak live bytes: the most bytes held at once by storages that the step's
  ops created (its inputs not included), each freed when its last tensor
  goes, saved activations included.
* ``top``: the largest contributors by bytes and by FLOPs, each an op and
  its operands' shapes.

:func:`analyze_step` runs a function under the walk.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["StepWalk", "analyze_step"]

_aten = torch.ops.aten
# Metadata queries, as FlopCounterMode skips them.
_QUERIES = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default, _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default, _aten.storage_offset.default,
    _aten.sym_storage_offset.default, _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default,
} - {None}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh"}
_INDEXED_WRITES = {"index_copy", "index_copy_", "index_put", "index_put_", "_index_put_impl_", "index_add",
                   "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_", "slice_scatter",
                   "select_scatter"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepWalk(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and peak live bytes of the ops run under it
    (module docstring); ``top`` > 0 keeps the contributors."""

    def __init__(self, top: int = 0):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.top = top
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._held = set()
        self.contrib = defaultdict(lambda: {"bytes": 0, "flops": 0, "count": 0})

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._held:
            return
        st = _storage(t)
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if func._overloadpacket not in self.registry and func is not torch.ops.prim.device.default:
            with self:  # an op without a formula: its decomposition, as FlopCounterMode does
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins}
        for t in outs:
            if _key(t) not in in_keys:
                self._track(t)
        if func.namespace != "aten":
            return out
        name = func._schema.name.split("::")[-1]
        mutates = any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)
        flops = 0
        if func._overloadpacket in self.registry:
            flops = int(self.registry[func._overloadpacket](*args, **kwargs, out_val=out))
        if name in _ALLOC:
            nbytes = 0
        elif name in _INDEXED_WRITES:
            nbytes = 2 * sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
        elif not mutates and outs and all(_key(t) in in_keys for t in outs):
            nbytes = 0  # a view
        elif mutates:  # a mutated input is written, counted once among the outputs
            written = {_key(t) for t in outs}
            nbytes = sum(_nbytes(t) for t in ins if _key(t) not in written) + sum(_nbytes(t) for t in outs)
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.ops += 1
        self.flops += flops
        self.hbm_bytes += nbytes
        if self.top and (nbytes or flops):
            shapes = "x".join(str(tuple(t.shape)) for t in ins[:3])
            c = self.contrib[f"{func._overloadpacket}|{shapes}"]
            c["bytes"] += nbytes
            c["flops"] += flops
            c["count"] += 1
        return out

    def record(self) -> Dict:
        rec = {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "peak_live_bytes": self.peak,
            "ops": self.ops,
            "flops_note": "every recomputation the step runs is counted (remat, flash attention's backward)",
        }
        if self.top:
            items = list(self.contrib.items())
            rec["top_bytes"] = [{"tag": k, **v} for k, v in sorted(items, key=lambda kv: -kv[1]["bytes"])[:self.top]]
            rec["top_flops"] = [{"tag": k, "flops": v["flops"], "count": v["count"]}
                                for k, v in sorted(items, key=lambda kv: -kv[1]["flops"])[:self.top] if v["flops"]]
        return rec


def analyze_step(fn: Callable, *args, top: int = 0) -> Tuple[object, Dict]:
    """``(fn(*args), record)``: ``fn`` run under a :class:`StepWalk`
    (``record``: ``flops``, ``hbm_bytes``, ``peak_live_bytes``, ``ops``
    and, with ``top``, ``top_bytes`` / ``top_flops``).  Run it inside a
    ``FakeTensorMode`` on fake inputs to count without computing."""
    walk = StepWalk(top)
    with walk:
        out = fn(*args)
    return out, walk.record()
