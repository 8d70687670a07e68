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
  (``empty``), host reads of a value (``_local_scalar_dense``) and
  collectives (``c10d``, and what their backend runs inside them,
  ``trace.collective``; their bytes are the collective term,
  ``repro_torch.parallel.comm``) count none.
* Peak live bytes: the most bytes held at once by storages that the step's
  ops created (its inputs not included), each freed when its last tensor
  goes, saved activations included.
* The port's own operators (``repro_torch::``, kernels A–E:
  ``repro_torch.kernels.library``; ``trace.NAMESPACE``) count as aten
  ops do: FLOPs by their registered work formula (``kernels/work.py``),
  bytes each input read once and each output written once, a mutated
  input once; ``operators`` keeps each one's calls, FLOPs and bytes.
* ``data_dependent``: each loop whose trips depend on values
  (``repro_torch.backend.trace.data_dependent``), by its place in the
  code: how often it was entered, the trips it ran, the FLOPs and HBM
  bytes of the ops run inside it (innermost loop only), and what it runs
  on fake tensors; the counterpart of the JAX walk's
  ``unknown_trip_whiles``.  Its FLOPs and bytes are part of ``flops`` and
  ``hbm_bytes``; ``flops_outside_loops`` and ``hbm_bytes_outside_loops``
  are the rest, which a fake step and the same step run for real count
  alike (``launch.dryrun.count_cell`` walks the real step too).
* On fake tensors a loop of identical trips runs one trip
  (``trace.repeated``, ``trace.map_lanes``), counted once a trip: every
  count above is the full loop's.  Peak live bytes hold a per-lane result
  once a lane; within a trip they see one trip's temporaries.
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

from repro_torch.backend import trace

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
# A host read of a value: a scalar copied to the host, no pass over HBM.
_HOST_READS = {"_local_scalar_dense"}
_INDEXED_WRITES = {"index_copy", "index_copy_", "index_put", "index_put_", "_index_put_impl_", "index_add",
                   "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_", "slice_scatter",
                   "select_scatter"}


def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


_DECOMPOSES: Dict = {}


def _decomposes(func) -> bool:
    """Whether ``func.decompose`` has a decomposition to run (cached: the
    walk asks once an op)."""
    d = _DECOMPOSES.get(func)
    if d is None:
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        d = _DECOMPOSES[func] = key in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), key)
    return d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _enter_loop(loops: Dict[str, Dict], site: str, fake: str) -> None:
    rec = loops.setdefault(site, {"site": site, "entries": 0, "trips": 0, "flops": 0, "bytes": 0, "on_fake": fake})
    rec["entries"] += 1


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
        self.operators = defaultdict(lambda: {"count": 0, "flops": 0, "bytes": 0})
        self.loops: Dict[str, Dict] = {}
        self._open = []
        self._depth = 0
        self._mult = 1
        self._sizes: Dict[int, int] = {}
        self._holds = []
        self._muted = 0

    def __enter__(self):
        if not self._depth:
            trace.listeners.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            trace.listeners.remove(self)
        return super().__exit__(*exc)

    def loop_enter(self, site: str, fake: str) -> None:
        _enter_loop(self.loops, site, fake)
        self._open.append(site)

    def loop_trip(self, site: str) -> None:
        self.loops[site]["trips"] += self._mult

    def scale(self, n: int, hold: bool = False) -> None:
        """From here on count each op ``n`` times more (``trace.repeated``,
        ``trace.map_lanes``); with ``hold``, the storages made until
        :meth:`unscale` that are alive then are held ``n`` times."""
        self._mult *= n
        if hold:
            self._holds.append(set())

    def unscale(self, n: int, hold: bool = False) -> None:
        self._mult //= n
        if hold:
            for key in self._holds.pop():
                if key in self._held:
                    extra = (n - 1) * self._sizes[key]
                    self._sizes[key] += extra
                    self.live += extra
            self.peak = max(self.peak, self.live)

    def loop_exit(self, site: str) -> None:
        self._open.pop()

    def mute(self, d: int) -> None:
        """Count nothing while muted (``trace.collective``: a collective's
        own ops)."""
        self._muted += d

    def _free(self, key: int) -> None:
        self._held.discard(key)
        self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._held:
            return
        st = _storage(t)
        n = st.nbytes()
        self._held.add(key)
        self._sizes[key] = n
        for hold in self._holds:
            hold.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if self._muted:
            return func(*args, **kwargs)
        if func._overloadpacket not in self.registry and func is not torch.ops.prim.device.default \
                and _decomposes(func):
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
        if func.namespace not in ("aten", trace.NAMESPACE):
            return out
        name = func._schema.name.split("::")[-1]
        mutates = any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)
        flops = 0
        if func._overloadpacket in self.registry:
            flops = int(self.registry[func._overloadpacket](*args, **kwargs, out_val=out))
        if name in _ALLOC or name in _HOST_READS:
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
        flops *= self._mult
        nbytes *= self._mult
        self.ops += self._mult
        self.flops += flops
        self.hbm_bytes += nbytes
        if self._open:
            self.loops[self._open[-1]]["flops"] += flops
            self.loops[self._open[-1]]["bytes"] += nbytes
        if func.namespace == trace.NAMESPACE:
            op = self.operators[name]
            op["count"] += self._mult
            op["flops"] += flops
            op["bytes"] += nbytes
        if self.top and (nbytes or flops):
            shapes = "x".join(str(tuple(t.shape)) for t in ins[:3])
            c = self.contrib[f"{func._overloadpacket}|{shapes}"]
            c["bytes"] += nbytes
            c["flops"] += flops
            c["count"] += self._mult
        return out

    def record(self) -> Dict:
        rec = {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "peak_live_bytes": self.peak,
            "ops": self.ops,
            "flops_note": "every recomputation the step runs is counted (remat, flash attention's backward)",
            "operators": {k: dict(v) for k, v in sorted(self.operators.items())},
            "data_dependent": [dict(v) for _, v in sorted(self.loops.items())],
            "flops_outside_loops": self.flops - sum(v["flops"] for v in self.loops.values()),
            "hbm_bytes_outside_loops": self.hbm_bytes - sum(v["bytes"] for v in self.loops.values()),
        }
        if self.top:
            items = list(self.contrib.items())
            rec["top_bytes"] = [{"tag": k, **v} for k, v in sorted(items, key=lambda kv: -kv[1]["bytes"])[:self.top]]
            rec["top_flops"] = [{"tag": k, "flops": v["flops"], "count": v["count"]}
                                for k, v in sorted(items, key=lambda kv: -kv[1]["flops"])[:self.top] if v["flops"]]
        return rec


def analyze_step(fn: Callable, *args, top: int = 0) -> Tuple[object, Dict]:
    """``(fn(*args), record)``: ``fn`` run under a :class:`StepWalk`
    (``record``: ``flops``, ``hbm_bytes``, ``peak_live_bytes``, ``ops``,
    ``operators``, ``data_dependent``, ``flops_outside_loops``,
    ``hbm_bytes_outside_loops`` and, with ``top``, ``top_bytes`` /
    ``top_flops``).  Run it inside a
    ``FakeTensorMode`` on fake inputs to count without computing."""
    walk = StepWalk(top)
    with walk:
        out = fn(*args)
    return out, walk.record()
