"""Activation-sharding hints decoupled from model code (port of
``repro.parallel.hints``).

Model layers call ``shard_hint(x, logical_axes)`` with *logical* names
(``"act_batch"``, ``"act_heads"``, ``"act_res_seq"``, None per dim).  A
launcher or the sharded train step installs a resolver that maps logical
names to mesh axes; with no resolver installed (unit tests, one process)
every hint is the identity.

The JAX package's hint is a sharding constraint and GSPMD derives the
collectives.  PyTorch has no GSPMD, so here a tensor is always *this
rank's block* and a hint is where its layout changes, by the collectives of
``repro_torch.parallel.comm``.  What the hint cannot see, the call site
says:

* ``partial=name``: ``x`` is a partial sum over the mesh axes of ``name``
  (a row-split matmul's output).  It is summed (``comm.all_reduce``), or
  reduce-scattered along the dim whose name maps to the same axes (the
  residual sequence under sequence parallelism).
* ``src=axes``: ``x`` is laid out as ``src`` says, not as the target does.
  Dims that the target splits and ``src`` does not are split
  (``comm.split``); dims that ``src`` splits and the target does not are
  gathered (``comm.all_gather``, the backward keeping the own rows).
* neither: ``x`` already has the target's layout (it was computed from
  local shards); the hint states it and moves nothing.

A hint whose names do not match ``x``'s rank is skipped, as JAX skips it,
when it only states a layout; with ``partial`` or ``src`` it raises
``ValueError``, since skipping it would change the value.

Three more entry points carry what GSPMD would infer at a tensor-parallel
region's edge: :func:`tp_input` (the region's input, whole over the
region's axes, its gradient summed over them: Megatron's *f*, or the
sequence all-gather under sequence parallelism), :func:`shared_param`
(a parameter replicated over the axes that split its work, its gradient
summed over them) and :func:`tp_sum` (a statistic summed over the region's
ranks and used again by each rank's part: a sum in the forward and in the
backward, as a norm over a split width needs).

The resolver is thread-local, as in the JAX package.  PyTorch runs a
backward (and a checkpoint's recomputation) on its own threads, so a
function that recomputes under ``torch.utils.checkpoint`` is wrapped with
:func:`bind`, which re-installs the resolver that was active when it was
wrapped.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import comm

__all__ = ["shard_hint", "hint_resolver", "make_mesh_resolver", "active_resolver", "MeshResolver",
           "tp_input", "shared_param", "tp_sum", "bind"]

_state = threading.local()


def active_resolver():
    """The resolver installed on this thread, or None."""
    return getattr(_state, "resolver", None)


@contextlib.contextmanager
def hint_resolver(fn: Optional[Callable]):
    """Install a resolver: ``fn(x, logical_axes, partial=, src=) -> x``.
    Thread-local, re-entrant."""
    prev = active_resolver()
    _state.resolver = fn
    try:
        yield
    finally:
        _state.resolver = prev


def shard_hint(x: torch.Tensor, logical_axes: Sequence[Optional[str]], *, partial: Optional[str] = None,
               src: Optional[Sequence[Optional[str]]] = None) -> torch.Tensor:
    fn = active_resolver()
    if fn is None:
        return x
    return fn(x, tuple(logical_axes), partial=partial, src=None if src is None else tuple(src))


def bind(fn: Callable) -> Callable:
    """``fn`` run under the resolver active now, on whatever thread calls it."""
    res = active_resolver()

    def bound(*args, **kwargs):
        with hint_resolver(res):
            return fn(*args, **kwargs)

    return bound


def _names(r) -> Tuple[str, ...]:
    return r if isinstance(r, tuple) else ((r,) if r else ())


class MeshResolver:
    """The standard resolver: logical name -> mesh axis (or tuple) via
    ``rules``; unknown names replicate.  Within one hint, a mesh axis that an
    earlier dim already uses is dropped (PartitionSpec uniqueness).

    ``param_specs`` (set by the sharded train step, :meth:`with_params`)
    is the model's tree of parameter specs: the forward reads it to gather
    the parameters' FSDP shards (:meth:`gather_params`)."""

    def __init__(self, mesh, rules: Dict[str, object], param_specs=None):
        self.mesh = mesh
        self.rules = dict(rules)
        self.param_specs = param_specs

    def with_params(self, param_specs) -> "MeshResolver":
        return MeshResolver(self.mesh, self.rules, param_specs)

    def for_decode(self) -> "MeshResolver":
        """The rules of one-token decode: the residual stream is whole (a
        sequence of one is not split), and a cache whose KV heads the
        policy does not split has its window split on ``model`` instead
        (``act_cache_window``, as ``launch.cache_specs`` lays it out).
        Raises ``ValueError`` where the batch axes take the model axis
        (``pure_dp``): the caches split the mixers' heads over it."""
        names = tuple(self.mesh.mesh_dim_names)
        if "model" in names and "model" in self.batch_axes():
            raise ValueError("sharded decode needs a policy whose batch axes leave out 'model' (pure_dp=False): "
                             "the caches split heads, channels and windows over it")
        win = "model" if "model" in names and self.rules.get("act_kv_heads") is None else None
        return MeshResolver(self.mesh, dict(self.rules, act_res_seq=None, act_cache_window=win), self.param_specs)

    # ---- lookups
    def axes(self, name: Optional[str]) -> Tuple[str, ...]:
        """The mesh axes of logical ``name``, leaving out axes of size 1."""
        names = _names(self.rules.get(name)) if name else ()
        return tuple(a for a in names if self.mesh.size(self._dim(a)) > 1)

    def _dim(self, axis: str) -> int:
        return self.mesh.mesh_dim_names.index(axis)

    def size(self, name_or_axes) -> int:
        axes = self.axes(name_or_axes) if isinstance(name_or_axes, str) or name_or_axes is None \
            else tuple(name_or_axes)
        n = 1
        for a in axes:
            n *= self.mesh.size(self._dim(a))
        return n

    def index(self, name_or_axes) -> int:
        axes = self.axes(name_or_axes) if isinstance(name_or_axes, str) or name_or_axes is None \
            else tuple(name_or_axes)
        return comm.axes_group(self.mesh, axes)[1] if axes else 0

    def layout(self, logical_axes: Sequence[Optional[str]]) -> Tuple[Tuple[str, ...], ...]:
        """Per dim, the mesh axes a hint's dims map to (repeats dropped)."""
        seen, out = set(), []
        for name in logical_axes:
            keep = tuple(a for a in self.axes(name) if a not in seen)
            seen.update(keep)
            out.append(keep)
        return tuple(out)

    # ---- the hint
    def __call__(self, x: torch.Tensor, logical_axes, *, partial=None, src=None) -> torch.Tensor:
        if len(logical_axes) != x.ndim:
            if partial is not None or src is not None:
                raise ValueError(f"hint {tuple(logical_axes)} (partial={partial!r}, src={src!r}) "
                                 f"does not match a tensor of rank {x.ndim}")
            return x  # a layout-only hint, as JAX skips it
        dst = self.layout(logical_axes)
        if partial is not None:
            axes = self.axes(partial)
            if not axes:
                return x
            dims = [d for d, a in enumerate(dst) if a == axes]
            if dims:
                return comm.reduce_scatter(x, self.mesh, axes, dims[0])
            if any(set(a) & set(axes) for a in dst):
                raise ValueError(f"a partial sum over {axes} cannot land on the layout {dst}")
            return comm.all_reduce(x, self.mesh, axes)
        if src is None:
            return x
        have = self.layout(src)
        for d, (a, b) in enumerate(zip(have, dst)):
            if a == b or "act_batch" in (src[d], logical_axes[d]):
                continue
            if a:
                x = comm.all_gather(x, self.mesh, a, d, grad="slice")
            if b:
                x = comm.split(x, self.mesh, b, d)
        return x

    # ---- region edges
    def tp_input(self, x: torch.Tensor, logical_axes, work: Optional[str]) -> torch.Tensor:
        """``x``, laid out as ``logical_axes``, made whole over every
        non-batch dim for work split over ``work``'s axes."""
        axes = self.axes(work)
        layout = self.layout(logical_axes)
        summed = False
        for d, a in enumerate(layout):
            if not a or logical_axes[d] == "act_batch":
                continue
            if a == axes and not summed:  # sequence parallelism: all-gather, reduce-scatter back
                x = comm.all_gather(x, self.mesh, a, d, grad="sum")
                summed = True
            else:
                x = comm.all_gather(x, self.mesh, a, d, grad="slice")
        if axes and not summed:
            x = comm.copy_to(x, self.mesh, axes)
        return x

    def shared_param(self, p, work: Optional[str]):
        axes = self.axes(work)
        if not axes:
            return p
        from repro_torch.tree import tree_map

        return tree_map(lambda t: comm.copy_to(t, self.mesh, axes), p)

    # ---- parameters
    def batch_axes(self) -> Tuple[str, ...]:
        return self.axes("act_batch")

    def local_spec(self, spec):
        """``spec`` without the batch axes: the layout of a leaf whose FSDP
        dims are gathered."""
        from repro_torch.models.params import PartitionSpec

        batch = set(self.batch_axes())
        out = []
        for entry in spec:
            keep = tuple(a for a in _names(entry) if a not in batch)
            out.append(keep[0] if len(keep) == 1 else (keep or None))
        return PartitionSpec(*out)

    def gather_params(self, tree, specs):
        """``tree`` (this rank's shards) with every dim that the batch axes
        split (FSDP) gathered; dims on other axes (tensor parallelism) stay
        local.  The backward reduce-scatters the gradients."""
        if specs is None:
            return tree
        from repro_torch.tree import leaves, tree_map

        batch = set(self.batch_axes())
        spec_leaves = leaves(specs)

        def gather(t, spec):
            for d, entry in enumerate(spec):
                axes = tuple(a for a in _names(entry) if self.mesh.size(self._dim(a)) > 1)
                if not axes:
                    continue
                if set(axes) <= batch:
                    t = comm.all_gather(t, self.mesh, axes, d, grad="sum", tags=("param", "grad"))
                elif set(axes) & batch:
                    raise ValueError(f"a parameter dim split over {axes} mixes batch and model axes")
            return t

        it = iter(spec_leaves)
        return tree_map(lambda t: gather(t, next(it)), tree)


def make_mesh_resolver(mesh, rules: dict) -> MeshResolver:
    """Standard resolver: logical name -> mesh axis (or tuple) via ``rules``."""
    return MeshResolver(mesh, rules)


def tp_input(x: torch.Tensor, logical_axes: Sequence[Optional[str]], work: Optional[str]) -> torch.Tensor:
    """``x`` (laid out as ``logical_axes``, e.g. the residual stream)
    entering work split over the mesh axes of ``work``: gathered whole over
    its non-batch dims, and its gradient summed over ``work``'s axes (an
    all-gather with a reduce-scatter backward where ``x`` is split on those
    axes, else Megatron's *f*).  The identity without a resolver."""
    res = active_resolver()
    if res is None:
        return x
    return res.tp_input(x, tuple(logical_axes), work)


def tp_sum(x: torch.Tensor, work: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` (each rank's part of a statistic of the whole) over
    the mesh axes of ``work``, for rank-local work to use: an all-reduce,
    and in the backward the gradient summed over the same axes (Megatron's
    *g* then *f*).  The identity without a resolver or without those axes."""
    res = active_resolver()
    axes = res.axes(work) if res is not None else ()
    if not axes:
        return x
    return comm.copy_to(comm.all_reduce(x, res.mesh, axes), res.mesh, axes)


def shared_param(p, work: Optional[str]):
    """``p`` (a tensor or a tree), replicated over the mesh axes of ``work``
    while each rank does its part of the work with it: the gradient is
    summed over those axes.  The identity without a resolver."""
    res = active_resolver()
    if res is None:
        return p
    return res.shared_param(p, work)
