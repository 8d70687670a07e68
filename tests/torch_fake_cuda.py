"""A test seam: fake CUDA tensors on a CPU-only torch.

``FakeTensorMode`` makes CUDA tensors without a card, and the dispatcher
runs ops on them, but Python indexing (``Tensor.__getitem__`` /
``__setitem__``) takes a CUDA device guard first, which a CPU-only build
lacks ("PyTorch is not linked with support for cuda devices").
:class:`FakeCudaIndexing` (a ``TorchFunctionMode``) indexes fake CUDA
tensors through the aten ops that indexing lowers to (``select``,
``slice``, ``unsqueeze``, ``index``, ``index_put_``, ``copy_``), as
PyTorch's own indexing does: integers select first, then the integer
tensors index the dims they stand at; a Tensor method whose binding takes
the guard too runs as the aten op of its name.  :func:`card_probe` makes
``repro_torch.backend.probe`` accept the CUDA device.  Neither is a path
of the package; on the card neither is needed.
"""
import contextlib

import torch
from torch.overrides import TorchFunctionMode

aten = torch.ops.aten


def _basic(t, idx):
    """``(view, advanced)``: ``t`` indexed by the ints, slices and Nones of
    ``idx``, and the integer tensors of ``idx`` by the dim of the view they
    index."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = tuple(torch.as_tensor(i, device=t.device) if isinstance(i, list) else i for i in idx)
    used = sum(1 for i in idx if i is not None and i is not Ellipsis)
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        idx = idx[:k] + (slice(None),) * (t.dim() - used) + idx[k + 1:]
    idx = idx + (slice(None),) * (t.dim() - sum(1 for i in idx if i is not None))
    out, dim, adv = t, 0, {}
    for i in idx:
        if i is None:
            out = aten.unsqueeze.default(out, dim)
            dim += 1
        elif isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                raise NotImplementedError("boolean masks have data-dependent shapes")
            adv[dim] = i
            dim += 1
        elif isinstance(i, slice):
            out = aten.slice.Tensor(out, dim, i.start, i.stop, 1 if i.step is None else i.step)
            dim += 1
        else:
            out = aten.select.int(out, dim, int(i))
    return out, adv


def _indices(adv):
    return [adv.get(d) for d in range(max(adv) + 1)]


class FakeCudaIndexing(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) and args[0].is_cuda:
            view, adv = _basic(args[0], args[1])
            if func is torch.Tensor.__getitem__:
                return aten.index.Tensor(view, _indices(adv)) if adv else view
            value = args[2]
            if not isinstance(value, torch.Tensor):
                value = torch.full((), value, dtype=view.dtype, device=view.device)
            if adv:
                aten.index_put_.default(view, _indices(adv), value)
            else:
                aten.copy_.default(view, value)
            return None
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:  # a Tensor method's binding took the device guard
            op = getattr(aten, getattr(func, "__name__", ""), None)
            if "not linked with support for cuda" not in str(e) or op is None:
                raise
            return op(*args, **kwargs)


@contextlib.contextmanager
def card_probe():
    """``probe.resolve_device`` / ``require_hopper`` as on an H100."""
    from repro_torch.backend import probe

    saved = probe.resolve_device, probe.require_hopper

    def resolve(device=None):
        dev = torch.device("cuda" if device is None else device)
        return torch.device("cuda", 0) if dev.type == "cuda" else saved[0](dev)

    probe.resolve_device, probe.require_hopper = resolve, lambda device: None
    try:
        yield
    finally:
        probe.resolve_device, probe.require_hopper = saved
