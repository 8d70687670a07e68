"""Port parity: the step analysis and the dry-run's tables
(``repro_torch.analysis``, ``repro_torch.launch.{specs,cache_specs}``), CPU.

The counterparts of tests/test_analysis.py and tests/test_perf_features.py's
walker tests: the walk counts a loop of products exactly (Python loops run,
so there is no trip count to resolve), a gradient's products, HBM bytes and
its top contributors; and, against the JAX package exactly, the roofline's
record keys, ``model_flops`` for every arch and shape, ``SHAPES`` /
``cell_applicable`` / ``all_cells``, ``input_specs`` leaf by leaf (shapes
and dtypes, by path, AdamW's state included) and ``cache_partition_specs``
for every arch on (2, 4) and (2, 16, 16) meshes (both packages' rule
functions read only the mesh's axis names and sizes, so each gets a
stand-in mesh; the JAX function's ``NamedSharding`` is replaced by the bare
spec, since a 512-device JAX mesh needs 512 devices).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro.launch import cache_specs as jcache_specs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import cache_meta as jcache_meta  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.analysis import analyze_step, model_flops, roofline_terms  # noqa: E402
from repro_torch.analysis.roofline import NET_BW, NVLINK_BW, link_rate  # noqa: E402
from repro_torch.launch import cache_specs, specs  # noqa: E402
from repro_torch.models import cache_meta  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCHS = list(configs.ARCHS)


# ------------------------------------------------------------------ the walk
def test_walk_counts_loop_products():
    n = 128
    x, w = torch.randn(n, n), torch.randn(n, n)

    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x.sum()

    _, r = analyze_step(f, x, w)
    assert r["flops"] == 8 * 2 * n ** 3


def test_walk_nested_loops():
    n = 64
    x, w = torch.randn(n, n), torch.randn(n, n)

    def g(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x.sum()

    _, r = analyze_step(g, x, w)
    assert r["flops"] == 15 * 2 * n ** 3


def test_walk_grad_flops_equal_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    n = 64
    x, w = torch.randn(n, n), torch.randn(n, n, requires_grad=True)

    def f(x, w):
        return torch.autograd.grad(torch.tanh(x @ w).sum(), w)

    _, r = analyze_step(f, x, w)
    with FlopCounterMode(display=False) as fc:
        f(x, w)
    assert r["flops"] >= 2 * 2 * n ** 3  # forward and dW
    assert r["flops"] == fc.get_total_flops()


def test_walk_hbm_bytes_and_top():
    n = 256
    x = torch.randn(n, n)
    _, r = analyze_step(lambda x: torch.tanh(x) @ x, x, top=5)
    assert r["hbm_bytes"] >= 3 * n * n * 4  # at least in + out of the product
    assert r["top_bytes"] and any(t["flops"] > 0 for t in r["top_flops"])
    assert r["peak_live_bytes"] == 2 * n * n * 4  # tanh's output and the product's


def test_walk_on_fake_tensors_and_indexed_writes():
    """On fake tensors the counts equal the real ones; an in-place slot
    write counts twice its source, not the buffer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(cache, k, w):
        cache.index_copy_(1, torch.zeros(1, dtype=torch.long), k)
        return cache.sum(1) @ w

    real = analyze_step(f, torch.zeros(4, 1024, 64), torch.ones(4, 1, 64), torch.ones(64, 32))[1]
    with FakeTensorMode():
        fake = analyze_step(f, torch.zeros(4, 1024, 64), torch.ones(4, 1, 64), torch.ones(64, 32))[1]
    for key in ("flops", "hbm_bytes", "peak_live_bytes", "ops"):
        assert real[key] == fake[key], key
    index = 8  # torch.zeros writes the index
    write = 2 * (4 * 64 * 4 + 8)  # the source and its index, read and written
    reduce_ = 4 * 1024 * 64 * 4 + 4 * 64 * 4
    mm = (4 * 64 + 64 * 32 + 4 * 32) * 4
    assert real["hbm_bytes"] == index + write + reduce_ + mm


# ------------------------------------------------------------------ roofline
class _Cfg:
    def param_counts(self):
        return {"total": 1_000_000, "active": 1_000_000}


def test_roofline_terms_keys_equal_jax():
    shape_info = {"kind": "train", "batch": 256, "seq": 4096}
    walk = {"flops_per_device": 1e12, "hbm_bytes_per_device": 1e9, "collective_bytes_per_device": 1e8}
    jr = jroofline.roofline_terms({"mesh": {"data": 16, "model": 16}, "walk": walk, "cost": {},
                                   "collectives": {"total_bytes": 0}}, _Cfg(), shape_info)
    record = {"mesh": {"data": 16, "model": 16}, "walk": walk,
              "collectives": {"per_group": {"data": 6e7, "model": 4e7}}}
    r = roofline_terms(record, _Cfg(), shape_info)
    assert set(r) == set(jr)
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["bound_step_time_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
    assert r["model_flops_per_device"] == jr["model_flops_per_device"] == 6 * 1e6 * 256 * 4096 / 256
    assert r["compute_s"] == 1e12 / 989.4e12 and r["memory_s"] == 1e9 / 3.35e12
    assert r["collective_s"] == 1e8 / NET_BW  # both groups of rank 0 leave its node of 8


def test_link_rates_follow_nodes():
    assert link_rate({"data": 2, "model": 4}, "model") == NVLINK_BW
    assert link_rate({"data": 2, "model": 4}, "data+model") == NVLINK_BW
    assert link_rate({"data": 16, "model": 16}, "model") == NET_BW
    assert link_rate({"data": 16, "model": 8}, "model") == NVLINK_BW
    assert link_rate({"data": 16, "model": 8}, "data") == NET_BW


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    for shape, info in jspecs.SHAPES.items():
        for chips in (8, 256, 512):
            assert model_flops(configs.get_config(arch), info, chips) == \
                jroofline.model_flops(jconfigs.get_config(arch), info, chips), (arch, shape, chips)


# ------------------------------------------------------------------ specs
def test_shapes_and_cells_equal_jax():
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.LONG_CONTEXT_ARCHS == jspecs.LONG_CONTEXT_ARCHS
    assert list(specs.all_cells()) == list(jspecs.all_cells())
    for arch in ARCHS + ["llama3.2-3b", "mixtral-8x7b", "qwen3-14b"]:
        for shape in specs.SHAPES:
            assert specs.cell_applicable(arch, shape) == jspecs.cell_applicable(arch, shape), (arch, shape)


_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}


def _jax_paths(tree):
    return ["/".join(jax.tree_util.keystr((k,)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    for shape, info in specs.SHAPES.items():
        train = info["kind"] == "train"
        got = specs.input_specs(arch, shape, optimizer=optim.adamw(3e-4) if train else None)
        want = jspecs.input_specs(arch, shape, optimizer=joptim.adamw(3e-4) if train else None)
        paths, leaves, _ = flatten_with_paths(got)
        wleaves = jax.tree_util.tree_leaves(want)
        assert paths == _jax_paths(want), (arch, shape)
        for path, g, w in zip(paths, leaves, wleaves):
            assert tuple(g.shape) == tuple(w.shape) and g.device.type == "meta", (arch, shape, path)
            assert jnp.dtype(_DTYPES[g.dtype]) == jnp.dtype(w.dtype), (arch, shape, path, g.dtype, w.dtype)


class _Mesh:
    """A stand-in mesh for both packages' rule functions."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.ndim = len(names)

    def size(self, i):
        return self.shape[self.axis_names[i]]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 16, 16)], ids=["2x4", "2x16x16"])
def test_cache_partition_specs_equal_jax(mesh_shape, monkeypatch):
    monkeypatch.setattr(jcache_specs, "NamedSharding", lambda mesh, spec: spec)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = _Mesh(mesh_shape, names)
    model = mesh.shape["model"]
    for arch in ARCHS:
        for batch, seq in ((128, 32768), (1, 524288)):
            cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
            pol = sharding.make_policy(mesh, cfg)
            jpol = jsharding.make_policy(mesh, jcfg)
            assert pol.activation_rules.get("act_kv_heads") == jpol.activation_rules.get("act_kv_heads")
            got = cache_specs.cache_specs(cfg, mesh, pol, cache_meta(cfg, batch, seq))
            want = jcache_specs.cache_partition_specs(jcfg, mesh, jpol, jcache_meta(jcfg, batch, seq))
            paths, gl, _ = flatten_with_paths(got)
            wl = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert paths == _jax_paths(want) and len(gl) == len(wl), arch
            for path, g, w in zip(paths, gl, wl):
                assert tuple(g) == tuple(w), (arch, model, batch, path, tuple(g), tuple(w))
