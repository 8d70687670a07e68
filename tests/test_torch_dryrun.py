"""Port parity: the dry-run (``repro_torch.launch.dryrun``), CPU.

Every dry-run runs in a subprocess (a fake world is a process group, which
must not leak into a pytest worker), once per pytest run under a file lock
as tests/test_torch_sharding.py runs its world:

* the port's ``run_cell("mamba2-370m", "decode_32k", mesh_override=(2, 4),
  device="cpu")``, the counterpart of tests/test_sharding_multidevice.py's
  ``test_dryrun_cell_small_mesh``: status ok, a dominant term, a positive
  peak;
* the same cell cut to 2 layers against the JAX package's ``run_cell`` of
  the same overrides (one JAX subprocess on 8 fake devices): equal mesh,
  ``model_flops_per_device`` and per-device argument bytes (parameters,
  cache and tokens: each leaf's shard is the same on both sides, the
  replicated B/C window and ``pos`` included), walked FLOPs within 5 %
  (JAX counts its dots, the port every product it runs: the port computes
  the B/C projections whole on each of the 4 model ranks, from replicated
  weights, where GSPMD splits them four ways and gathers, +2.4 % here);
* three smoke cells on a (2, 2) mesh (mamba2 train with its mixers tensor
  parallel, recurrentgemma decode with the window split, granite-moe
  prefill): the fake world's per-kind collective bytes equal exactly, and
  its walked FLOPs equal exactly ``FlopCounterMode``'s, those of rank 0 of
  a real world of four gloo ranks running the same cell
  (``count_cell``), and so do its walked HBM bytes, the real step's walk
  (``FlopCounterMode`` and the walk agree exactly on the real step);
* the Shampoo option (``optimizer_name="shampoo"``) on llama3.2-3b's smoke
  config cut to 1 layer (11 blocks of 256 a side), with and without
  ``shampoo_sharded``, in the same comparison with the real world: the
  collective bytes equal exactly (the sharded refresh gathers rank 0's
  roots, 2 sides x its lanes x 256 x 256 x 4 bytes more), and so do the
  FLOPs and HBM bytes outside the data-dependent loops, which both list
  (the real run's Rayleigh-Ritz Jacobi stops early, the fake one runs its
  8 sweeps);
* the Shampoo option on the reduced cell (mamba2-370m cut to 1 layer,
  train_4k, (2, 4)) against JAX's ``run_cell(optimizer_name="shampoo")``
  (replicated statistics: its 143 blocks do not split over 8 devices):
  equal mesh, ``model_flops_per_device`` and statistics' shape, and
  argument bytes that differ exactly by what the port keeps whole (``mu``
  and ``nu`` whole on every rank, against JAX's, which mirror the
  parameters' shardings); and with ``shampoo_sharded`` on llama3.2-3b cut
  to 1 layer (1560 blocks, 195 a device), against a second JAX subprocess
  run in parallel: the same, the statistics and roots whole on every rank
  against JAX's 1/8 of them (``P(("data", "model"), None, None)``);
* ``long_500k`` on llama is skipped with JAX's reason; full-size
  llama3.2-3b train_4k with Shampoo traces (one lane a side on fake
  tensors) with its ``shampoo`` record; an unknown optimizer raises
  ``ValueError``; without a card the default device raises; ``--smoke``
  reaches ``get_smoke_config``.
"""
import fcntl
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_shard_ranks as ranks  # noqa: E402
from repro_torch.parallel import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = dict(arch="mamba2-370m", shape="decode_32k", mesh=(2, 4), overrides={"n_layers": 2})
SHAMPOO_REDUCED = dict(arch="mamba2-370m", shape="train_4k", mesh=(2, 4), overrides={"n_layers": 1})
SHAMPOO_SHARDED = dict(arch="llama3.2-3b", shape="train_4k", mesh=(2, 4), overrides={"n_layers": 1})
_SHAMPOO_SMOKE = dict(mesh_override=(2, 2), smoke=True, overrides=dict(n_layers=1),
                      shape_overrides=dict(batch=4, seq=32), optimizer_name="shampoo")
CELLS = {
    "mamba2_train": dict(arch="mamba2-370m", shape="train_4k",
                         kw=dict(mesh_override=(2, 2), smoke=True, pure_dp=False,
                                 shape_overrides=dict(batch=4, seq=32))),
    "recurrentgemma_decode": dict(arch="recurrentgemma-2b", shape="decode_32k",
                                  kw=dict(mesh_override=(2, 2), smoke=True, shape_overrides=dict(batch=4, seq=64))),
    "granite_moe_prefill": dict(arch="granite-moe-3b-a800m", shape="prefill_32k",
                                kw=dict(mesh_override=(2, 2), smoke=True, shape_overrides=dict(batch=4, seq=32))),
    "llama_shampoo": dict(arch="llama3.2-3b", shape="train_4k", kw=_SHAMPOO_SMOKE),
    "llama_shampoo_sharded": dict(arch="llama3.2-3b", shape="train_4k", kw=dict(_SHAMPOO_SMOKE, shampoo_sharded=True)),
}

PORT_SIDE = r"""
import json, sys
import torch
from repro_torch import configs
import repro_torch.launch.dryrun as dr

reduced, cells, out_dir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
out = {"small_mesh": dr.run_cell("mamba2-370m", "decode_32k", mesh_override=(2, 4), device="cpu"),
       "reduced": dr.run_cell(reduced["arch"], reduced["shape"], mesh_override=tuple(reduced["mesh"]),
                              overrides=reduced["overrides"], device="cpu"),
       "skip": dr.run_cell("llama3.2-3b", "long_500k", device="cpu")}
for name, cell in cells.items():
    kw = dict(cell["kw"], mesh_override=tuple(cell["kw"]["mesh_override"]))
    out[name] = dr.run_cell(cell["arch"], cell["shape"], device="cpu", **kw)
sr = json.loads(sys.argv[4])
out["shampoo_reduced"] = dr.run_cell(sr["arch"], sr["shape"], mesh_override=tuple(sr["mesh"]),
                                     overrides=sr["overrides"], optimizer_name="shampoo", device="cpu")
ss = json.loads(sys.argv[5])
out["shampoo_sharded"] = dr.run_cell(ss["arch"], ss["shape"], mesh_override=tuple(ss["mesh"]),
                                     overrides=ss["overrides"], optimizer_name="shampoo", shampoo_sharded=True,
                                     device="cpu", top=0)
out["shampoo"] = dr.run_cell("llama3.2-3b", "train_4k", optimizer_name="shampoo", device="cpu", top=0)
try:
    dr.run_cell("llama3.2-3b", "train_4k", optimizer_name="sgd", device="cpu")
except ValueError as e:
    out["bad_optimizer"] = str(e)
if not torch.cuda.is_available():
    try:
        dr.run_cell("mamba2-370m", "decode_32k", mesh_override=(2, 4))
    except RuntimeError as e:
        out["no_card"] = str(e)
calls = []
real = configs.get_smoke_config
configs.get_smoke_config = lambda arch: calls.append(arch) or real(arch)
out["smoke_rc"] = dr.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--smoke", "--mesh", "2,2",
                           "--device", "cpu", "--out", out_dir])
out["smoke_calls"] = calls
with open(out_dir + "/mamba2-370m_decode_32k_1pod.json") as f:
    out["smoke_record"] = json.load(f)
print("PORT_SIDE_OK")
print(json.dumps(out))
"""

JAX_SIDE = r"""
import os, json, sys
os.environ["REPRO_DRYRUN_XLA"] = "--xla_force_host_platform_device_count=8"
import repro.launch.dryrun as dr

reduced, sr = json.loads(sys.argv[1]), json.loads(sys.argv[2])
rec = dr.run_cell(reduced["arch"], reduced["shape"], mesh_override=tuple(reduced["mesh"]),
                  overrides=reduced["overrides"])
skip = dr.run_cell("llama3.2-3b", "long_500k")
shampoo_rec = dr.run_cell(sr["arch"], sr["shape"], mesh_override=tuple(sr["mesh"]), overrides=sr["overrides"],
                          optimizer_name="shampoo")
import dataclasses
from repro.configs import get_config
from repro.launch.specs import input_specs
from repro.optim import ShampooOptions, shampoo
from repro.solver import EvdConfig

opt = shampoo(3e-4, opts=ShampooOptions(block_size=256, update_interval=20, evd=EvdConfig(b=8, nb=64)))
cfg = dataclasses.replace(get_config(sr["arch"]), **sr["overrides"])
specs = input_specs(sr["arch"], sr["shape"], optimizer=opt, model_axis=sr["mesh"][-1], cfg=cfg)
print("JAX_SIDE_OK")
print(json.dumps({"reduced": {k: rec[k] for k in ("mesh", "memory", "walk", "roofline")}, "skip": skip,
                  "shampoo": {k: shampoo_rec[k] for k in ("mesh", "memory", "roofline")},
                  "stats_shape": list(specs["opt_state"].stats_l.shape)}))
"""

JAX_SHARDED_SIDE = r"""
import os, json, sys
os.environ["REPRO_DRYRUN_XLA"] = "--xla_force_host_platform_device_count=8"
import repro.launch.dryrun as dr

ss = json.loads(sys.argv[1])
rec = dr.run_cell(ss["arch"], ss["shape"], mesh_override=tuple(ss["mesh"]), overrides=ss["overrides"],
                  optimizer_name="shampoo", shampoo_sharded=True)
import dataclasses
from repro.configs import get_config
from repro.launch.specs import input_specs
from repro.optim import ShampooOptions, shampoo
from repro.solver import EvdConfig

opt = shampoo(3e-4, opts=ShampooOptions(block_size=256, update_interval=20, evd=EvdConfig(b=8, nb=64)))
cfg = dataclasses.replace(get_config(ss["arch"]), **ss["overrides"])
specs = input_specs(ss["arch"], ss["shape"], optimizer=opt, model_axis=ss["mesh"][-1], cfg=cfg)
print("JAX_SHARDED_SIDE_OK")
print(json.dumps({"shampoo": {k: rec[k] for k in ("status", "mesh", "memory", "roofline")},
                  "stats_shape": list(specs["opt_state"].stats_l.shape)}))
"""


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return _runs(tmp_path_factory)
    path = tmp_path_factory.getbasetemp().parent / f"torch_dryrun_{uid}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = _runs(tmp_path_factory)
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(f"{path}.tmp", path)
        return out


def _runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    procs = {
        "jax": subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE), json.dumps(REDUCED),
                                 json.dumps(SHAMPOO_REDUCED)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
        "jax_sharded": subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SHARDED_SIDE),
                                         json.dumps(SHAMPOO_SHARDED)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
        "port": subprocess.Popen([sys.executable, "-c", textwrap.dedent(PORT_SIDE), json.dumps(REDUCED),
                                  json.dumps(CELLS), str(tmp), json.dumps(SHAMPOO_REDUCED),
                                  json.dumps(SHAMPOO_SHARDED)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
    }
    out = {}
    try:
        out["world"] = run_ranks(ranks.dryrun_ranks, 4, backend="gloo", device_type="cpu", args=(CELLS,),
                                 timeout_s=900)
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            assert proc.returncode == 0 and f"{key.upper()}_SIDE_OK" in stdout, \
                f"{key}\nSTDOUT:\n{stdout[-4000:]}\nSTDERR:\n{stderr[-8000:]}"
            out[key] = _last_json(stdout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def test_dryrun_cell_small_mesh(runs):
    rec = runs["port"]["small_mesh"]
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["peak_estimate_bytes"] > 0
    jax_keys = {"arch", "shape", "multi_pod", "status", "mesh", "memory", "cost", "collectives", "walk", "roofline"}
    assert jax_keys <= set(rec) and "trace_s" in rec
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_estimate_bytes"} == set(rec["memory"])


def test_reduced_cell_against_jax(runs):
    got, want = runs["port"]["reduced"], runs["jax"]["reduced"]
    assert got["mesh"] == want["mesh"] == {"data": 2, "model": 4}
    assert got["roofline"]["model_flops_per_device"] == want["roofline"]["model_flops_per_device"]
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    rel = got["walk"]["flops_per_device"] / want["walk"]["flops_per_device"] - 1
    assert abs(rel) < 0.05, rel


@pytest.mark.parametrize("name", list(CELLS))
def test_fake_world_counts_equal_a_real_world(runs, name):
    rec, real = runs["port"][name], runs["world"][0][name]
    assert rec["status"] == "ok"
    assert rec["collectives"] == real["collectives"], name
    assert rec["collectives"]["total_bytes"] > 0
    loops = {d["site"] for d in rec["walk"]["data_dependent"]}
    assert loops == {d["site"] for d in real["data_dependent"]}, name
    assert rec["walk"]["flops_outside_loops"] == real["flops_outside_loops"] > 0, name
    assert rec["walk"]["hbm_bytes_outside_loops"] == real["hbm_bytes_outside_loops"] > 0, name
    assert real["walk_flops"] == real["flops"], name  # the walk and FlopCounterMode on the real step
    if not loops:
        assert rec["walk"]["flops_per_device"] == real["flops"], name
        assert rec["walk"]["hbm_bytes_per_device"] == real["hbm_bytes"], name
    else:  # Shampoo: the Rayleigh-Ritz Jacobi of each side, on fake tensors at its bound
        assert CELLS[name]["kw"].get("optimizer_name") == "shampoo"
        assert loops == {"core/jacobi.py:jacobi_eigh"}
        fake, = rec["walk"]["data_dependent"]
        assert (fake["entries"], fake["trips"]) == (2, 16)
        assert 0 <= real["data_dependent"][0]["trips"] <= 16  # zero statistics need no sweep


def test_sharded_refresh_gathers_rank0_roots(runs):
    one, split = runs["port"]["llama_shampoo"], runs["port"]["llama_shampoo_sharded"]
    sh = split["shampoo"]
    assert (sh["blocks_per_side"], sh["refresh_ranks"], sh["rank0_lanes_per_side"]) == (11, 4, 3)
    assert one["shampoo"]["rank0_lanes_per_side"] == 11 and not one["shampoo"]["sharded"]
    gather = lambda r: r["collectives"]["per_kind"]["all_gather"]  # noqa: E731
    assert gather(split)["bytes"] - gather(one)["bytes"] == 2 * 3 * 256 * 256 * 4
    both = gather(split)["by_axes"]["data+model"], gather(one)["by_axes"]["data+model"]
    assert (both[0]["count"] - both[1]["count"], both[0]["bytes"] - both[1]["bytes"]) == (2, 2 * 3 * 256 * 256 * 4)
    assert one["shampoo"]["state_bytes"] == sh["state_bytes"]
    assert split["walk"]["flops_per_device"] < one["walk"]["flops_per_device"]


def test_shampoo_reduced_cell_against_jax(runs):
    got, want = runs["port"]["shampoo_reduced"], runs["jax"]["shampoo"]
    assert got["status"] == "ok"
    assert got["mesh"] == want["mesh"] == {"data": 2, "model": 4}
    assert got["roofline"]["model_flops_per_device"] == want["roofline"]["model_flops_per_device"]
    nb = got["shampoo"]["blocks_per_side"]
    assert [nb, 256, 256] == runs["jax"]["stats_shape"]
    # The port keeps mu and nu whole on every rank; JAX's mirror the
    # parameters' shardings (float32, as the parameters: one shard each).
    state, by_input = got["shampoo"]["state_bytes"], got["argument_bytes_by_input"]
    kept_whole = state["mu"] + state["nu"] - 2 * by_input["params"]
    assert kept_whole > 0
    assert got["memory"]["argument_bytes"] - want["memory"]["argument_bytes"] == kept_whole


def test_shampoo_sharded_cell_against_jax(runs):
    got, want = runs["port"]["shampoo_sharded"], runs["jax_sharded"]["shampoo"]
    assert got["status"] == want["status"] == "ok"
    assert got["mesh"] == want["mesh"] == {"data": 2, "model": 4}
    assert got["roofline"]["model_flops_per_device"] == want["roofline"]["model_flops_per_device"]
    sh = got["shampoo"]
    assert [sh["blocks_per_side"], 256, 256] == runs["jax_sharded"]["stats_shape"] == [1560, 256, 256]
    assert sh["sharded"] and (sh["refresh_ranks"], sh["rank0_lanes_per_side"]) == (8, 195)
    # The port keeps mu and nu whole, and the statistics and roots whole, on
    # every rank; JAX's mu and nu mirror the parameters' shardings and its
    # statistics and roots are split over the 8 devices.
    state, by_input = sh["state_bytes"], got["argument_bytes_by_input"]
    stacks = sum(state[k] for k in ("stats_l", "stats_r", "pre_l", "pre_r"))
    kept_whole = state["mu"] + state["nu"] - 2 * by_input["params"] + stacks - stacks // 8
    assert stacks == 4 * 1560 * 256 * 256 * 4 and kept_whole > stacks // 2
    assert got["memory"]["argument_bytes"] - want["memory"]["argument_bytes"] == kept_whole


def test_long_context_skip_shampoo_and_device(runs):
    assert runs["port"]["skip"] == runs["jax"]["skip"]
    assert runs["port"]["skip"]["status"] == "skipped"
    rec = runs["port"]["shampoo"]
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 16, "model": 16}
    sh = rec["shampoo"]
    assert sh["blocks_per_side"] == 43032 and sh["refresh_counted"] and not sh["sharded"]
    assert set(sh["state_bytes"]) == {"step", "mu", "nu", "stats_l", "stats_r", "pre_l", "pre_r"}
    assert sh["state_bytes"]["stats_l"] == 43032 * 256 * 256 * 4
    assert {d["site"] for d in rec["walk"]["data_dependent"]} == {"core/jacobi.py:jacobi_eigh"}
    assert rec["memory"]["peak_estimate_bytes"] > sum(sh["state_bytes"].values())
    assert "expected one of ('adamw', 'shampoo')" in runs["port"]["bad_optimizer"]
    if not torch.cuda.is_available():
        assert "device='cpu'" in runs["port"]["no_card"]


def test_smoke_flag_reaches_smoke_config(runs):
    assert runs["port"]["smoke_rc"] == 0
    assert runs["port"]["smoke_calls"] == ["mamba2_370m"]
    rec = runs["port"]["smoke_record"]
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 2, "model": 2}
    assert rec["memory"]["argument_bytes"] < runs["port"]["small_mesh"]["memory"]["argument_bytes"] / 100
