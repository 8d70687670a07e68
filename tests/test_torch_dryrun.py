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
  (``count_cell``);
* ``long_500k`` on llama is skipped with JAX's reason; the Shampoo option
  raises ``NotImplementedError`` naming its ROADMAP item; without a card
  the default device raises; ``--smoke`` reaches ``get_smoke_config``.
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
CELLS = {
    "mamba2_train": dict(arch="mamba2-370m", shape="train_4k",
                         kw=dict(mesh_override=(2, 2), smoke=True, pure_dp=False,
                                 shape_overrides=dict(batch=4, seq=32))),
    "recurrentgemma_decode": dict(arch="recurrentgemma-2b", shape="decode_32k",
                                  kw=dict(mesh_override=(2, 2), smoke=True, shape_overrides=dict(batch=4, seq=64))),
    "granite_moe_prefill": dict(arch="granite-moe-3b-a800m", shape="prefill_32k",
                                kw=dict(mesh_override=(2, 2), smoke=True, shape_overrides=dict(batch=4, seq=32))),
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
try:
    dr.run_cell("llama3.2-3b", "train_4k", optimizer_name="shampoo", device="cpu")
except NotImplementedError as e:
    out["shampoo"] = str(e)
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

reduced = json.loads(sys.argv[1])
rec = dr.run_cell(reduced["arch"], reduced["shape"], mesh_override=tuple(reduced["mesh"]),
                  overrides=reduced["overrides"])
skip = dr.run_cell("llama3.2-3b", "long_500k")
print("JAX_SIDE_OK")
print(json.dumps({"reduced": {k: rec[k] for k in ("mesh", "memory", "walk", "roofline")}, "skip": skip}))
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
        "jax": subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE), json.dumps(REDUCED)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
        "port": subprocess.Popen([sys.executable, "-c", textwrap.dedent(PORT_SIDE), json.dumps(REDUCED),
                                  json.dumps(CELLS), str(tmp)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
    }
    out = {}
    try:
        out["world"] = run_ranks(ranks.dryrun_ranks, 4, backend="gloo", device_type="cpu", args=(CELLS,),
                                 timeout_s=600)
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
    assert rec["walk"]["flops_per_device"] == real["flops"] > 0, name


def test_long_context_skip_shampoo_and_device(runs):
    assert runs["port"]["skip"] == runs["jax"]["skip"]
    assert runs["port"]["skip"]["status"] == "skipped"
    assert "ROADMAP Queue 1 item 13(e)" in runs["port"]["shampoo"]
    if not torch.cuda.is_available():
        assert "device='cpu'" in runs["port"]["no_card"]


def test_smoke_flag_reaches_smoke_config(runs):
    assert runs["port"]["smoke_rc"] == 0
    assert runs["port"]["smoke_calls"] == ["mamba2_370m"]
    rec = runs["port"]["smoke_record"]
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 2, "model": 2}
    assert rec["memory"]["argument_bytes"] < runs["port"]["small_mesh"]["memory"]["argument_bytes"] / 100
