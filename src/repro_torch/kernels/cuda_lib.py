"""Build, load and count the hand-written CUDA kernels.

Route: each ``csrc/*.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The build happens at first use, every missing library at once (one nvcc
process per source, started together), into ``build/repro_torch/`` at the
root of the checkout.  A library's file name carries a hash of its sources
and flags, so an edited source is rebuilt.  ``ptxas`` register and
shared-memory reports land beside each library as ``<name>.ptxas.txt``.

Every launcher bumps :func:`launch_counts` once per call that launches its
kernel (and :func:`device_launch_counts` by the number of CUDA launches the
call made); nothing else touches the counters.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = [
    "SOURCES",
    "build",
    "library",
    "check",
    "count",
    "launch_counts",
    "device_launch_counts",
    "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# library name -> (source file, registry ops whose launches it counts)
SOURCES = {
    "fused_panel": ("fused_panel.cu", ("fused_panel_update",)),
    "bulge": ("bulge.cu", ("bulge_wavefront",)),
    "backtransform": ("backtransform.cu", ("backtransform_wy",)),
    "syr2k": ("syr2k.cu", ("syr2k", "trailing_update")),
    "panel": ("panel.cu", ("panel_qr",)),
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {op: 0 for _, ops in SOURCES.values() for op in ops}
_device_launches: Dict[str, int] = dict(_launches)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / SOURCES[name][0], *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, in parallel.
    Returns name -> path of the shared library."""
    out = {name: _target(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (build_dir() / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building all missing libraries first)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build()
            for nm, path in paths.items():
                if nm not in _libs:
                    _libs[nm] = ctypes.CDLL(str(path))
            lib = _libs[name]
    return lib


def check(err: int, op: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {op!r} failed to launch: cudaError {err}")


def count(op: str, device_launches: int) -> None:
    _launches[op] += 1
    _device_launches[op] += device_launches


def launch_counts() -> Dict[str, int]:
    """Calls per op that launched the op's kernel since the last reset."""
    return dict(_launches)


def device_launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per op since the last reset."""
    return dict(_device_launches)


def reset_launch_counts() -> None:
    for op in _launches:
        _launches[op] = 0
        _device_launches[op] = 0
