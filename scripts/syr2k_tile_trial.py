#!/usr/bin/env python3
"""Time float32 kernel D (csrc/syr2k.cu, 3xTF32) with other shapes of its walk.

    python3 scripts/syr2k_tile_trial.py [TILE,SPLIT,STRIP,STAGES ...]   # needs one card

The walk's tile, operand split, strip width and pipeline depth are
constants of csrc/syr2k_tile.cuh.  For each variant this copies
src/repro_torch/csrc into build/syr2k_tile_trial/<variant>/, rewrites
those constants (and the split) in the copy, and builds its syr2k.cu with
nvcc, all variants at once; then, on one seeded input at
the unfused path's first shape (n, k) = (3840, 256) with C a strided view,
checks each build against a float64 reference and times it (CUDA events,
calls back to back after a warm-up), the variants in order and then in
reverse.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The ceilings the walk runs against: warps that issue only independent
# mma.sync m16n8k8 TF32 products on registers (mma), and warps that also
# split 16 operand values per 8 fragments' 24 products (the 64 x 64 walk's
# ratio: one warp's 2 x 4 fragments of 16 x 8), 3xTF32 on registers without
# shared memory (split).  Each thread stores its sums so nothing is
# optimised away.
CEILING_CU = r"""
#include "common.cuh"
template <bool kSplit>
__global__ void __launch_bounds__(256) ceiling(int iters, float seed, float* sink) {
  float acc[2][4][4] = {};
  unsigned ab[2][4], as[2][4], bb[4][2], bs[4][2];
  const float x = seed * (threadIdx.x + 1);
  for (int i = 0; i < 2; ++i)
    for (int r = 0; r < 4; ++r) ab[i][r] = repro::to_tf32(x + 4 * i + r);
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 2; ++r) bb[i][r] = repro::to_tf32(x - 2 * i - r);
  for (int it = 0; it < iters; ++it) {
    if (kSplit) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = x + it + 4 * i + r;
          ab[i][r] = repro::to_tf32(v);
          as[i][r] = repro::to_tf32(v - __uint_as_float(ab[i][r]));
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = x - it - 2 * i - r;
          bb[i][r] = repro::to_tf32(v);
          bs[i][r] = repro::to_tf32(v - __uint_as_float(bb[i][r]));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::mma_tf32_1688(acc[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::mma_tf32_1688(acc[i][j], ab[i], bs[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) repro::mma_tf32_1688(acc[i][j], ab[i], bb[j]);
  }
  float s = 0.f;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) s += acc[i][j][0] + acc[i][j][1] + acc[i][j][2] + acc[i][j][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int ceiling_launch(int split, int blocks, int iters, float* sink, void* stream) {
  if (split) ceiling<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, 1e-3f, sink);
  else ceiling<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, 1e-3f, sink);
  return (int)cudaGetLastError();
}
"""
# (tile, split, strip, stages); split 0: big = cvt.rna(x), small =
# cvt.rna(x - big), the package's; 1: small passed as float32 bits (the
# tensor cores drop its low 13 bits); 2: also big rounded with integer
# operations instead of cvt.  Arguments "64,0,32,2 ..." pick the variants;
# by default every one below, the package's own first.
VARIANTS = [(64, 0, 8, 3)] + [(t, sp, 32, 2) for t in (64, 128) for sp in (0, 1, 2)] + [
    (64, 0, 8, 2), (64, 0, 16, 2), (64, 0, 16, 3), (64, 0, 16, 4), (64, 0, 32, 3), (64, 2, 8, 3)]
SMALL = "small = to_tf32(x - __uint_as_float(big));"
BIG = "big = to_tf32(x);"


def variant_header(text: str, tile: int, split: int, strip: int, stages: int) -> str:
    """csrc/syr2k_tile.cuh with the walk's constants (and split) replaced."""
    subs = [("kTile = 64;", f"kTile = {tile};"), ("kWarpM = 32;", f"kWarpM = {32 if tile == 64 else 64};"),
            ("kStrip = 8;", f"kStrip = {strip};"), ("kStages = 3;", f"kStages = {stages};")]
    if split >= 1:
        subs.append((SMALL, "small = __float_as_uint(x - __uint_as_float(big));"))
    if split == 2:
        subs.append((BIG, "big = (__float_as_uint(x) + 0x1000u) & ~0x1fffu;"))
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/syr2k_tile.cuh: expected one {old!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("syr2k_tile_trial: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib, syr2k

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "syr2k_tile_trial"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]] or VARIANTS
    procs = {}
    header = (cuda_lib.CSRC / "syr2k_tile.cuh").read_text()
    for v in variants:
        tag = "_".join(map(str, v))
        csrc = out_dir / tag
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, csrc)
        (csrc / "syr2k_tile.cuh").write_text(variant_header(header, *v))
        so = out_dir / f"syr2k_{tag}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(csrc / "syr2k.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    ceiling_src = out_dir / "ceiling.cu"
    ceiling_src.write_text(CEILING_CU)
    ceiling_so = out_dir / "ceiling.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, f"-I{cuda_lib.CSRC}", "-o", str(ceiling_so), str(ceiling_src)]
    procs["ceiling"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                        ceiling_so)
    fns = {}
    for v, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        print(f"tile, split, strip, stages {v} ptxas: " + "; ".join(ln.strip() for ln in log.splitlines() if "registers" in ln))
        if v == "ceiling":
            continue
        fn = ctypes.CDLL(str(so)).syr2k_launch
        fn.argtypes = syr2k._ARGTYPES
        fn.restype = ctypes.c_int
        fns[v] = fn
    ceiling = ctypes.CDLL(str(ceiling_so)).ceiling_launch
    ceiling.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    ceiling.restype = ctypes.c_int

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, k = 3840, 256
    Y = torch.randn((n, k), generator=gen, device="cuda")
    Z = torch.randn((n, k), generator=gen, device="cuda")
    full = torch.randn((n + 256, n + 256), generator=gen, device="cuda")
    C = (full + full.T)[256:, 256:]
    Zd, Yd, Cd = Z.double(), Y.double(), C.double()
    want = torch.tril(Cd) + torch.tril(Cd, -1).T - (Zd @ Yd.T + Yd @ Zd.T)
    out = torch.empty((n, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(v):
        err = fns[v](Z.data_ptr(), Y.data_ptr(), k, 0, n, k, -1.0, C.data_ptr(), C.stride(0), 0,
                     out.data_ptr(), 0, 1, stream)
        if err:
            raise RuntimeError(f"{v}: cudaError {err}")

    for v in variants:
        call(v)
        torch.cuda.synchronize()
        err = out.double() - want
        rel = float(err.abs().max()) / float(want.abs().max())
        if not (rel < 2e-6 and torch.equal(out, out.T)):
            raise RuntimeError(f"{v}: rel err {rel}")
        # The tensor cores round sums toward zero, which shrinks the
        # product term alpha (A B^T + B A^T) entry by entry (a positive
        # bias here); rounding to nearest leaves none.
        prod = want - (torch.tril(C.double()) + torch.tril(C.double(), -1).T)
        bias = float((err * -prod.sign()).sum() / prod.abs().sum())
        print(f"tile, split, strip, stages {v}: rel err vs float64 {rel:.3e}, exactly symmetric; "
              f"bias of the product toward zero {bias:.3e} of its mean |entry|")
    for v in (*variants, *reversed(variants)):
        call(v)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call(v)
        end.record()
        end.synchronize()
        print(f"tile, split, strip, stages {v}: (n, k)=({n}, {k}) ms={start.elapsed_time(end) / 20:.4f}")
    # Products per call: blocks x 8 warps x iters x 8 (x 3 with the split).
    blocks, iters = 132 * 8, 4096
    sink = torch.empty(blocks * 256, device="cuda")
    for split in (0, 1, 1, 0):
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if ceiling(split, blocks, iters, sink.data_ptr(), stream):
                raise RuntimeError("ceiling kernel failed to launch")
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end)
        flops = blocks * 8 * iters * 8 * (3 if split else 1) * 2.0 * 16 * 8 * 8
        print(f"ceiling {'split + 3 mma' if split else 'mma only'}: {flops / ms / 1e9:.1f} TFLOP/s "
              f"of TF32 products ({ms:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
