#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and its time.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the n = 4096 paths give it: max abs / rel error and the tolerance,
   the kernel's time (CUDA events, warm), the plain version's time, a
   library yardstick where one exists, and the least time the card could
   take for the same work (``bound_ms``, from bytes and operations at the
   peak rate of their type; float32 work on the tensor cores, 3xTF32, at
   3 x flops over the TF32 rate) with the share of it the kernel reaches.
   Kernels A-C (fused path; A, B and C also split by CUDA kernel with
   ``torch.profiler``; B's time also
   per dependent step of the chase, with and without its log), D
   (``syr2k`` / ``trailing_update``, in float32 and bf16, bf16 with its
   share of the bound beside the bf16 library call) and E (the standalone
   ``panel_qr``: first a sweep of its cluster size at m = 256, 1024 and
   both panels, then both panels on the launcher's cluster, each with its
   CTAs and rows per CTA and its time per call with the launcher's host
   work; its CUDA launches and device time inside one
   ``band_reduce(panel_method="kernel")`` call come from the profiler
   session of A-C).
3. The main path, ``plan(4096, float32, EvdConfig())(A)`` and ``.eigvals(A)``
   on a seeded random symmetric A: launch counters reset just before and
   read just after (each kernel must have run, its CUDA launches exactly
   as many as its calls make), eigenvalues against
   ``torch.linalg.eigvalsh``, residual and orthogonality, end-to-end time
   beside ``torch.linalg.eigh`` / ``eigvalsh`` (cuSOLVER) and the peak
   memory.  (Its per-stage times, each stage closed by a synchronize and
   the Q2 back-transform split into the ``sweep_major_log`` regroup and
   kernel C, come from phase 5's unfused run of the same executor.)
4. ``inverse_pth_root`` at n = 1024, p = 4 on a seeded PSD matrix, against
   V diag(w^-1/4) V^T from ``torch.linalg.eigh`` in float64.
5. The unfused first stage at n = 4096: ``plan(4096, float32,
   EvdConfig(tridiag="unfused"))``'s EVD (the executor ``plan(A)`` runs, its
   stages timed in the same run) and ``.eigvals(A)`` against
   the gates of phase 3, each with the counters reset just before and read
   just after (one ``trailing_update`` launch per DBR block, kernel B once,
   one CUDA launch, for the eigvals run), and ``band_reduce(A, 8, 256,
   panel_method="kernel")`` (one ``panel_qr`` launch per panel) with the
   band's eigenvalues against ``torch.linalg.eigvalsh(A)`` (and one CUDA
   launch a panel, as the wrapper declares it).

6. Batched solves at full width.  (a) A synthetic Shampoo refresh: a
   quarter (1536) of the 6144 blocks of 128 that one decoder layer of
   llama3.2-3b gives under ``ShampooOptions()``, seeded PSD G Gᵀ/256 +
   1e-3 I through ``solve_many(..., EvdConfig(b=8, nb=64),
   op="inverse_pth_root", p=4)``, against the float64 ``torch.linalg.eigh``
   formula; kernels A, B and C must launch exactly 1536 x one
   ``plan(128)`` solve's calls.  Its wall time beside batched
   ``torch.linalg.eigh`` plus the root formula, the peak memory, the stage
   times of an eigh run of the same bucket beside the kernels' device
   time, kernel A and ``plan(128)`` bitwise repeatable, and its first 8
   matrices against ``plan(128)`` one by one.
   (b) Heterogeneous stacks (n = 128, 96, 127) with exact buckets (n = 127
   runs ``method="direct"``) and padded into one bucket of 128, every leaf
   through phase 3's gates.  (c) A medium bucket, (8, 1024, 1024), beside
   batched ``torch.linalg.eigh``.
7. The other methods on the card (plain torch): ``plan(1021)`` (odd n, the
   direct method), ``method="jacobi"`` at n = 512, ``chase="sequential",
   backtransform="scan"`` at n = 256, and the ``repro_torch.core``
   wrappers at n = 256, each through phase 3's gates beside
   ``torch.linalg.eigh``.
8. Shampoo training on the card through the port's entry points:
   ``get_config("llama3.2-3b")`` at full width with its depth cut to 1
   layer (bf16 activations, fp32 weights, ``remat="block"``), random
   weights from the seed, ``shampoo(warmup_cosine(3e-4, ...),
   ShampooOptions())``, ``make_train_step``, ``TrainLoop`` and
   ``synthetic_batch`` (batch 8 x 128), 3 steps; step 1 refreshes the
   preconditioners, two ``solve_many`` buckets of every block of 128.
   Gates: finite losses, every weight moved, kernels A, B and C launched
   exactly 2 x blocks x one ``plan(128)`` solve's over the run, the step-1
   roots on 64 seeded blocks within 1e-3 of the float64 formula (beside
   float32 ``torch.linalg.eigh``'s error on them), and step 1
   repeated from the same state bit for bit (its refresh's stages timed).
   Then the same 3 steps with AdamW, ``YARDSTICK_BLOCKS`` of one side's
   step-1 statistics through batched ``torch.linalg.eigh`` plus the root
   (the yardstick, ms a block), the peak
   memory, and ``python -m repro_torch.launch.train --arch llama3.2-3b
   --smoke --steps 2 --optimizer shampoo`` on the card.
9. Serving on the card through the port's entry points (``get_config``,
   ``model_params``, ``cache_init``, ``make_serve_step``, ``make_prefill``,
   ``decode_step``), random weights from the seed, bf16 activations and
   fp32 weights as published: (a) llama3.2-3b at full width and depth,
   batch 8, prompt 64, gen 32; (b) codeqwen1.5-7b, stablelm-3b and
   qwen3-14b at full width cut to 2 layers, and granite-moe-3b-a800m at
   full width and depth, each at the launcher's batch 4, prompt 32, gen 16;
   (c) mixtral-8x7b at full width with its window of 4096, cut to 1 layer,
   batch 2, 4224 teacher-forced positions and 16 generated (its ring buffer
   wraps past position 4096); (d) mamba2-370m at all 48 layers, batch 4,
   prompt 240, gen 16 (the float32 forward's SSD in 2 chunks of 128), and
   recurrentgemma-2b at all 26 layers, batch 2, prompt 528, gen 16 (2
   RG-LRU chunks of 272, a local-attention cache of 544 slots), each
   decoding on its recurrent states; musicgen-large and
   llava-next-mistral-7b at full width cut to 2 layers, batch 4, prompt
   32, gen 16, on tokens.  Each cell times the serve loop (the prompt,
   its first 64 tokens where longer, by teacher-forced decode steps, then
   greedy decode), the full-sequence
   ``make_prefill``, the peak memory, and a step's device time (the step
   captured as one CUDA graph).  Gates: a float32 copy of the config on the
   same weights (granite-moe's first 4 layers; llama3.2-3b's, mamba2-370m's
   and recurrentgemma-2b's first 8: see ``SERVE_CELLS``),
   teacher-forced over the prompt and then greedy, gives decode logits
   within ``TOL_SERVE`` of max|logits| of ``forward``'s over the same
   tokens at every position, or within 4x the forward's own change under a
   1-ulp move of its embedding where that is larger, and at the median
   position within 4x the forward's median change (MoE archs: the forward
   with ``moe_impl="dense"`` and the decode's expert choices replayed;
   mixtral's positions past 4096 also on their own); its greedy tokens, and
   ``make_prefill``'s, are the forward's argmax (or within that tolerance
   of its max, a tie); the bf16 decode logits over the same tokens (the
   first 64 + 16 positions where longer) are finite and within 0.1
   (mean) of max|logits| of the float32 ones; kernels
   A-E launch no time.  Then ``python -m repro_torch.launch.serve --arch
   mixtral-8x7b --smoke`` on the card.
10. The Mamba2 and RG-LRU families and the frontends on the card, through
   the port's entry points.  (a) Shampoo training with phase 8's gates
   (one shared helper): mamba2-370m at full width cut to 4 layers, batch
   8 x 256 (two SSD chunks of 128), 3 steps, step 1 repeated bit for bit
   (1749 blocks a side); recurrentgemma-2b cut to one (rglru, rglru, attn)
   unit, batch 4 x 1024 (two RG-LRU chunks of 512, the checkpointed carry
   run backward), 2 steps, its refresh's stages timed in the run (14 560
   blocks a side); kernels A, B and C launched exactly 2 x blocks x one
   ``plan(128)``'s in each.  (b) is phase 9's (d).  (c) musicgen-large and
   llava-next-mistral-7b at full width cut to 1 layer, 2 AdamW steps on
   ``synthetic_batch``'s embeddings: finite losses, ``frontend_proj``
   moved.  (d) ``python -m repro_torch.launch.serve --arch mamba2-370m
   --smoke`` and ``python -m repro_torch.launch.train --arch
   recurrentgemma-2b --smoke --steps 2 --optimizer shampoo`` on the card.
11. The multi-device paths, multi-controller, through
   ``repro_torch.parallel.run_ranks``: four ranks share the card over gloo
   (NCCL refuses two ranks on one device), each with its own launch
   counters.  (a) ``dist_band_reduce(mesh, "x", A, 8, 256,
   panel_qr_fn=<kernel E>)`` at n = 4096: the band within 1e-4 of max|B|
   of the one-process ``band_reduce(panel_method="kernel")`` with its
   trailing updates in the same row blocks (and beside the kernel-D one),
   its eigenvalues and the kernel-D band's within 1e-6 of max|w| of
   float64 ``eigvalsh(A)``, kernel E launched once a panel on every rank,
   every trailing block gathered by ``all_gather``.  (b)
   ``solve_many(..., op="inverse_pth_root", devices=make_local_mesh())``
   on phase 6a's synthetic statistics at 1538 blocks (385 a rank, two
   identity lanes): roots on 64 seeded blocks within 1e-3 of float64,
   kernels A, B and C launched exactly 385 x one ``plan(128)`` solve's on
   each rank, an eigh run's eigenvalues within 3e-4 of the one-process
   bucket's, beside phase 6a's time.  (c) Shampoo with ``precond_mesh=
   (make_local_mesh(), ("data", "model"))`` on phase 10's mamba2-370m cell
   (4 layers, 8 x 256, 2 steps) with phase 8's gates per rank (A, B and C
   launched 2 x ceil(1749 / 4) x one solve's), step-1 and steady times and
   each rank's peak memory.  (d) ``compressed_psum`` of a replicated (16,
   64) input and of one input a rank: every entry within 1e-6 (relative)
   of the int8 algorithm's value computed in plain PyTorch from every
   rank's input, and the replicated input back within 0.02 of itself.
   Every rank's results bitwise equal.  (e) A world
   of one rank on NCCL runs (b) at 64 blocks and (d).
12. Model sharding: the sharded train step (``make_policy``,
   ``shard_params``, ``make_train_step(..., policy=)``) on four gloo ranks
   sharing the card, a (2, 2) ``("data", "model")`` mesh, at published
   widths cut in depth, float32 weights.  (a) llama3.2-3b, 1 layer, 8 x 128,
   ``fsdp=True`` (heads mode): 2 AdamW steps in bf16 activations, 1 with
   ``sequence_parallel=True``, 1 in float32; (b) the same in float32 in
   ``q_heads`` and ``cp`` through explicit policies; (c) granite-moe-3b-
   a800m, 1 layer, 4 x 128, float32: ``ep`` (as resolved), ``capacity``
   and ``tp``; (d) (c)'s float32 ``ep`` step with Shampoo and
   ``precond_mesh`` over both axes.  Gates: every rank's loss bit for bit
   equal; float32 losses within 1e-5 (relative) of one process's step on
   the whole weights and, leaf by leaf, the gathered weights within 1e-4
   of the step's largest change, or within 2x that leaf's distance between
   the one-process step and the same step in float64 where that is larger
   (AdamW from a second moment of 1, learning rate 1), and in (a)'s
   float32 step and (c)'s ``ep`` each leaf of the momentum within 1e-4 of
   its largest entry from the float64 step's, or within 4x the one-process
   momentum's distance from it where larger; bf16 losses within 4x the
   one-process loss's change under a one-ulp
   move of the embedding;
   kernels A-E launched no time in the AdamW steps; in (d) each rank's
   A, B and C launches exactly 2 x ceil(blocks / 4) x one ``plan(128)``
   solve's and its roots within 1e-3 of float64.  Prints each rank's step
   ms and peak memory, the bytes a step moved (parameter gathers, gradient
   sums, activations) and whether gloo sums bfloat16 CUDA tensors.
13. Tensor parallelism of the mixers, sharded serving and the dry-run.
   (a) On phase 12's four ranks: mamba2-370m at full width cut to 2
   layers (8 x 256) and recurrentgemma-2b cut to one (rglru, rglru, attn)
   unit (4 x 512), float32, ``make_policy(pure_dp=False)`` (the mixers'
   width split on model), one sharded train step under phase 12's float32
   gates; then ``make_prefill`` and ``make_serve_step`` (FSDP off) on
   ``launch.cache_specs``' cache shards, a 32-token prompt teacher-forced
   and 8 greedy tokens: the tokens equal one process's, the logits within
   phase 9's gate of one process's.  (b) ``launch.dryrun.run_cell`` on
   fake CUDA tensors in fake worlds of 256 and 512 ranks, at full width
   and depth: llama3.2-3b train_4k, mamba2-370m long_500k and
   mixtral-8x7b decode_32k (multi-pod), each record's summary line.  (c)
   The dry-run of (a)'s mamba2 cell against the same cell run for real on
   the four ranks (``count_cell``): rank 0's collective bytes by kind and
   group, and its walked FLOPs against ``FlopCounterMode``'s, exactly;
   and of llama3.2-3b, 1 layer, 8 x 128, one process, against its real
   step: the peak estimate over the step's peak memory (``TOL_PEAK``),
   FLOPs exactly, and the step's time over the roofline's bound.  No
   kernel launches (AdamW; serving).
14. Kernels A-E as ``repro_torch`` operators and the dry-run's Shampoo
   option.  (a) ``torch.library.opcheck`` of each operator (schema,
   autograd registration, fake implementation, AOT dispatch) on phase 2's
   inputs.  (b) The smoke Shampoo cell of tests/test_torch_dryrun.py
   (llama3.2-3b's smoke config, 1 layer, (2, 2)), ``shampoo_sharded``
   (the tests run it without too), on fake CUDA tensors against the same cell run for
   real on phase 12's four ranks (``count_cell``, which walks the real
   step too): collective bytes, FLOPs and HBM bytes outside the
   data-dependent loops and each operator's FLOPs exactly, the real step's
   walk and ``FlopCounterMode`` equal, the same loops listed, and every
   rank's kernels A-C launched exactly 2 x its lanes x (4, 1, 1).  (c) The full-width dry-run: llama3.2-3b train_4k on
   the 1-pod mesh with the refresh split over all 256 ranks: peak
   estimate, the state's bytes, the refresh's FLOPs by operator,
   collective bytes, roofline terms, ``trace_s``.  (d) A real one-layer
   llama3.2-3b Shampoo step (8 x 128, one process; its refresh runs
   kernels A-C on 2 x 1560 blocks of 256) against its dry-run: the peak
   estimate over the measured peak within ``TOL_PEAK``, FLOPs and HBM
   bytes outside the loops and operator FLOPs exactly, launches exactly
   2 x 1560 x (4, 1, 1).  (e) Each operator's host time a call beside its bare launcher's,
   ``HOST_CALLS`` calls back to back behind a spin kernel, at the
   refresh's shapes (n = 128, 256).  (f) Phase 6a's refresh time, which
   runs through the operators.

The launchers' CLIs of phases 8-10 and the production dry-runs of phases
13 (b) and 14 (c) run one after another in processes of their own while
the main process waits on phase 12's ranks (``Background``); their lines
print, and their gates hold, once phase 12 is done.

Then one JSON line with the kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; so does a machine without a
CUDA device, or a directory that holds this script and nothing else of the
repository.  TF32 is switched off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): every float32 product, the plain
versions' and the yardsticks', runs in full float32.
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

N_MAIN = 4096
N_ROOT = 1024
SEED = 0
# One decoder layer of configs/llama32_3b.py (d_model 3072, kv 1024, d_ff
# 8192) in Shampoo's blocks of 128: wq, wo 576 each; wk, wv 192 each;
# gate, up, down 1536 each.
SHAMPOO_BLOCKS = {"wq": 576, "wo": 576, "wk": 192, "wv": 192, "gate": 1536, "up": 1536, "down": 1536}
# Phase 6a runs a quarter of that layer (phase 8 refreshes a whole layer).
SHAMPOO_6A_BLOCKS = 1536
N_BLOCK = 128
# Phase 8: llama3.2-3b at full width with its depth cut to 1 layer (so
# that the script, phase 9 included, stays near half its time limit), the
# launcher's batch and sequence, 3 steps (step 1 refreshes).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 8, 128, 3
ROOT_BLOCKS = 64
# Phase 9 cells: (arch, layers kept or None for all, batch, prompt, gen,
# layers the float32 gates run on or None for the same).  Random-weight
# granite-moe is chaotic in depth: one ulp moved in its embedding moves
# its float32 logits by 7e-4 of the largest at 4 layers, 8.6e-2 at 8 and
# 0.63 at 32 (scripts/serve_sensitivity.py on an H100), so no two float32
# computations of the 32-layer model agree and its gates run on its
# first 4 layers.
# mamba2-370m and recurrentgemma-2b serve at all their layers, over
# prompts that cross their scans' chunks (256 positions: 2 SSD chunks of
# 128; 544: 2 RG-LRU chunks of 272), and gate on their first 8 layers
# (recurrentgemma's 2 units and its remainder), as llama3.2-3b does: the
# gates' float32 decode loops over every position were the phase's
# longest (cut to keep the script within its time); the frontend
# archs' backbones on tokens, cut as the other dense cells are.  mixtral-8x7b keeps one layer: its 4240
# positions, which wrap the 4096-slot ring, make three decode loops the
# longest of the phase.
SERVE_CELLS = (
    ("llama3.2-3b", None, 8, 64, 32, 8),
    ("codeqwen1.5-7b", 2, 4, 32, 16, None),
    ("stablelm-3b", 2, 4, 32, 16, None),
    ("qwen3-14b", 2, 4, 32, 16, None),
    ("granite-moe-3b-a800m", None, 4, 32, 16, 4),
    ("mixtral-8x7b", 1, 2, 4224, 16, None),
    ("mamba2-370m", None, 4, 240, 16, 8),
    ("recurrentgemma-2b", None, 2, 528, 16, 8),
    ("musicgen-large", 2, 4, 32, 16, None),
    ("llava-next-mistral-7b", 2, 4, 32, 16, None),
)
# Layers the bf16-vs-float32 decode gate runs on, where fewer than the
# float32 gates'.  Random-weight mamba2-370m is chaotic in bf16 with depth:
# the init law draws the stacked w_dt with std 1/sqrt(48), so dt reaches
# ~20, where one bf16 rounding of dt_raw (ulp 2^-3) moves dt A by up to 1
# (A down to -16); its bf16
# decode sits 2.2e-2 (mean) of max|logits| from the float32 forward at 8
# layers, 7.1e-2 at 16 and 0.134 at 48, where its argmax agrees with
# float32's at 1 % of positions, while its float32 decode stays within 2x
# of the forward's 1-ulp change at every depth (scripts/serve_sensitivity.py
# on an H100).
BF16_GATE_LAYERS = {"mamba2-370m": 8}
# The timed serve loop prefills at most this many prompt tokens (its
# figure is ms a step), and the bf16 gate decodes at most this many plus
# the generated ones; the float32 gate decodes every position of the
# longer prompts (mixtral's ring wrap, the RG-LRU's chunks).
SERVE_SHORT_PROMPT = 64
# Phase 10 Shampoo training cuts: (arch, layers, batch, seq, steps, step 1
# repeated bit for bit).  mamba2-370m's 4 of 48 layers over 256 positions
# (two SSD chunks of 128); one (rglru, rglru, attn) unit of
# recurrentgemma-2b over 1024 (two RG-LRU chunks of 512, the checkpointed
# carry in the backward; fewer layers leave a stack of none, which the init
# law cannot draw), not repeated: its refresh is ~8x mamba2's.
FAMILY_TRAIN_CELLS = (
    ("mamba2-370m", 4, 8, 256, 3, True),
    ("recurrentgemma-2b", 3, 4, 1024, 2, False),
)
# Phase 10 frontend cells: (arch, layers), 2 AdamW steps on embeds.
FRONTEND_CELLS = (("musicgen-large", 1), ("llava-next-mistral-7b", 1))
# Phase 11: the multi-device paths on the one card.  Four ranks share it
# over gloo (NCCL refuses two ranks on one device); a world of one rank on
# NCCL runs the code path of a machine with one card a rank.  (a) the
# distributed band reduction at n = 4096, b = 8, nb = 256 with kernel E;
# (b) phase 6a's synthetic refresh at 1538 blocks of 128 (1538 is not a
# multiple of 4: 1540 / 4 = 385 a rank, two identity lanes); (c) phase
# 10's mamba2-370m cell (4 layers, 8 x 256), 2 steps; the world of one runs
# (b) at 64 blocks.
DIST_RANKS = 4
DIST_N, DIST_B, DIST_NB = 4096, 8, 256
DIST_BLOCKS, DIST_NCCL_BLOCKS = 1538, 64
DIST_TRAIN = ("mamba2-370m", 4, 8, 256, 2)
HETERO = ((512, 128), (512, 96), (64, 127))
PAD_BUCKET = 128
N_MEDIUM, B_MEDIUM = 1024, 8
N_DIRECT, N_JACOBI, N_SEQUENTIAL = 1021, 512, 256

# Phase 12: model sharding on a (2, 2) ("data", "model") mesh of four gloo
# ranks sharing the card, at published widths cut in depth, float32
# weights.  (a) llama3.2-3b, 1 layer, 8 x 128, make_policy(fsdp=True)
# (heads mode: 24 / 8 heads on model = 2); (b) the same arch in q_heads and
# cp through explicit policies; (c) granite-moe-3b-a800m, 1 layer, 4 x 128
# (dropping MoE: ep, as resolved, then capacity and tp); (d) (c)'s ep
# step with Shampoo and precond_mesh over both axes.  AdamW starts from a
# second moment of 1 (as the CPU tests do), so an update is linear in the
# gradient and the gathered weights can be held against one process.
SHARD_RANKS = 4
SHARD_DENSE = ("llama3.2-3b", 1, 8, 128)
SHARD_MOE = ("granite-moe-3b-a800m", 1, 4, 128)
# A learning rate of 1, so that float32's rounding of w + dw stays far
# below the gate (one ulp of |w| ~ 4 is 4.8e-7; at a learning rate of 1e-2
# the largest change is ~5e-4, of which one rounding is 1e-3).
SHARD_LR = 1.0
# float32 activations: the sharded loss against the one-process step's,
# relative, and each leaf of the gathered weights against the one-process
# step's, of the step's largest weight change: within 1e-4, or within 2x
# that leaf's own distance between the one-process step and the same step
# in float64 where that is larger (measured in each case,
# :func:`shard_leaf_gate`).  The random-weight models' float32 gradients
# can carry more than 1e-4: llama3.2-3b's tied embedding moves 1.40e-4 of
# the largest change from float64 in one process (this phase on an NVIDIA
# H100 80GB HBM3), so two float32 orders of summation differ by as much
# there.  bf16 activations: the loss within
# SENS_FACTOR x the one-process bf16 loss's change when the embedding moves
# by one bf16 ulp (2^-8 relative, random signs; measured in each case):
# the sharded step rounds each row-split product once more (its partial
# sums, before the float32 reduction), about one ulp of the activations.
TOL_SHARD_LOSS = 1e-5
TOL_SHARD_PARAMS = 1e-4
# The momentum (0.1 x the clipped gradient), leaf by leaf, of the leaf's
# largest entry: the sharded step's distance from the same step in float64
# within 1e-4, or within SHARD_MU_FACTOR x the one-process float32
# momentum's own distance from it where that is larger.  Against one
# process instead, two float32 momenta sit up to the sum of their
# distances from float64 apart, which tests nothing.  The random-weight
# models' float32 momenta sit up to 1.7e-3 from float64 in one process,
# and the sharded ones up to 2.07x as far (cp's w_gate; this phase on an
# NVIDIA H100 80GB HBM3); a dropped gradient sum reads >= 280x (norm
# scales, scripts/shard_gate_fault.py).  A leaf whose change is at
# float32's rounding of the weight (a norm scale's, ~4 ulps of 1 at this
# width) shows a dropped sum only here.  Gated in (a)'s float32 step and
# (c)'s resolved mode: the momentum's gather and float64 step cost ~10 s a
# llama case.
TOL_SHARD_MU = 1e-4
SHARD_MU_FACTOR = 4.0

# Phase 13: (a) tensor parallelism of the mixers and sharded serving, on
# phase 12's world: mamba2-370m at full width cut to 2 layers (8 x 256,
# two SSD chunks) and recurrentgemma-2b at full width cut to one (rglru,
# rglru, attn) unit (4 x 512), float32, make_policy(pure_dp=False) (the
# mixers' width on model; recurrentgemma's MQA decode splits its window),
# each cell's config as the dry-run builds it (launch.dryrun.cell_config).
# One sharded train step under phase 12's float32 gates (the momentum gate
# on mamba2: recurrentgemma's 2.6 GB tied table makes its float64
# reference the largest of the phase), then, under make_policy(fsdp=False)
# (FSDP would gather every weight at every decode step through gloo's host
# copies), make_prefill and a 32-token prompt teacher-forced plus 8 greedy
# tokens through make_serve_step: the
# greedy tokens equal one process's, and the logits (decode_step under the
# resolver, gathered) within phase 9's gate of one process's.  (b) Three
# dry-runs of fake CUDA tensors on the fake production worlds at full
# width and depth.  (c) The dry-run of (a)'s mamba2 cell against the real
# cell on the four ranks (count_cell): rank 0's collective bytes by kind
# and its FLOPs equal exactly; and of a one-process llama3.2-3b cell (1
# layer, 8 x 128) against its real step on the card: the peak estimate
# over the step's peak device memory within TOL_PEAK (set from the
# prediction written in PERF.md before this phase first ran), and the
# step's time over the roofline's bound.
MIXER_CELLS = (("mamba2", "mamba2-370m", 2, 8, 256), ("recurrentgemma", "recurrentgemma-2b", 3, 4, 512))
SERVE13_PROMPT, SERVE13_GEN = 32, 8
DRY_CELLS = (("llama3.2-3b", "train_4k", False), ("mamba2-370m", "long_500k", False),
             ("mixtral-8x7b", "decode_32k", True))
PEAK_CELL = ("llama3.2-3b", 1, 8, 128)
TOL_PEAK = (0.8, 1.25)
# Phase 14: the smoke Shampoo cell of tests/test_torch_dryrun.py (llama3.2-3b's
# smoke config, 1 layer, 11 blocks of 256 a side) on the (2, 2) world, the
# full-width dry-run, and the host cost a call at the refresh's shapes.
SHAMPOO_SMOKE = dict(mesh_override=(2, 2), smoke=True, overrides=dict(n_layers=1),
                     shape_overrides=dict(batch=4, seq=32), optimizer_name="shampoo")
# The card runs the cell with the refresh split over the four ranks (its
# roots gathered); tests/test_torch_dryrun.py runs both modes.
SMOKE_SHARDED = (True,)
# Phase 8's yardstick: batched eigh + root on this many step-1 blocks.
YARDSTICK_BLOCKS = 2048
# Phase 14 (c): the full-width Shampoo dry-run (arch, shape, multi_pod).
SHAMPOO_FULL = ("llama3.2-3b", "train_4k", False)
HOST_SHAPES = (128, 256)
HOST_CALLS = 20

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, the
# float32 rate outside the tensor cores, and the bf16 and TF32 tensor-core
# rates.  float32 work on the tensor cores (kernel D, kernel A's trailing
# phase) is 3xTF32: three TF32 products per product, so its bound is
# 3 x flops over the TF32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 494.7e12
E_CLUSTERS = (1, 2, 4, 8, 16)
E_HOST_CALLS = 200
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's ~2 GHz clock

# Tolerances of the kernel-vs-plain comparisons, relative to the largest
# entry of the plain result: fp32 sums in other orders, grown by the
# reduction length.
TOL_A = 1e-5 * max(8.0, N_MAIN ** 0.5)
TOL_B = 5e-4  # ~3n/b dependent window updates per entry in fp32
TOL_C = 1e-5 * max(8.0, N_MAIN ** 0.5)
# Kernels D and E: the JAX package's own kernel tolerances
# (tests/test_kernels.py): 2e-5 max|ref| for syr2k, and 5e-5 max(|ref|, 1)
# for each of the panel QR's V, T, taus and R.
TOL_D = 2e-5
TOL_E = 5e-5
# Kernel D in bf16: tests/test_kernels.py's bf16 tolerance, 5e-2 max|ref|,
# against the float32 plain version of the same bf16-valued inputs.
TOL_D_BF16 = 5e-2
# Main-path checks: eigenvalues as tests/test_core_eigh.py (3e-4 max|w|);
# ||A V - V diag(w)||_F / ||A||_F and max |V^T V - I|.
TOL_EIG = 3e-4
TOL_RESID = 1e-4
TOL_ORTH = 1e-3
TOL_ROOT = 1e-3
# Serving gates.  Float32 decode against the float32 forward, per position
# the largest |difference| relative to the largest logit: at most 1e-4, or
# 4x the forward's own largest change when its embedding table moves by
# one ulp (measured in each cell) if larger; and at the median position
# within 4x the forward's median change (at least 1e-5).  The random
# weights make the forward ill-conditioned: the init law draws stacked
# leaves with std 1/sqrt(layers) (the JAX package's fan-in rule), so q and
# k entries are large, softmax is nearly one-hot, and rounding flips
# near-tied keys at a few positions (mixtral, 2 layers, 4240 positions:
# a 1-ulp change of 1.9e-5 at the median position, 3.4e-2 at the worst).
# On llama3.2-3b the 1-ulp change grows from 1.9e-5 (1 layer) to 5.4e-4
# (28 layers), and decode sits within 2x of it at every depth
# (scripts/serve_sensitivity.py on an H100).  The bf16 decode against the
# float32 one: mean |difference| over every logit below 0.1 of the largest
# (bf16 rounds each product chain to ~2^-9: 2e-3 on qwen3-14b, 2 layers,
# to 7e-2 on mixtral, where it flips near-tied keys at many positions).
TOL_SERVE = 1e-4
SENS_FACTOR = 4.0
TOL_SERVE_BF16 = 0.1
# Phase 11: the distributed band against the one-process band_reduce with
# the same arithmetic, of max|B| (tests/test_sharding_multidevice.py's
# tolerance); its eigenvalues, and those of the one-process band on kernel
# D, against float64 eigvalsh(A), of max|w| (both read ~1e-7 on an H100:
# 4.3e-8 and 1.0e-7 at n = 4096); compressed_psum against the int8
# algorithm's value from every rank's input, entry by entry (float32
# rounding of the scales' sum and the rescale), and of a replicated input
# against itself (the JAX test's gate).
TOL_BAND = 1e-4
TOL_BAND_EIG = 1e-6
TOL_PSUM_EXACT = 1e-6
TOL_PSUM = 0.02
# A bucket against plan(n) one matrix at a time (tests/test_torch_plan.py's
# tolerances): eigenvalues at 1e-5 max|w|; sign-aligned vectors at 1e-4.
TOL_LOOP_W = 1e-5
TOL_LOOP_V = 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean time of ``fn(*setup())`` over ``reps`` calls issued back to back
    between two CUDA events, after one warm-up call; ``setup`` runs for
    every call before the timed window.  A spin kernel of ~25 ms
    (``torch.cuda._sleep``) is queued before the first event, so the calls
    are enqueued while it runs and the window holds device work only, also
    for a kernel shorter than its launcher's host work (as long as the
    calls' host work takes less than the spin)."""
    args = [setup() if setup else () for _ in range(reps + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for a in args[1:]:
        fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, *work):
    """The least time (ms) the card could take to move ``nbytes`` and do
    each ``(flops, peak FLOP/s)`` of ``work``, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_bound(w):
    """:func:`bound` of a kernel's ``repro_torch.kernels.work.Work``: fp32
    work at the fp32 rate, 3xTF32 at 3 x flops over the TF32 rate, bf16 at
    the bf16 tensor-core rate."""
    rates = {"fp32": (1, PEAK_FP32_FLOP_PER_S), "tf32x3": (3, PEAK_TF32_FLOP_PER_S),
             "bf16": (1, PEAK_BF16_FLOP_PER_S)}
    return bound(w.bytes, *((rates[r][0] * f, rates[r][1]) for f, r in w.flops))


def device_split(torch, fn):
    """Device time per CUDA kernel name of one ``fn()`` call, from
    ``torch.profiler`` (empty when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.key).split("(")[0]
            rows.append((name[:48], us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def print_split(label: str, split, ms: float) -> None:
    print(f"{label} device time by CUDA kernel (torch.profiler): " + (
        "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in split[:8]) or "not measured")
        + (f"; sum {sum(t for _, t, _ in split):.3f} ms of {ms:.3f} ms timed" if split else ""))


def share(bound_ms: float, ms: float) -> str:
    return f"share of bound {bound_ms / ms:.2%}"


def rel_err(x, y) -> float:
    x, y = x.double(), y.double()
    return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))


def phase_kernels(torch, gen):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.core.bulge_chasing import chase_wavefront_slices, num_wavefronts
    from repro_torch.kernels import cuda_lib, ref, work
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.kernels import panel as ke
    from repro_torch.kernels.panel import panel_qr_body, panel_qr_cuda, panel_qr_cuda_cluster
    from repro_torch.kernels.syr2k import syr2k_cuda, trailing_update_cuda
    from repro_torch.solver import resolve_blocking

    n = N_MAIN
    dec = resolve_blocking(n, device_type="cuda")
    b = dec.b
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    rows = {}

    # --- kernel A: the first block of the main path (m = n, w = nb) ------
    e0 = build_stage_schedule(n, b, dec.nb).entries[0]
    m, w = e0.m, e0.w
    Bk, Vk, Tk = fused_panel_update_cuda(A.clone(), b, w)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    torch.cuda.synchronize()
    errs = [rel_err(Bk, Bp), rel_err(Vk, Vp), rel_err(Tk, Tp)]
    max_abs = max(float((Bk - Bp).abs().max()), float((Vk - Vp).abs().max()), float((Tk - Tp).abs().max()))
    require(max(errs) < TOL_A, f"kernel A vs plain rel err {errs} >= {TOL_A}")
    ms = cuda_ms(torch, lambda B: fused_panel_update_cuda(B, b, w), 5, lambda: (A.clone(),))
    plain_ms = cuda_ms(torch, lambda B: ref.fused_panel_update_ref(B, b, w), 2, lambda: (A.clone(),))
    mt = m - w
    C = A[w:, w:].contiguous()
    Z = torch.randn((mt, w), generator=gen, device="cuda")
    V = torch.randn((mt, w), generator=gen, device="cuda")
    lib_ms = cuda_ms(torch, lambda: C - Z @ V.T - V @ Z.T, 5)
    q = w // b
    bms, by = work_bound(work.fused_panel_update(m, w, b))
    print(f"phase 2 kernel A fused_panel_update m={m} w={w} b={b}: rel err B/V/T "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {TOL_A:.1e}) max_abs_err={max_abs:.3e}")
    print(f"phase 2 kernel A ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}: panel "
          f"flops at the fp32 SIMT rate, the trailing phase at 3 x flops over the TF32 rate "
          f"{PEAK_TF32_FLOP_PER_S / 1e12:.1f} TFLOP/s, 3xTF32), "
          f"{share(bms, ms)}; not the same function, its trailing phase only: "
          f"C - Z V^T - V Z^T (2 torch.matmul) ms={lib_ms:.4f}")
    # A yardstick for the panel GEMV, which reads an (m, m - r0) view of Bv
    # once per panel (the view is larger than L2): PyTorch's row sums of
    # the first panel's view, one strided read of it.
    view = A[:, b:]
    read_ms = cuda_ms(torch, lambda: view.sum(dim=1), 10)
    print(f"phase 2 kernel A GEMV yardstick: view ({m}, {m - b}).sum(dim=1) ms={read_ms:.4f} "
          f"({m * (m - b) * 4 / read_ms / 1e9:.3f} TB/s)")
    # Kernel A over one solve: the calls band_reduce makes, each on the
    # trailing view the previous one left.
    entries = build_stage_schedule(n, b, dec.nb).entries
    solve_ms = cuda_ms(torch, lambda B: [fused_panel_update_cuda(B[e.ci:, e.ci:], b, e.w)
                                         for e in entries], 3, lambda: (A.clone(),))
    print(f"phase 2 kernel A over one solve's {len(entries)} calls (m = {entries[0].m} .. "
          f"{entries[-1].m}) ms={solve_ms:.4f}")
    gemv_bytes = sum(m * (m - (j + 1) * b) * 4.0 for j in range(q))
    ms_a, A_prof = ms, A.clone()
    rows["fused_panel_update"] = dict(max_abs_err=max_abs, compared="B, V and Ts entrywise",
                                      ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by, library_ms=lib_ms,
                                      library="not the same function: C - Z @ V.T - V @ Z.T, "
                                              "the trailing phase only")

    # --- kernel B: the chase of the main path's band matrix, with the log -
    Bband = band_reduce(A, b, dec.nb)
    Tk, lk = bulge_wavefront_cuda(Bband, b, return_log=True)
    t0 = time.perf_counter()
    Tp, lp = chase_wavefront_slices(Bband, b, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(lk.row0, lp.row0), "kernel B row0 differs from plain")
    active = lp.row0 < n
    require(bool((lk.taus[~active] == 0).all()), "kernel B inactive slot with tau != 0")
    eT = rel_err(Tk, Tp)
    # The log is held to what it must satisfy, B = Q2 T Q2^T, applied with
    # the plain back-transform: reflector by reflector, a log is only
    # determined up to rounding amplified by 1/|x| where the column x to
    # eliminate is already tiny, so an entrywise comparison with the plain
    # log (reported: tau v v^T) is ill-posed at this size.
    vs_k, taus_k = sweep_major_log(lk)
    QT = backtransform_wy_xla(Tk, vs_k, taus_k, b=b)
    recon = backtransform_wy_xla(QT.T.contiguous(), vs_k, taus_k, b=b)
    eR = rel_err(recon, Bband)
    Hk = lk.taus[active][:, None, None] * lk.vs[active][:, :, None] * lk.vs[active][:, None, :]
    Hp = lp.taus[active][:, None, None] * lp.vs[active][:, :, None] * lp.vs[active][:, None, :]
    eH = rel_err(Hk, Hp)
    # T is held through what is well conditioned: its spectrum against the
    # plain T's, its exact tridiagonal structure, and the reconstruction.
    off = (torch.arange(n, device="cuda")[:, None] - torch.arange(n, device="cuda")[None, :]).abs() > 1
    lam_k = torch.linalg.eigvalsh(Tk.double())
    lam_p = torch.linalg.eigvalsh(Tp.double())
    eL = rel_err(lam_k, lam_p)
    max_abs = float((lam_k - lam_p).abs().max())
    require(bool((Tk[off] == 0).all()), "kernel B output is not exactly tridiagonal")
    require(eL < TOL_B and eR < TOL_B,
            f"kernel B: eigenvalues of T vs plain {eL}, ||Q2 T Q2^T - B|| {eR} (tol {TOL_B})")
    Tv = bulge_wavefront_cuda(Bband, b)
    require(torch.equal(Tv, Tk), "kernel B values-only run differs from the logged run")
    Tk2, lk2 = bulge_wavefront_cuda(Bband, b, return_log=True)
    require(torch.equal(Tk2, Tk) and torch.equal(lk2.vs, lk.vs) and torch.equal(lk2.taus, lk.taus),
            "kernel B differs between two logged runs")
    cuda_lib.reset_launch_counts()
    bulge_wavefront_cuda(Bband, b, return_log=True)
    per_call = cuda_lib.device_launch_counts()["bulge_wavefront"]
    require(per_call == 1, f"kernel B made {per_call} CUDA launches in one call, expected 1")
    ms = cuda_ms(torch, lambda: bulge_wavefront_cuda(Bband, b, return_log=True), 3)
    ms_values = cuda_ms(torch, lambda: bulge_wavefront_cuda(Bband, b), 3)
    steps = num_wavefronts(n, b)
    n_ops = int(active.sum())
    require(n_ops == work.chase_ops(n, b), f"kernel B's log has {n_ops} active slots, the schedule "
            f"{work.chase_ops(n, b)} chase ops")
    Wn, An = lk.taus.shape
    bms, by = work_bound(work.bulge_wavefront(n, b))
    print(f"phase 2 kernel B bulge_wavefront n={n} b={b} wavefronts={Wn} slots={An} ops={n_ops}: "
          f"eig(T) vs plain {eL:.3e} (max_abs_err={max_abs:.3e}), Q2 T Q2^T vs B {eR:.3e} "
          f"(tol {TOL_B:.1e}); T exactly tridiagonal; row0 exact; entrywise vs plain, "
          f"reported only: T {eT:.3e}, tau v v^T {eH:.3e}")
    print(f"phase 2 kernel B ms={ms:.4f} ({ms / steps * 1e3:.3f} us per dependent step, "
          f"{steps} steps; without the log ms={ms_values:.4f}, {ms_values / steps * 1e3:.3f} us) "
          f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}), {share(bms, ms)}; "
          f"CUDA launches per call {per_call}; library: none; bitwise equal over two calls")
    rows["bulge_wavefront"] = dict(max_abs_err=max_abs, compared="eigenvalues of T",
                                   ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                   bound_by=by, library_ms=None, us_per_step=ms / steps * 1e3,
                                   ms_without_log=ms_values)

    # --- kernel C: Q2 and Q2^T on a full (n, n) panel ---------------------
    vs, taus = sweep_major_log(lk)
    X = torch.randn((n, n), generator=gen, device="cuda")
    errs, max_abs = [], 0.0
    for transpose in (False, True):
        Yk = backtransform_wy_cuda(X, vs, taus, b=b, transpose=transpose)
        Yp = backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)
        torch.cuda.synchronize()
        errs.append(rel_err(Yk, Yp))
        max_abs = max(max_abs, float((Yk - Yp).abs().max()))
    require(max(errs) < TOL_C, f"kernel C vs plain rel err {errs} >= {TOL_C}")
    ms = cuda_ms(torch, lambda: backtransform_wy_cuda(X, vs, taus, b=b), 3)
    plain_ms = cuda_ms(torch, lambda: backtransform_wy_xla(X, vs, taus, b=b), 1)
    S, K, _ = vs.shape
    n_refl = int((taus != 0).sum())
    bms, by = work_bound(work.backtransform_wy(n, n, S, K, b))
    print(f"phase 2 kernel C backtransform_wy (n, m)=({n}, {n}) S={S} K={K}: rel err Q2/Q2^T "
          f"{errs[0]:.3e}/{errs[1]:.3e} (tol {TOL_C:.1e}) max_abs_err={max_abs:.3e}; reflectors with "
          f"tau != 0 {n_refl} of the schedule's {work.chase_ops(n, b)} (the bound counts the schedule's)")
    print(f"phase 2 kernel C ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}), "
          f"{share(bms, ms)}; library: none")
    # One profiler session for A, B, C and one band_reduce(panel_method=
    # "kernel") call, kernel E's path (a second session in one process
    # recorded no device time on the card).
    split = device_split(torch, lambda: (fused_panel_update_cuda(A_prof, b, w),
                                         bulge_wavefront_cuda(Bband, b, return_log=True),
                                         backtransform_wy_cuda(X, vs, taus, b=b),
                                         band_reduce(A, b, dec.nb, panel_method="kernel")))
    split_a = [r for r in split if r[0].startswith(("panel_", "trailing_lower", "write_f"))
               and not r[0].startswith("panel_qr_wy")]
    print_split("phase 2 kernel A", split_a, ms_a)
    for name, t, cnt in split_a:
        if name.startswith("panel_gemv"):
            print(f"phase 2 kernel A panel_gemv {t / cnt * 1e3:.1f} us a panel, reads its views at "
                  f"{gemv_bytes / t / 1e9:.3f} TB/s ({gemv_bytes / t / 1e9 / (PEAK_BYTES_PER_S / 1e12):.1%} "
                  f"of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    print_split("phase 2 kernel B", [r for r in split if r[0].startswith("bulge")],
                rows["bulge_wavefront"]["ms"])
    print_split("phase 2 kernel C", [r for r in split if r[0].startswith(("regroup_log", "backtransform"))], ms)
    # Kernel E's CUDA launches over one band_reduce call, from the trace.
    split_e = [r for r in split if r[0].startswith("panel_qr_wy")]
    e_traced = (sum(c for _, _, c in split_e), sum(t for _, t, _ in split_e))
    num_panels = build_stage_schedule(n, b, dec.nb).num_panels
    print(f'phase 2 kernel E inside band_reduce(A, {b}, {dec.nb}, panel_method="kernel"), by '
          f"torch.profiler: {e_traced[0]} CUDA launches of panel_qr_wy ({num_panels} panels), "
          f"device time sum {e_traced[1]:.3f} ms, " + (
              f"{e_traced[1] / e_traced[0] * 1e3:.1f} us a launch" if e_traced[0] else "not measured"))
    require(not split or e_traced[0] == num_panels,
            f"phase 2 band_reduce traced {e_traced[0]} panel_qr launches, expected {num_panels}")
    rows["backtransform_wy"] = dict(max_abs_err=max_abs, compared="Q2 X and Q2^T X entrywise",
                                    ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, library_ms=None)

    # --- kernel D: the first trailing update of the unfused path ----------
    # C is the strided trailing view A[w:, w:], as band_reduce hands it over.
    C = A[w:, w:]
    Y = torch.randn((mt, w), generator=gen, device="cuda")
    Z = torch.randn((mt, w), generator=gen, device="cuda")
    errs, max_abs = [], 0.0
    for label, Dk, Dp in (
        ("C - Z Y^T - Y Z^T", trailing_update_cuda(C, Y, Z), ref.syr2k_ref(Z, Y, C, alpha=-1.0)),
        ("Z Y^T + Y Z^T (C absent)", syr2k_cuda(Z, Y), ref.syr2k_ref(Z, Y)),
    ):
        torch.cuda.synchronize()
        require(torch.equal(Dk, Dk.T), f"kernel D output not exactly symmetric ({label})")
        errs.append(float((Dk - Dp).abs().max()) / float(Dp.abs().max()))
        max_abs = max(max_abs, float((Dk - Dp).abs().max()))
    require(max(errs) < TOL_D, f"kernel D vs plain rel err {errs} >= {TOL_D}")
    ms = cuda_ms(torch, lambda: trailing_update_cuda(C, Y, Z), 10)
    plain_ms = cuda_ms(torch, lambda: ref.syr2k_ref(Z, Y, C, alpha=-1.0), 5)
    lib_ms = cuda_ms(torch, lambda: C - Z @ Y.T - Y @ Z.T, 10)
    bms, by = work_bound(work.syr2k(mt, w))
    print(f"phase 2 kernel D trailing_update (n, k)=({mt}, {w}): rel err with C / C absent "
          f"{errs[0]:.3e}/{errs[1]:.3e} (tol {TOL_D:.0e}) max_abs_err={max_abs:.3e}; "
          f"exactly symmetric")
    print(f"phase 2 kernel D ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}, 3xTF32: "
          f"3 x flops over the TF32 rate {PEAK_TF32_FLOP_PER_S / 1e12:.1f} TFLOP/s), "
          f"{share(bms, ms)}; library C - Z Y^T - Y Z^T (2 torch.matmul) ms={lib_ms:.4f}")
    # bf16 operands: summed in float32, rounded once (the JAX kernel's
    # contract); held against the float32 plain version of the same values.
    Cb, Yb, Zb = (t.to(torch.bfloat16) for t in (C, Y, Z))
    Dk = trailing_update_cuda(Cb, Yb, Zb)
    Dp = ref.syr2k_ref(Zb.float(), Yb.float(), Cb.float(), alpha=-1.0)
    torch.cuda.synchronize()
    require(Dk.dtype == torch.bfloat16 and torch.equal(Dk, Dk.T), "kernel D bf16 output dtype / symmetry")
    bf_max_abs = float((Dk.float() - Dp).abs().max())
    bf_err = bf_max_abs / float(Dp.abs().max())
    require(bf_err < TOL_D_BF16, f"kernel D bf16 vs plain rel err {bf_err} >= {TOL_D_BF16}")
    bf_ms = cuda_ms(torch, lambda: trailing_update_cuda(Cb, Yb, Zb), 10)
    bf_plain_ms = cuda_ms(torch, lambda: ref.syr2k_ref(Zb, Yb, Cb, alpha=-1.0), 5)
    bf_lib_ms = cuda_ms(torch, lambda: Cb - Zb @ Yb.T - Yb @ Zb.T, 10)
    bf_bms, bf_by = work_bound(work.syr2k(mt, w, itemsize=2))
    print(f"phase 2 kernel D bf16 trailing_update (n, k)=({mt}, {w}): rel err {bf_err:.3e} "
          f"(tol {TOL_D_BF16:.0e}) max_abs_err={bf_max_abs:.3e}; exactly symmetric")
    print(f"phase 2 kernel D bf16 ms={bf_ms:.4f} plain_ms={bf_plain_ms:.4f} (bf16 torch ops) "
          f"bound_ms={bf_bms:.4f} ({bf_by}, bf16 tensor-core rate {PEAK_BF16_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s), {share(bf_bms, bf_ms)}; "
          f"library C - Z Y^T - Y Z^T in bf16 (2 torch.matmul) ms={bf_lib_ms:.4f}, "
          f"{share(bf_bms, bf_lib_ms)}; kernel / library {bf_ms / bf_lib_ms:.2f}x")
    rows["syr2k"] = dict(max_abs_err=max_abs, compared="C + alpha (A B^T + B A^T) entrywise, with "
                         "and without C; exact symmetry", ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms,
                         library="C - Z @ Y.T - Y @ Z.T (2 torch.matmul)",
                         bf16=dict(max_abs_err=bf_max_abs, ms=bf_ms, plain_ms=bf_plain_ms,
                                   bound_ms=bf_bms, bound_by=bf_by, library_ms=bf_lib_ms))

    # --- kernel E: the path's largest panel, and one twice n tall ----------
    # First the cluster sizes at the largest panel, then both panels at the
    # launcher's own size (panel_qr.cluster_size).
    sweep = {}
    for m_e in (256, 1024, n - b, 2 * n):
        P = torch.randn((m_e, b), generator=gen, device="cuda")
        want = panel_qr_body(P, b, lapack_sign=False)
        for cs in E_CLUSTERS:
            got = panel_qr_cuda_cluster(P, cs)
            torch.cuda.synchronize()
            err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1.0) for x, y in zip(got, want))
            require(err < TOL_E, f"kernel E (m={m_e}, {cs} CTAs) vs plain rel err {err} >= {TOL_E}")
            used = ke.launch_plan(m_e, b, cs)[0]
            sweep[(m_e, cs)] = cuda_ms(torch, lambda: panel_qr_cuda_cluster(P, cs), 50)
            print(f"phase 2 kernel E cluster sweep (m, b)=({m_e}, {b}): asked {cs} CTAs, ran {used}, "
                  f"{-(-m_e // used)} rows per CTA: ms={sweep[(m_e, cs)]:.4f} rel err {err:.3e}")
    for m_e in (n - b, 2 * n):
        P = torch.randn((m_e, b), generator=gen, device="cuda")
        got = panel_qr_cuda(P)
        want = panel_qr_body(P, b, lapack_sign=False)
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) / max(float(y.abs().max()), 1.0) for x, y in zip(got, want)]
        max_abs = max(float((x - y).abs().max()) for x, y in zip(got, want))
        require(max(errs) < TOL_E, f"kernel E (m={m_e}) vs plain rel err V/T/taus/R {errs} >= {TOL_E}")
        ms = cuda_ms(torch, lambda: panel_qr_cuda(P), 50)
        plain_ms = cuda_ms(torch, lambda: panel_qr_body(P, b, lapack_sign=False), 3)
        geqrf_ms = cuda_ms(torch, lambda: torch.geqrf(P), 10)
        # Per call with the launcher's host work: calls back to back on the
        # host clock, closed by one synchronize.
        # Each call's outputs are dropped before the next, as in a panel loop.
        def calls():
            for _ in range(E_HOST_CALLS):
                panel_qr_cuda(P)

        host_ms = wall_ms(torch, calls) / E_HOST_CALLS
        bms, by = work_bound(work.panel_qr(m_e, b))
        cs, in_smem = ke.launch_plan(m_e, b, ke.cluster_size(m_e))
        rows_per_cta = -(-m_e // cs)
        print(f"phase 2 kernel E panel_qr (m, b)=({m_e}, {b}) on a cluster of {cs} CTAs, "
              f"{rows_per_cta} rows per CTA, slices in {'shared' if in_smem else 'global'} memory: "
              f"rel err V/T/taus/R " + "/".join(f"{e:.3e}" for e in errs)
              + f" (tol {TOL_E:.0e}) max_abs_err={max_abs:.3e}")
        print(f"phase 2 kernel E ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.6f} ({by}), "
              f"{share(bms, ms)}; not the same function, the nearest call torch.geqrf "
              f"(LAPACK signs, no T) ms={geqrf_ms:.4f}; with the launcher's host work "
              f"{host_ms:.4f} ms a call ({E_HOST_CALLS} calls back to back, host clock)")
        if m_e == n - b:
            P_e = P
            rows["panel_qr"] = dict(max_abs_err=max_abs, compared="V, T, taus and R entrywise",
                                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                    library_ms=geqrf_ms,
                                    library="not the same function: torch.geqrf, the nearest "
                                            "call (LAPACK signs, no T)",
                                    cluster=cs, rows_per_cta=rows_per_cta, host_ms=host_ms,
                                    band_reduce_traced=dict(launches=e_traced[0], device_ms=e_traced[1]),
                                    cluster_sweep_ms={f"{m}x{cs}": v for (m, cs), v in sweep.items()})
    inputs = dict(A=A, b=b, w=w, band=Bband, X=X, vs=vs, taus=taus, C=C, Y=Y, Z=Z, P=P_e)
    return rows, inputs


def max_eig_err(w, w_ref) -> float:
    return float((w.double() - w_ref).abs().max()) / float(w_ref.abs().max())


def check_evd(torch, phase: str, A, w, V):
    """The main-path gates on ``w, V = plan(A)``; returns eigvalsh(A) in
    float64."""
    n = A.shape[0]
    w_ref = torch.linalg.eigvalsh(A.double())
    scale = float(w_ref.abs().max())
    e_eig = max_eig_err(w, w_ref)
    Ad, Vd = A.double(), V.double()
    resid = float(torch.linalg.norm(Ad @ Vd - Vd * w.double()[None, :]) / torch.linalg.norm(Ad))
    col = float(torch.linalg.norm(Ad @ Vd - Vd * w.double()[None, :], dim=0).max()) / scale
    orth = float((Vd.T @ Vd - torch.eye(n, dtype=torch.float64, device="cuda")).abs().max())
    print(f"{phase} eigenvalues max|w - w_ref|/max|w| = {e_eig:.3e} (tol {TOL_EIG:.0e}); "
          f"||AV - VW||_F/||A||_F = {resid:.3e} (tol {TOL_RESID:.0e}); worst column "
          f"||Av - wv||/||A||_2 = {col:.3e}; max|V^T V - I| = {orth:.3e} (tol {TOL_ORTH:.0e})")
    require(e_eig < TOL_EIG, f"{phase} eigenvalues")
    require(resid < TOL_RESID, f"{phase} residual")
    require(orth < TOL_ORTH, f"{phase} orthogonality")
    require(bool(torch.isfinite(V).all()) and tuple(V.shape) == (n, n), f"{phase} V finite, (n, n)")
    return w_ref


def stage_times(torch, phase: str, A, pl):
    """One EVD through the plan's stages, each closed by a synchronize:
    ``(w, V, ms)``, ``ms`` the whole run's."""
    from repro_torch.solver.plan import _execute

    stages = {}
    last = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = t0 = time.perf_counter()
    w, V = _execute(A, pl, True, on_stage=mark)
    print(f"{phase} stages ms: " + ", ".join(f"{k}={v:.1f}" for k, v in stages.items()))
    return w, V, (last[0] - t0) * 1e3


def phase_main_path(torch, gen):
    """Phase 3: the main path at n = 4096 through the plan API."""
    from repro_torch.core.band_reduction import build_stage_schedule
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan

    n = N_MAIN
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    pl = plan(n, torch.float32, EvdConfig())
    print(f"phase 3 {pl.describe()}")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, V = pl(A)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = cuda_lib.launch_counts()
    device_launches = cuda_lib.device_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3 launches on the main path: {launches}; CUDA launches {device_launches}")
    # One kernel-A call per DBR block (4 CUDA launches per panel, 3 for the
    # first, + 2), one kernel-B call (one persistent launch), one kernel-C
    # call (the log's regroup, then the apply).
    entries = build_stage_schedule(n, pl.b, pl.nb).entries
    want = {"fused_panel_update": len(entries), "bulge_wavefront": 1, "backtransform_wy": 1}
    want_device = {"fused_panel_update": sum(4 * (e.w // pl.b) + 1 for e in entries),
                   "bulge_wavefront": 1, "backtransform_wy": 2}
    got = {op: launches[op] for op in launches if launches[op] or op in want}
    got_device = {op: device_launches[op] for op in want}
    require(got == want, f"main-path launches {got}, expected {want}")
    require(got_device == want_device, f"main-path CUDA launches {got_device}, expected {want_device}")

    # Its stages are timed in phase 5's run (the same executor, unfused):
    # a second fused run for them cost ~21 s.
    w_ref = check_evd(torch, "phase 3", A, w, V)

    out = {}
    ev_ms = wall_ms(torch, lambda: out.setdefault("w", pl.eigvals(A)))
    w2 = out["w"]
    require(max_eig_err(w2, w_ref) < TOL_EIG, "main-path eigvals()")
    torch.linalg.eigh(A)  # warm cuSOLVER
    eigh_ms = wall_ms(torch, lambda: torch.linalg.eigh(A))
    eigvalsh_ms = wall_ms(torch, lambda: torch.linalg.eigvalsh(A))
    print(f"phase 3 end to end n={n} fp32: plan(A) {e2e_ms:.1f} ms, eigvals {ev_ms:.1f} ms; "
          f"torch.linalg.eigh {eigh_ms:.1f} ms, eigvalsh {eigvalsh_ms:.1f} ms; "
          f"peak memory {peak / 2**20:.0f} MiB")
    return launches, device_launches


def phase_inverse_root(torch, gen):
    """Phase 4: inverse_pth_root at the Shampoo block size."""
    from repro_torch.solver import EvdConfig, plan

    n, p, eps = N_ROOT, 4, 1e-6
    G = torch.randn((n, 2 * n), generator=gen, device="cuda") / (2 * n) ** 0.5
    S = G @ G.T + 0.1 * torch.eye(n, device="cuda")
    X = plan(n, torch.float32, EvdConfig()).inverse_pth_root(S, p, eps=eps)
    w, V = torch.linalg.eigh(S.double())
    ridge = eps * max(float(w.max()), 1e-30)
    X_ref = (V * (w.clamp(min=0) + ridge).pow(-1.0 / p)[None, :]) @ V.T
    err = rel_err(X, X_ref)
    print(f"phase 4 inverse_pth_root n={n} p={p}: rel err vs float64 eigh {err:.3e} (tol {TOL_ROOT:.0e})")
    require(err < TOL_ROOT and bool(torch.isfinite(X).all()), "inverse_pth_root")


def phase_unfused(torch, gen):
    """Phase 5: the unfused first stage at n = 4096 (kernels D, B, C and,
    through ``panel_method="kernel"``, E)."""
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan

    n = N_MAIN
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    pl = plan(n, torch.float32, EvdConfig(tridiag="unfused"))
    schedule = build_stage_schedule(n, pl.b, pl.nb)
    blocks = len(schedule.entries)
    print(f"phase 5 {pl.describe()}; {blocks} DBR blocks, {schedule.num_panels} panels")

    def expect(label, launches, want):
        got = {op: launches[op] for op in launches if launches[op] or op in want}
        print(f"phase 5 launches, {label}: {got}")
        require(got == want, f"phase 5 {label}: launches {got}, expected {want}")

    # One run, its stages timed (closed by a synchronize each): the plan's
    # executor, as plan(A) calls it (a second, untimed run cost ~40 s).
    cuda_lib.reset_launch_counts()
    w, V, e2e_ms = stage_times(torch, "phase 5", A, pl)
    launches = cuda_lib.launch_counts()
    device_launches = cuda_lib.device_launch_counts()
    # The chase with a log is plain tensor code on the card (chase_wavefront).
    expect("plan(A)", launches, {"trailing_update": blocks, "backtransform_wy": 1})
    require(device_launches["trailing_update"] == blocks and device_launches["backtransform_wy"] == 2,
            f"phase 5 plan(A) CUDA launches {device_launches}")
    w_ref = check_evd(torch, "phase 5", A, w, V)

    out = {}
    cuda_lib.reset_launch_counts()
    ev_ms = wall_ms(torch, lambda: out.setdefault("w", pl.eigvals(A)))
    expect(".eigvals(A)", cuda_lib.launch_counts(),
           {"trailing_update": blocks, "bulge_wavefront": 1})
    ev_device = cuda_lib.device_launch_counts()
    require(ev_device["trailing_update"] == blocks and ev_device["bulge_wavefront"] == 1,
            f"phase 5 .eigvals(A) CUDA launches {ev_device}")
    e_ev = max_eig_err(out["w"], w_ref)
    print(f"phase 5 eigvals max|w - w_ref|/max|w| = {e_ev:.3e} (tol {TOL_EIG:.0e})")
    require(e_ev < TOL_EIG, "phase 5 eigvals()")
    print(f"phase 5 end to end n={n} fp32, tridiag=unfused: plan(A) {e2e_ms:.1f} ms, "
          f"eigvals {ev_ms:.1f} ms")

    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Bband = band_reduce(A, pl.b, pl.nb, panel_method="kernel")
    torch.cuda.synchronize()
    br_ms = (time.perf_counter() - t0) * 1e3
    panel_launches = cuda_lib.launch_counts()
    expect('band_reduce(panel_method="kernel")', panel_launches,
           {"trailing_update": blocks, "panel_qr": schedule.num_panels})
    # The CUDA launches each wrapper declares (kernel E's are also counted
    # in phase 2's profiler trace of a band_reduce call).
    panel_device = cuda_lib.device_launch_counts()
    require(panel_device["panel_qr"] == schedule.num_panels and panel_device["trailing_update"] == blocks,
            f'phase 5 band_reduce(panel_method="kernel") declared CUDA launches {panel_device}, expected '
            f"{schedule.num_panels} panel_qr (one cluster launch a panel) and {blocks} trailing_update")
    e_band = max_eig_err(torch.linalg.eigvalsh(Bband.double()), w_ref)
    i = torch.arange(n, device="cuda")
    require(bool((Bband[(i[:, None] - i[None, :]).abs() > pl.b] == 0).all()),
            "phase 5 band_reduce output is not banded")
    print(f"phase 5 band_reduce(A, {pl.b}, {pl.nb}, panel_method=\"kernel\") {br_ms:.1f} ms: "
          f"eigenvalues of the band vs eigvalsh(A) {e_band:.3e} (tol {TOL_EIG:.0e})")
    require(e_band < TOL_EIG, "phase 5 band_reduce(panel_method='kernel') eigenvalues")
    return (
        {"syr2k": launches["syr2k"] + launches["trailing_update"], "panel_qr": panel_launches["panel_qr"]},
        {"syr2k": device_launches["syr2k"] + device_launches["trailing_update"],
         "panel_qr": panel_device["panel_qr"]},
    )


def check_bucket(torch, phase: str, A, w, V) -> None:
    """Phase 3's gates on every matrix of a bucket A (B, n, n) with its
    ``w`` (B, n) and ``V`` (B, n, n); prints the worst of each over the
    bucket."""
    B, n = A.shape[0], A.shape[-1]
    Ad, Vd, wd = A.double(), V.double(), w.double()
    w_ref = torch.linalg.eigvalsh(Ad)
    e_eig = float(((wd - w_ref).abs().amax(-1) / w_ref.abs().amax(-1)).max())
    R = Ad @ Vd - Vd * wd[:, None, :]
    resid = float((torch.linalg.norm(R, dim=(-2, -1)) / torch.linalg.norm(Ad, dim=(-2, -1))).max())
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    orth = float((Vd.mT @ Vd - eye).abs().amax((-2, -1)).max())
    print(f"{phase} ({B} matrices, worst of each): eigenvalues max|w - w_ref|/max|w| = {e_eig:.3e} "
          f"(tol {TOL_EIG:.0e}); ||AV - VW||_F/||A||_F = {resid:.3e} (tol {TOL_RESID:.0e}); "
          f"max|V^T V - I| = {orth:.3e} (tol {TOL_ORTH:.0e})")
    require(e_eig < TOL_EIG, f"{phase} eigenvalues")
    require(resid < TOL_RESID, f"{phase} residual")
    require(orth < TOL_ORTH, f"{phase} orthogonality")
    require(bool(torch.isfinite(V).all()) and tuple(V.shape) == (B, n, n), f"{phase} V finite, (B, n, n)")


def solve_launches(pl) -> dict:
    """Kernel calls of one two-stage ``plan`` solve with eigenvectors:
    kernel A once per DBR block (D on the unfused path), B once (the fused
    generation), C once."""
    from repro_torch.core.band_reduction import build_stage_schedule

    blocks = len(build_stage_schedule(pl.n, pl.b, pl.nb).entries)
    if pl.tridiag == "unfused":
        return {"trailing_update": blocks, "backtransform_wy": 1}
    return {"fused_panel_update": blocks, "bulge_wavefront": 1, "backtransform_wy": 1}


def nonzero(counts) -> dict:
    return {op: c for op, c in counts.items() if c}


def phase_shampoo(torch, gen):
    """Phase 6a: one decoder layer's Shampoo refresh through solve_many."""
    from repro_torch.core.backtransform import sweep_major_log
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.solver import EvdConfig, batch_plan, plan, solve_many
    from repro_torch.solver.plan import _execute_bucket

    n, p, eps = N_BLOCK, 4, 1e-6
    B = SHAMPOO_6A_BLOCKS
    cfg = EvdConfig(b=8, nb=64)
    G = torch.randn((B, n, 2 * n), generator=gen, device="cuda")
    S = G @ G.mT / (2 * n) + 1e-3 * torch.eye(n, device="cuda")
    del G
    pl = plan(n, torch.float32, cfg)
    print(f"phase 6 Shampoo refresh: {B} blocks of {n} (of one layer's {sum(SHAMPOO_BLOCKS.values())}: "
          f"{SHAMPOO_BLOCKS}), G G^T/{2 * n} + 1e-3 I; "
          f"{pl.describe()}")
    cuda_lib.reset_launch_counts()
    pl.inverse_pth_root(S[0], p, eps=eps)
    torch.cuda.synchronize()
    one, one_dev = nonzero(cuda_lib.launch_counts()), nonzero(cuda_lib.device_launch_counts())
    require(one == solve_launches(pl), f"phase 6 one plan({n}) solve launched {one}")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    out = {}
    ms = wall_ms(torch, lambda: out.setdefault("X", solve_many(S, cfg, op="inverse_pth_root", p=p, eps=eps)))
    peak = torch.cuda.max_memory_allocated()
    got, got_dev = nonzero(cuda_lib.launch_counts()), nonzero(cuda_lib.device_launch_counts())
    print(f"phase 6 Shampoo launches: one plan({n}) solve {one} (CUDA {one_dev}); the bucket {got} "
          f"(CUDA {got_dev})")
    require(got == {op: B * c for op, c in one.items()}, f"phase 6 bucket launches {got} != {B} x {one}")
    require(got_dev == {op: B * c for op, c in one_dev.items()}, f"phase 6 bucket CUDA launches {got_dev}")
    X = out["X"]
    w, V = torch.linalg.eigh(S.double())
    ridge = eps * w.amax(-1).clamp(min=1e-30)
    X_ref = (V * (w.clamp(min=0) + ridge[:, None]).pow(-1.0 / p)[:, None, :]) @ V.mT
    err = float(((X.double() - X_ref).abs().amax((-2, -1)) / X_ref.abs().amax((-2, -1))).max())
    del w, V, X_ref
    require(err < TOL_ROOT and bool(torch.isfinite(X).all()) and tuple(X.shape) == (B, n, n),
            f"phase 6 Shampoo inverse roots: rel err {err}")

    def library():
        wl, Vl = torch.linalg.eigh(S)
        r = eps * wl.amax(-1).clamp(min=1e-30)
        return (Vl * (wl.clamp(min=0) + r[:, None]).pow(-1.0 / p)[:, None, :]) @ Vl.mT

    lib_ms = wall_ms(torch, library)  # cuSOLVER is warm from phase 3
    print(f"phase 6 Shampoo refresh B={B} n={n} p={p}: solve_many {ms:.1f} ms ({ms / B:.4f} ms a block), "
          f"rel err vs float64 eigh {err:.3e} (tol {TOL_ROOT:.0e}); batched torch.linalg.eigh + root "
          f"{lib_ms:.1f} ms; peak memory {peak / 2**20:.0f} MiB")

    # The same bucket as an eigh run, stage by stage (each closed by a
    # synchronize), beside the device time of its kernels.
    stages, last = {}, [0.0]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = stages.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    base = batch_plan(n, B, torch.float32, cfg).base
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    wb, Vb = _execute_bucket(S, base, True, on_stage=mark)
    print("phase 6 Shampoo eigh bucket stages ms: " + ", ".join(f"{k}={v:.1f}" for k, v in stages.items())
          + f"; total {sum(stages.values()):.1f}")
    A0 = 0.5 * (S[0] + S[0].T)
    entries = build_stage_schedule(n, pl.b, pl.nb).entries
    a_ms = cuda_ms(torch, lambda M: [fused_panel_update_cuda(M[e.ci:, e.ci:], pl.b, e.w) for e in entries],
                   20, lambda: (A0.clone(),))
    band = band_reduce(A0, pl.b, pl.nb)
    b_ms = cuda_ms(torch, lambda: bulge_wavefront_cuda(band, pl.b, return_log=True), 20)
    vs, taus = sweep_major_log(bulge_wavefront_cuda(band, pl.b, return_log=True)[1])
    Xv = torch.randn((n, n), generator=gen, device="cuda")
    c_ms = cuda_ms(torch, lambda: backtransform_wy_cuda(Xv, vs, taus, b=pl.b), 20)
    print(f"phase 6 Shampoo kernels' device time a matrix (CUDA events): A {a_ms:.4f} ms ({len(entries)} calls), "
          f"B {b_ms:.4f} ms, C {c_ms:.4f} ms; x {B}: A {a_ms * B:.1f} ms (stage band_reduce "
          f"{stages['band_reduce']:.1f}), B {b_ms * B:.1f} ms (stage chase {stages['chase']:.1f}), C "
          f"{c_ms * B:.1f} ms (stage q2 {stages['q2']:.1f})")
    # Kernel A sums its reductions in a fixed order, so two calls on one
    # input, and two solves of one matrix, give the same bits.
    runs = [fused_panel_update_cuda(A0.clone(), pl.b, entries[0].w)[0] for _ in range(2)]
    a_same = torch.equal(runs[0], runs[1])
    a_diff = float((runs[0] - runs[1]).abs().max())

    def vec_err(V, Vi):
        sign = torch.sign((V * Vi).sum(0))
        return (V * sign[None, :] - Vi).abs().amax(0)

    ew = ev = ev_self = ev_self_w = 0.0
    for i in range(8):
        wi, Vi = pl(S[i])
        wi2, Vi2 = pl(S[i])  # the same solve again
        scale = float(wi.abs().max())
        ew = max(ew, float((wi - wb[i]).abs().max()) / scale)
        ev_self_w = max(ev_self_w, float((wi - wi2).abs().max()) / scale)
        ev = max(ev, float(vec_err(Vb[i], Vi).max()))
        ev_self = max(ev_self, float(vec_err(Vi2, Vi).max()))
    print(f"phase 6 kernel A bitwise equal over two calls on one input: {a_same} (max diff {a_diff:.3e}); "
          f"plan({n}) against itself, first 8: eigenvalues {ev_self_w:.3e} of max|w|, eigenvectors "
          f"{ev_self:.3e}")
    require(a_same and ev_self_w == 0.0 and ev_self == 0.0, "phase 6 kernel A / plan bitwise repeatable")
    print(f"phase 6 Shampoo bucket vs plan({n}) one by one, first 8: eigenvalues {ew:.3e} of max|w| "
          f"(tol {TOL_LOOP_W:.0e}), sign-aligned eigenvectors {ev:.3e} (tol {TOL_LOOP_V:.0e})")
    require(ew < TOL_LOOP_W and ev < TOL_LOOP_V, "phase 6 bucket vs plan loop")
    return got, got_dev, dict(ms=ms, library_ms=lib_ms, blocks=B, peak_mib=peak / 2**20)


def phase_buckets(torch, gen):
    """Phase 6b-c: heterogeneous and padded buckets, and a medium bucket."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, PadPolicy, plan, solve_many

    leaves = []
    for count, n in HETERO:
        X = torch.randn((count, n, n), generator=gen, device="cuda")
        leaves.append(X + X.mT)
    odd = HETERO[-1][1]
    require(plan(odd, torch.float32, EvdConfig()).method == "direct", f"n = {odd} routes to the direct method")
    for label, pad in (("exact buckets", PadPolicy()),
                       (f"padded to {PAD_BUCKET}, batch_multiple 8", PadPolicy(bucket_sizes=(PAD_BUCKET,), batch_multiple=8))):
        per_bucket, want = {}, {}
        for count, n in HETERO:
            per_bucket[pad.bucket_for(n)] = per_bucket.get(pad.bucket_for(n), 0) + count
        for N, count in per_bucket.items():
            pl = plan(N, torch.float32, EvdConfig())
            if pl.method == "two_stage":  # with the identity matrices that pad the batch
                for op, c in solve_launches(pl).items():
                    want[op] = want.get(op, 0) + -(-count // pad.batch_multiple) * pad.batch_multiple * c
        cuda_lib.reset_launch_counts()
        out = {}
        ms = wall_ms(torch, lambda: out.setdefault("r", solve_many(leaves, EvdConfig(), pad=pad)))
        got = nonzero(cuda_lib.launch_counts())
        print(f"phase 6 heterogeneous {[tuple(x.shape) for x in leaves]}, {label}: solve_many {ms:.1f} ms; "
              f"launches {got}")
        require(got == want, f"phase 6 {label}: launches {got}, expected {want}")
        for A, (w, V) in zip(leaves, out["r"]):
            check_bucket(torch, f"phase 6 {label} n={A.shape[-1]}", A, w, V)

    n, B = N_MEDIUM, B_MEDIUM
    X = torch.randn((B, n, n), generator=gen, device="cuda")
    A = X + X.mT
    del X
    pl = plan(n, torch.float32, EvdConfig())
    cuda_lib.reset_launch_counts()
    out = {}
    ms = wall_ms(torch, lambda: out.setdefault("r", solve_many(A, EvdConfig())))
    got = nonzero(cuda_lib.launch_counts())
    want = {op: B * c for op, c in solve_launches(pl).items()}
    require(got == want, f"phase 6 medium bucket launches {got}, expected {want}")
    check_bucket(torch, f"phase 6 medium bucket ({B}, {n}, {n})", A, *out["r"])
    torch.linalg.eigh(A)
    eigh_ms = wall_ms(torch, lambda: torch.linalg.eigh(A))
    print(f"phase 6 medium bucket ({B}, {n}, {n}) {pl.describe()}: solve_many {ms:.1f} ms, launches {got}; "
          f"batched torch.linalg.eigh {eigh_ms:.1f} ms")


def phase_methods(torch, gen):
    """Phase 7: the direct and Jacobi methods, the oracle generation and the
    core wrappers, on the card (plain torch, no kernel but A in the oracle
    generation's band reduction)."""
    from repro_torch import core
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan

    def sym(n):
        X = torch.randn((n, n), generator=gen, device="cuda")
        return X + X.T

    def run(label, A, fn):
        cuda_lib.reset_launch_counts()
        out = {}
        ms = wall_ms(torch, lambda: out.setdefault("r", fn(A)))
        launches = nonzero(cuda_lib.launch_counts())
        check_evd(torch, f"phase 7 {label}", A, *out["r"])
        torch.linalg.eigh(A)
        eigh_ms = wall_ms(torch, lambda: torch.linalg.eigh(A))
        print(f"phase 7 {label} n={A.shape[0]}: {ms:.1f} ms, torch.linalg.eigh {eigh_ms:.1f} ms; "
              f"kernel launches {launches}")
        return launches

    pl = plan(N_DIRECT, torch.float32, EvdConfig())
    print(f"phase 7 {pl.describe()}")
    require(pl.method == "direct", f"plan({N_DIRECT}) runs {pl.method}, expected direct")
    require(not run(f"plan({N_DIRECT}), method=direct", sym(N_DIRECT), pl), "the direct method launched a kernel")
    pj = plan(N_JACOBI, torch.float32, EvdConfig(method="jacobi"))
    require(not run("method=jacobi", sym(N_JACOBI), pj), "the Jacobi method launched a kernel")
    ps = plan(N_SEQUENTIAL, torch.float32, EvdConfig(chase="sequential", backtransform="scan"))
    print(f"phase 7 {ps.describe()}")
    got = run("chase=sequential, backtransform=scan", sym(N_SEQUENTIAL), ps)
    require(got == {"fused_panel_update": solve_launches(ps)["fused_panel_update"]},
            f"phase 7 oracle generation launches {got}: kernel A only")

    n = N_SEQUENTIAL
    A = sym(n)
    run("core.eigh", A, core.eigh)
    w_ref = torch.linalg.eigvalsh(A.double())
    e = max_eig_err(core.eigvalsh(A), w_ref)
    X = torch.randn((4, n, n), generator=gen, device="cuda")
    As = X + X.mT
    w, V = core.eigh_batched(As)
    check_bucket(torch, "phase 7 core.eigh_batched", As, w, V)
    e_b = float(((core.eigvalsh_batched(As).double() - torch.linalg.eigvalsh(As.double())).abs().amax(-1)
                 / w.double().abs().amax(-1)).max())
    G = torch.randn((n, 2 * n), generator=gen, device="cuda") / (2 * n) ** 0.5
    S = G @ G.T + 0.1 * torch.eye(n, device="cuda")
    Xr = core.inverse_pth_root(S, 4)
    ws, Vs = torch.linalg.eigh(S.double())
    X_ref = (Vs * (ws + 1e-6 * float(ws.max())).pow(-0.25)[None, :]) @ Vs.T
    e_r = rel_err(Xr, X_ref)
    print(f"phase 7 core.eigvalsh {e:.3e}, core.eigvalsh_batched {e_b:.3e} (tol {TOL_EIG:.0e}); "
          f"core.inverse_pth_root rel err vs float64 {e_r:.3e} (tol {TOL_ROOT:.0e})")
    require(e < TOL_EIG and e_b < TOL_EIG and e_r < TOL_ROOT, "phase 7 core wrappers")


def root_errors(torch, stats, pre, idx, eps):
    """Per block of ``idx``: ``pre`` against the float64 formula V (w + eps
    max|w|)^-1/4 V^T of ``stats``, relative to the block's largest entry;
    the blocks' condition numbers under that ridge; and the same error of
    float32 ``torch.linalg.eigh`` (cuSOLVER) on the blocks."""
    S = stats[idx]
    w, V = torch.linalg.eigh(S.double())
    ridge = eps * w.amax(-1, keepdim=True).clamp(min=1e-30)
    X = (V * (w.clamp(min=0) + ridge).pow(-0.25)[:, None, :]) @ V.mT
    scale = X.abs().amax((-2, -1))
    err = (pre[idx].double() - X).abs().amax((-2, -1)) / scale
    cond = w.amax(-1) / torch.maximum(w.amin(-1), ridge[:, 0])
    w32, V32 = torch.linalg.eigh(0.5 * (S + S.mT))
    r32 = eps * w32.amax(-1, keepdim=True).clamp(min=1e-30)
    X32 = (V32 * (w32.clamp(min=0) + r32).pow(-0.25)[:, None, :]) @ V32.mT
    lib_err = (X32.double() - X).abs().amax((-2, -1)) / scale
    return err, cond, lib_err


@contextlib.contextmanager
def _stage_timer(torch, stages: dict):
    """Time the refresh's stages: every ``solve_many`` bucket's executor
    stages (each closed by a synchronize) and the Rayleigh-Ritz root, summed
    into ``stages`` (ms) while the context is open."""
    from repro_torch.solver import batch as solver_batch

    last = [0.0]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = stages.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    orig, orig_root = solver_batch._execute_bucket, solver_batch._roots_from_window

    def timed(A, base, eigenvectors, on_stage=None):
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        return orig(A, base, eigenvectors, on_stage=mark)

    def timed_root(*args):
        X = orig_root(*args)
        mark("ritz_root")
        return X

    solver_batch._execute_bucket, solver_batch._roots_from_window = timed, timed_root
    try:
        yield
    finally:
        solver_batch._execute_bucket, solver_batch._roots_from_window = orig, orig_root


def _train_run(torch, cfg, opt, params, batch_fn, steps: int, label: str):
    """``steps`` steps of ``make_train_step(cfg, opt)`` through TrainLoop from
    ``params``, the launch counters reset just before.  Returns the loop,
    the final weights, the losses, the first step's outputs, the starting
    optimizer state and the peak memory."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

    first = {}
    train_step = make_train_step(cfg, opt)

    def step_fn(p, s, batch, step):
        out = train_step(p, s, batch, step)
        first.setdefault("out", out)
        return out

    state = opt.init(params)
    loop = TrainLoop(step_fn, batch_fn, TrainLoopConfig(total_steps=steps, log_every=1),
                     log_fn=lambda m: print(f"{label} {m}"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    final, _, hist = loop.run(params, state)
    torch.cuda.synchronize()
    return loop, final, hist, first["out"], state, torch.cuda.max_memory_allocated()


def shampoo_training(torch, phase: str, cfg, batch: int, seq: int, steps: int, repeat: bool,
                     precond_mesh=None):
    """Shampoo training of ``cfg`` on the card through the port's entry
    points (random weights from the seed, ``shampoo(warmup_cosine(3e-4,
    ...), ShampooOptions(precond_mesh=precond_mesh))``, ``make_train_step``,
    ``TrainLoop``, ``synthetic_batch``), with phase 8's gates: finite
    losses, every weight moved, kernels A, B and C launched exactly 2 x
    blocks x one ``plan(128)`` solve's (with ``precond_mesh``, 2 x this
    rank's share, ceil(blocks / ranks)), the step-1 roots on
    ``ROOT_BLOCKS`` seeded blocks within ``TOL_ROOT`` of the float64
    formula (beside float32 ``torch.linalg.eigh``'s error), and with
    ``repeat`` step 1 run again from the same state and bit for bit the
    first run's.  The refresh's stages are timed in the repeat, or else in
    the run itself.  Returns (launches, CUDA launches, record, (params,
    batch_fn, sched, opts, step-1 outputs: params, state, metrics))."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import model_meta, model_params, param_count, pattern_unit
    from repro_torch.optim import ShampooOptions, shampoo, warmup_cosine
    from repro_torch.optim.shampoo import leaf_plans
    from repro_torch.solver import plan
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves

    opts = ShampooOptions(precond_mesh=precond_mesh)
    params = model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    _, NB = leaf_plans(params, opts)
    share = NB if precond_mesh is None else -(-NB // precond_ranks(precond_mesh))
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED)
    batch_fn = lambda s: synthetic_batch(dc, s, device="cuda")  # noqa: E731
    sched = warmup_cosine(3e-4, warmup=max(steps // 20, 1), total=steps)
    pl = plan(N_BLOCK, torch.float32, opts.evd)
    one = solve_launches(pl)
    pat, n_units, rem = pattern_unit(cfg)
    print(f"{phase} {cfg.name} cut to {cfg.n_layers} layers ({n_units} x {pat} + {rem}): d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype} activations, {cfg.param_dtype} weights, remat={cfg.remat}; "
          f"{param_count(model_meta(cfg)) / 1e9:.3f} B params; batch {batch} x seq {seq}, {steps} steps; Shampoo "
          f"block {opts.block_size}, interval {opts.update_interval}: {NB} blocks a side, each {pl.describe()}")

    opt = shampoo(sched, opts)
    stages = {}
    with contextlib.nullcontext() if repeat else _stage_timer(torch, stages):
        loop, final, hist, first, state0, peak = _train_run(torch, cfg, opt, params, batch_fn, steps,
                                                            f"{phase} {cfg.name} shampoo")
    got = nonzero(cuda_lib.launch_counts())
    got_dev = nonzero(cuda_lib.device_launch_counts())
    cuda_lib.reset_launch_counts()
    pl(torch.eye(N_BLOCK, device="cuda"))
    one_dev = nonzero(cuda_lib.device_launch_counts())
    times = loop.step_times
    steady_ms = sum(times[1:]) / len(times[1:]) * 1e3
    print(f"{phase} {cfg.name} shampoo losses {hist}; step times s {[round(t, 3) for t in times]}: step 1 "
          f"(refresh{'' if repeat else ', its stages timed'}) {times[0]:.2f} s, steady {steady_ms:.1f} ms a step; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"{phase} {cfg.name} launches over the {steps} steps: {got} (CUDA {got_dev}); one plan({N_BLOCK}) "
          f"solve {one} (CUDA {one_dev}), x 2 sides x {share} blocks" + (f" (this rank's of {NB})" if share != NB else ""))
    require(got == {op: 2 * share * c for op, c in one.items()}, f"{phase} {cfg.name} launches {got}")
    require(got_dev == {op: 2 * share * c for op, c in one_dev.items()}, f"{phase} {cfg.name} CUDA launches {got_dev}")
    require(len(hist) == steps and all(math.isfinite(h) for h in hist), f"{phase} {cfg.name} losses {hist}")
    moved = [bool((a != b).any()) for a, b in zip(leaves(final), leaves(params))]
    require(all(moved), f"{phase} {cfg.name} weights moved: {moved}")
    del final

    # The first step's preconditioners against float64, on seeded blocks.
    _, s1, _ = first
    idx = torch.randperm(NB, generator=torch.Generator().manual_seed(SEED))[:ROOT_BLOCKS].cuda()
    worst = {}
    for side in ("l", "r"):
        err, cond, lib_err = root_errors(torch, getattr(s1, "stats_" + side), getattr(s1, "pre_" + side), idx,
                                         opts.eps)
        worst[side] = float(err.max())
        print(f"{phase} {cfg.name} pre_{side} on {ROOT_BLOCKS} seeded blocks vs float64: max rel err "
              f"{float(err.max()):.3e} (median {float(err.median()):.3e}; {int((err >= TOL_ROOT).sum())} blocks at "
              f"or above {TOL_ROOT:.0e}); block cond median {float(cond.median()):.3e}, max "
              f"{float(cond.max()):.3e}; float32 torch.linalg.eigh on the same blocks: max {float(lib_err.max()):.3e}")
        require(bool((err < TOL_ROOT).all()) and bool(torch.isfinite(getattr(s1, "pre_" + side)).all()),
                f"{phase} {cfg.name} pre_{side} vs float64")

    same, repeat_s = None, None
    if repeat:
        # Step 1 again from the same state, with the refresh's stages timed:
        # bit for bit the first run's.
        with _stage_timer(torch, stages):
            t0 = time.perf_counter()
            again = make_train_step(cfg, opt)(params, state0, batch_fn(0), 0)
            torch.cuda.synchronize()
            repeat_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(leaves(again), leaves(first)))
        del again
        print(f"{phase} {cfg.name} step 1 repeated from the same state: {repeat_s:.2f} s, bitwise identical: {same}")
        require(same, f"{phase} {cfg.name} step 1 is not bitwise repeatable")
    refresh_s = sum(stages.values()) / 1e3
    print(f"{phase} {cfg.name} the refresh's stages (2 solve_many buckets of {share}, each stage closed by a "
          f"synchronize) ms: " + ", ".join(f"{k}={v:.1f}" for k, v in stages.items())
          + f"; {refresh_s:.2f} s in all, {refresh_s * 1e3 / (2 * share):.3f} ms a block")
    record = dict(
        layers=cfg.n_layers, batch=batch, seq=seq, blocks_a_side=NB, step1_s=times[0], steady_ms=steady_ms,
        blocks_this_rank=share, refresh_s=refresh_s, refresh_ms_per_block=refresh_s * 1e3 / (2 * share),
        stages_ms=stages,
        peak_gib=peak / 2**30, root_err=worst, losses=hist, step1_bitwise=same, launches=got)
    return got, got_dev, record, (params, batch_fn, sched, opts, first)


def phase_training(torch, gen):
    """Phase 8: Shampoo training of llama3.2-3b on the card (full width,
    1 layer), through the port's entry points."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=TRAIN_LAYERS)
    got, got_dev, record, (params, batch_fn, sched, opts, (_, s1, _)) = shampoo_training(
        torch, "phase 8", cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, repeat=True)
    NB, refresh_s = record["blocks_a_side"], record["refresh_s"]

    # The same steps with AdamW.
    loop_a, _, hist_a, _, _, peak_a = _train_run(torch, cfg, adamw(sched), params, batch_fn, TRAIN_STEPS,
                                                 "phase 8 adamw")
    ta = loop_a.step_times
    require(all(math.isfinite(h) for h in hist_a) and not nonzero(cuda_lib.launch_counts()),
            f"phase 8 adamw losses {hist_a}")
    print(f"phase 8 adamw losses {hist_a}; step times s {[round(t, 3) for t in ta]}: steady "
          f"{sum(ta[1:]) / len(ta[1:]) * 1e3:.1f} ms a step; peak memory {peak_a / 2**30:.2f} GiB")

    # The yardstick: the first YARDSTICK_BLOCKS of one side's step-1
    # statistics through batched float32 torch.linalg.eigh (cuSOLVER) and
    # the root formula, a rate a block (a part keeps the script in its
    # time: both sides took 24.4 s).
    nb_lib = min(YARDSTICK_BLOCKS, NB)

    def library():
        w, V = torch.linalg.eigh(s1.stats_l[:nb_lib])
        r = opts.eps * w.amax(-1).clamp(min=1e-30)
        (V * (w.clamp(min=0) + r[:, None]).pow(-0.25)[:, None, :]) @ V.mT

    lib_s = wall_ms(torch, library) / 1e3
    print(f"phase 8 {nb_lib} of one side's {NB} step-1 statistics through batched torch.linalg.eigh + root: "
          f"{lib_s:.2f} s, {lib_s / nb_lib * 1e3:.3f} ms a block, against the refresh's {refresh_s:.2f} s for both "
          f"sides, {refresh_s / (2 * NB) * 1e3:.3f} ms a block")

    record.update(library_s=lib_s, library_blocks=nb_lib, adamw_steady_ms=sum(ta[1:]) / len(ta[1:]) * 1e3)
    return got, got_dev, record


def background_jobs(out_dir: str):
    """The jobs of :class:`Background`: ``(key, phase, argv of python -m,
    check of the stdout lines or None)``.  The launchers' CLIs of phases
    8-10 on the card, then the production dry-runs of phases 13 (b) and
    14 (c) (fake CUDA tensors, records written under ``out_dir``)."""
    def dry(arch, shape, multi_pod, *opt):
        return ["repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                *(["--multi-pod"] if multi_pod else []), *opt, "--out", out_dir]

    jobs = [
        ("train_llama", "phase 8", ["repro_torch.launch.train", "--arch", "llama3.2-3b", "--smoke", "--steps", "2",
                                    "--optimizer", "shampoo"], lambda lines: "on NVIDIA" in lines[-1]),
        ("serve_mixtral", "phase 9", ["repro_torch.launch.serve", "--arch", "mixtral-8x7b", "--smoke"],
         lambda lines: len(lines) >= 3 and lines[-3].startswith("[serve] mixtral-8x7b")),
        ("serve_mamba2", "phase 10", ["repro_torch.launch.serve", "--arch", "mamba2-370m", "--smoke"],
         lambda lines: len(lines) >= 3 and lines[-3].startswith("[serve] mamba2-370m")),
        ("train_recurrentgemma", "phase 10", ["repro_torch.launch.train", "--arch", "recurrentgemma-2b", "--smoke",
                                              "--steps", "2", "--optimizer", "shampoo"],
         lambda lines: "recurrentgemma-2b on NVIDIA" in lines[-1]),
    ]
    jobs += [(("dry", *cell, ""), "phase 13 (b)", dry(*cell), None) for cell in DRY_CELLS]
    jobs.append((("dry", *SHAMPOO_FULL, "_shampoo_sharded"), "phase 14 (c)",
                 dry(*SHAMPOO_FULL, "--optimizer", "shampoo", "--shampoo-sharded"), None))
    return jobs


class Background:
    """``python -m <argv>`` of each job (:func:`background_jobs`) from the
    checkout's ``src``, one after another in a thread of this process, each
    in a process of its own, while the main thread waits on phase 12's
    ranks.  None is timed against anything; their lines print when phase 12
    is done.  A job still running when this process exits is killed."""

    def __init__(self, jobs):
        self.jobs = {key: (phase, argv, ok) for key, phase, argv, ok in jobs}
        self.results = {}
        self.proc = None
        atexit.register(self.stop)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        import os

        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        for key, (_, argv, _) in self.jobs.items():
            t0 = time.perf_counter()
            self.proc = subprocess.Popen([sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True, env=env)
            try:
                out, err = self.proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, err = self.proc.communicate()
                err = "timed out after 600 s\n" + err
            self.results[key] = (self.proc.returncode, out.strip().splitlines(), err, time.perf_counter() - t0)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def check(self, key) -> float:
        """Once every job is done: the job ``key``'s line, exit 0 (and its
        check) required; its wall time in s."""
        self.thread.join()
        phase, argv, ok = self.jobs[key]
        rc, lines, err, job_s = self.results[key]
        print(f"{phase} `python -m {' '.join(argv)}`: exit {rc} in {job_s:.1f} s (beside phase 12's ranks): "
              + (" | ".join(lines[-3:]) or err[-400:]))
        require(rc == 0 and len(lines) > 0 and (ok is None or ok(lines)), f"{phase} python -m {' '.join(argv)}")
        return job_s

    def record(self, key, out_dir: str):
        """The dry-run record the job ``key`` (``("dry", arch, shape,
        multi_pod, the file name's optimizer suffix)``) wrote under
        ``out_dir``, its line printed (:meth:`check`)."""
        self.check(key)
        _, arch, shape, multi_pod, opt = key
        with open(Path(out_dir) / f"{arch}_{shape}_{'2pod' if multi_pod else '1pod'}{opt}.json") as f:
            return json.load(f)


def _window(cfg):
    """The attention layers' window: recurrentgemma's local one, the
    sliding one, or None."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.sliding_window


def _chunk(S: int) -> int:
    """The flash chunk length for a forward over S tokens: the configs'
    1024, or the largest divisor of S below it (the forward needs one)."""
    n = -(-S // 1024)
    while S % n:
        n += 1
    return S // n


@contextlib.contextmanager
def _moe_routing(torch, record=None, replay=None, n_layers=1, flips=None):
    """Record the MoE routing of a decode run (one ``_router`` call per layer
    and step, in order), or replay a recorded one into another decode run
    or into forwards (one call per layer, the first S positions), with the
    weights renormalized from the replaying run's own probabilities.  With
    replay, ``flips[0]`` counts the (token, layer) pairs whose own top-k
    set differed.  Rounding flips near-tied choices, and a flip moves the
    logits by O(1) through the layers above it (granite-moe: 0.6 of
    max|logits| at 32 layers from a 1-ulp change of the embedding), so the
    float32 and bf16 comparisons of a MoE arch replay the float32 decode's
    choices."""
    from repro_torch.models import moe

    orig, calls = moe._router, itertools.count()

    def router(p, cfg, x):
        w, idx, aux = orig(p, cfg, x)
        i = next(calls)
        if record is not None:
            record.append(idx)
            return w, idx, aux
        S = x.shape[1]
        pinned = replay[i] if S == 1 else torch.cat(replay[i % n_layers :: n_layers], dim=1)[:, :S]
        flips[0] += int((pinned.sort(-1).values != idx.sort(-1).values).any(-1).sum())
        probs = torch.softmax(x.to(torch.float32) @ p["router"].to(x.dtype).to(torch.float32), dim=-1)
        w = probs.gather(-1, pinned)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), pinned, aux

    moe._router = router
    try:
        yield
    finally:
        moe._router = orig


def _decode_logits(torch, params, cfg, fed, greedy_from: int):
    """``decode_step`` over the tokens ``fed`` (B, T), one position a step:
    positions below ``greedy_from`` as given, each later one the argmax of
    the step before (written into ``fed``).  Returns the logits (B, T, V)."""
    from repro_torch.models import cache_init, decode_step

    B, T = fed.shape
    cache = cache_init(cfg, B, T)
    out = torch.empty((B, T, cfg.vocab), dtype=torch.float32, device="cuda")
    for t in range(T):
        logits, cache = decode_step(params, cfg, cache, tokens=fed[:, t : t + 1])
        out[:, t] = logits[:, 0]
        if greedy_from <= t + 1 < T:
            fed[:, t + 1] = logits[:, 0].argmax(-1)
    require(int(cache["pos"]) == T, f"decode ran {int(cache['pos'])} of {T} positions")
    return out


def _greedy_check(torch, ref, picked, tol: float):
    """Tokens ``picked`` (B, n) against the logits ``ref`` (B, n, V): each the
    argmax, or within ``tol`` of the row's max (a tie at this tolerance).
    Returns (all within tol, how many are the exact argmax, how many)."""
    got = ref.gather(-1, picked[..., None].long())[..., 0]
    within = bool((ref.amax(-1) - got <= tol).all())
    return within, int((ref.argmax(-1) == picked).sum()), picked.numel()


def _graph_ms(torch, step) -> float:
    """The device time of one ``step()``: the step captured once in a CUDA
    graph, its replays timed by ``cuda_ms`` (one launch each, so no host
    work between the kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return cuda_ms(torch, graph.replay, 10)


def phase_serving(torch, gen):
    """Phase 9: the serve path on the card, through the port's entry points."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import cache_init, forward, model_meta, model_params, param_count, pattern_unit
    from repro_torch.train import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    replace = dataclasses.replace
    cells = {}
    cuda_lib.reset_launch_counts()
    for arch, layers, B, P, G, gate_layers in SERVE_CELLS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = replace(cfg, n_layers=layers)
        T = P + G
        params = model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), model_axis=1,
                              device="cuda")
        prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda", dtype=torch.int32)
        serve = make_serve_step(cfg)
        win = _window(cfg)
        W = min(win, T) if win else T
        n_params = param_count(model_meta(cfg))
        pat, n_units, rem = pattern_unit(cfg)
        print(f"phase 9 {cfg.name}: {cfg.n_layers} layers ({n_units} x {pat} + {rem}), d_model {cfg.d_model}, "
              f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, experts {cfg.n_experts} "
              f"top-{cfg.top_k} ({cfg.moe_impl}), vocab {cfg.vocab}, window {win}"
              + (f", SSD state {cfg.ssm_state} x {cfg.ssm_nheads} heads of {cfg.ssm_headdim}, chunk "
                 f"{cfg.ssm_chunk}" if cfg.family == "ssm" else "")
              + f"; {n_params / 1e9:.3f} B params, {cfg.dtype} activations, {cfg.param_dtype} weights; batch {B}, "
              f"prompt {P}, gen {G}" + (f", attention cache {W} slots a layer" if "attn" in pat + rem else ""))

        # The serve loop as the launcher runs it, timed after one step on a
        # throwaway cache (the first step's cuBLAS and allocator set-up).
        with torch.inference_mode():
            serve(params, cache_init(cfg, B, 1), prompts[:, :1])
        cache = cache_init(cfg, B, T)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Pt = min(P, SERVE_SHORT_PROMPT)
        with torch.inference_mode():
            t0 = time.perf_counter()
            for t in range(Pt):
                nxt, cache = serve(params, cache, prompts[:, t : t + 1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok = nxt[:, None]
            for _ in range(G):
                nxt, cache = serve(params, cache, tok)
                tok = nxt[:, None]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            # A step's device time, at the last position of the prompt.
            cache["pos"].fill_(P - 1)
            dev_ms = _graph_ms(torch, lambda: serve(params, cache, prompts[:, P - 1 :]))
            # The full-sequence prefill (the forward over the prompt).
            prefill = make_prefill(replace(cfg, attn_chunk=_chunk(P), attn_kv_chunk=_chunk(P)))
            prefill(params, {"tokens": prompts})
            fwd_ms = wall_ms(torch, lambda: prefill(params, {"tokens": prompts}))
        del cache
        prefill_ms, decode_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / G
        print(f"phase 9 {cfg.name} serve loop: prefill by {Pt} decode steps"
              + (f" (the first of {P})" if Pt < P else "") + f" {prefill_ms:.1f} ms "
              f"({prefill_ms / Pt:.2f} ms a step), decode {decode_ms:.2f} ms/token/batch; a step's device time "
              f"{dev_ms:.2f} ms (as one CUDA graph; device idle {1 - dev_ms / decode_ms:.1%} of an eager decode "
              f"step); make_prefill (forward over the prompt) {fwd_ms:.1f} ms; peak memory {peak / 2**30:.2f} GiB")

        # The gates: a float32 copy on the same weights against forward,
        # MoE archs replaying the float32 decode's routing.
        if gate_layers is not None:  # the first units, and the remainder layers where the cut keeps them
            full_rem = rem
            cfg = replace(cfg, n_layers=gate_layers)
            _, n_cut, cut_rem = pattern_unit(cfg)
            require(cut_rem in ((), full_rem), f"phase 9 {arch}: a gate cut to {gate_layers} layers")
            params = dict(params, units=tree_map(lambda t: t[:n_cut], params["units"]),
                          rem=params["rem"] if cut_rem else {})
        cfg32 = replace(cfg, dtype="float32")
        ref_cfg = replace(cfg32, moe_impl="dense", attn_chunk=_chunk(T), attn_kv_chunk=_chunk(T))
        routing, flips, flips16 = [], [0], [0]
        moe = cfg.n_experts > 0
        with torch.inference_mode():
            fed = torch.zeros((B, T), dtype=torch.int32, device="cuda")
            fed[:, :P] = prompts
            with _moe_routing(torch, record=routing) if moe else contextlib.nullcontext():
                lg32 = _decode_logits(torch, params, cfg32, fed, P)
            with _moe_routing(torch, replay=routing, n_layers=cfg.n_layers, flips=flips) if moe \
                    else contextlib.nullcontext():
                ref, _ = forward(params, ref_cfg, tokens=fed)
            with _moe_routing(torch, replay=routing, n_layers=cfg.n_layers, flips=[0]) if moe \
                    else contextlib.nullcontext():
                first = make_prefill(replace(cfg32, moe_impl="dense", attn_chunk=_chunk(P),
                                             attn_kv_chunk=_chunk(P)))(params, {"tokens": prompts})
                ulp = torch.randint(0, 2, params["embed"].shape, generator=gen, device="cuda") * 2.0 - 1
                bumped = dict(params, embed=params["embed"] * (1 + ulp * 2.0 ** -23))
                del ulp
                moved, _ = forward(bumped, ref_cfg, tokens=fed)
                del bumped
            # Per position, the largest logit difference over the batch row
            # and the vocabulary, relative to the largest logit.
            scale = float(ref.abs().max())
            err_pos = (lg32 - ref).abs().amax(-1) / scale
            sens_pos = (moved - ref).abs().amax(-1) / scale
            del moved
            tol = max(TOL_SERVE, SENS_FACTOR * float(sens_pos.max()))
            spans = {"every position": slice(0, T)}
            if win and T > win:
                spans[f"positions {win}.. (ring wrapped)"] = slice(win, T)
            gates = {name: (float(err_pos[:, sl].max()), float(err_pos[:, sl].median()),
                            max(TOL_SERVE / 10, SENS_FACTOR * float(sens_pos[:, sl].median())))
                     for name, sl in spans.items()}
            greedy_ok, exact, n_greedy = _greedy_check(torch, ref[:, P - 1 : T - 1], fed[:, P:], tol * scale)
            prefill_ok, _, _ = _greedy_check(torch, ref[:, P - 1 : P], first[:, None], tol * scale)
            bf16_layers = BF16_GATE_LAYERS.get(arch, cfg.n_layers)
            T16 = min(T, SERVE_SHORT_PROMPT + G)  # the bf16 gate's positions (the first ones)
            fed16 = fed[:, :T16].clone()
            if bf16_layers < cfg.n_layers:  # the bf16 gate on the first layers only
                cut = replace(cfg, n_layers=bf16_layers)
                cut_params = dict(params, units=tree_map(lambda t: t[:bf16_layers], params["units"]))
                lg32 = _decode_logits(torch, cut_params, replace(cut, dtype="float32"), fed16, T16)
                lg16 = _decode_logits(torch, cut_params, cut, fed16, T16)
                scale16 = float(lg32.abs().max())
            else:
                lg32 = lg32[:, :T16]
                with _moe_routing(torch, replay=routing, n_layers=cfg.n_layers, flips=flips16) if moe \
                        else contextlib.nullcontext():
                    lg16 = _decode_logits(torch, params, cfg, fed16, T16)
                scale16 = scale
            finite = bool(torch.isfinite(lg16).all())
            diff = (lg16 - lg32).abs()
            mean16, max16 = float(diff.mean()) / scale16, float(diff.max()) / scale16
            agree16 = float((lg16.argmax(-1) == lg32.argmax(-1)).float().mean())
        n_route = B * T * cfg.n_layers
        print(f"phase 9 {cfg.name} float32 decode vs forward ({cfg.n_layers} layers, "
              f"{'dense MoE on the decode routing, ' if moe else ''}{T} positions; max|logits| {scale:.4f}; the "
              f"forward moves {float(sens_pos.max()):.2e} at most, {float(sens_pos.median()):.2e} at the median "
              f"position, when its embedding moves 1 ulp): "
              + "; ".join(f"{name} max {mx:.3e} (tol {tol:.2e}), median {md:.3e} (tol {md_tol:.2e})"
                          for name, (mx, md, md_tol) in gates.items())
              + f"; greedy tokens the forward's argmax {exact}/{n_greedy} (all within tol: {greedy_ok}), "
              f"make_prefill's within tol: {prefill_ok}; bf16 decode vs float32"
              + (f" (first {bf16_layers} layers)" if bf16_layers < cfg.n_layers else "")
              + (f" (first {T16} positions)" if T16 < T else "") + f": mean {mean16:.3e} "
              f"(tol {TOL_SERVE_BF16:.0e}), max {max16:.3e} of max|logits|, finite {finite}, argmax agrees at "
              f"{agree16:.1%} of positions"
              + (f"; routing the forward would choose otherwise: {flips[0]} of {n_route} (token, layer) pairs, "
                 f"the bf16 decode {flips16[0]}" if moe else ""))
        for name, (mx, md, md_tol) in gates.items():
            require(mx < tol and md < md_tol, f"phase 9 {cfg.name} float32 decode vs forward, {name}: max "
                    f"{mx:.3e} (tol {tol:.2e}), median {md:.3e} (tol {md_tol:.2e})")
        require(greedy_ok and prefill_ok, f"phase 9 {cfg.name} greedy tokens vs the forward's argmax")
        require(finite and mean16 < TOL_SERVE_BF16, f"phase 9 {cfg.name} bf16 logits vs float32 {mean16:.3e}")
        cells[cfg.name] = dict(
            layers=layers or get_config(arch).n_layers, gate_layers=cfg.n_layers, batch=B, prompt=P, gen=G,
            timed_prompt=Pt,
            params_b=n_params / 1e9, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms, step_device_ms=dev_ms,
            forward_prefill_ms=fwd_ms, peak_gib=peak / 2**30, fp32_tol=tol,
            ulp_sensitivity=float(sens_pos.max()), fp32_gates={k: list(v) for k, v in gates.items()},
            greedy_exact=f"{exact}/{n_greedy}", bf16_layers=bf16_layers, bf16_positions=T16, bf16_mean_err=mean16,
            bf16_max_err=max16,
            routing_flips=flips[0] if moe else None)
        del params, prompts, lg32, ref, lg16, diff, fed, routing, err_pos, sens_pos
        gc.collect()
        torch.cuda.empty_cache()
    got = nonzero(cuda_lib.launch_counts())
    print(f"phase 9 kernel launches over the serve path: {got or 'none'}")
    require(not got, f"phase 9 launched {got}")
    return cells


def phase_families(torch, gen):
    """Phase 10: the Mamba2 and RG-LRU families' Shampoo training, the
    frontends' training on embeds and both launchers on the card, through
    the port's entry points."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import model_params
    from repro_torch.optim import adamw, warmup_cosine

    replace = dataclasses.replace
    gc.collect()
    torch.cuda.empty_cache()
    launches, device_launches, records = {}, {}, {}
    # (a) Shampoo training of the two recurrent families at full width.
    for arch, layers, batch, seq, steps, repeat in FAMILY_TRAIN_CELLS:
        cfg = replace(get_config(arch), n_layers=layers)
        got, got_dev, record, state = shampoo_training(torch, "phase 10", cfg, batch, seq, steps, repeat)
        for total, counts in ((launches, got), (device_launches, got_dev)):
            for op, n in counts.items():
                total[op] = total.get(op, 0) + n
        records[cfg.name] = record
        del record["launches"], state
        gc.collect()
        torch.cuda.empty_cache()

    # (c) The frontend archs on precomputed embeddings: AdamW steps through
    # make_train_step, frontend_proj must move.
    for arch, layers in FRONTEND_CELLS:
        cfg = replace(get_config(arch), n_layers=layers)
        params = model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED,
                        frontend_dim=cfg.frontend_dim)
        batch_fn = lambda s: synthetic_batch(dc, s, device="cuda")  # noqa: E731
        require(tuple(batch_fn(0)["embeds"].shape) == (TRAIN_BATCH, TRAIN_SEQ, cfg.frontend_dim),
                f"phase 10 {cfg.name} embeds")
        opt = adamw(warmup_cosine(3e-4, warmup=1, total=2))
        loop, final, hist, _, _, peak = _train_run(torch, cfg, opt, params, batch_fn, 2, f"phase 10 {cfg.name} adamw")
        moved = bool((final["frontend_proj"] != params["frontend_proj"]).any())
        print(f"phase 10 {cfg.name} cut to {cfg.n_layers} layer, on embeds (batch {TRAIN_BATCH} x {TRAIN_SEQ} x "
              f"{cfg.frontend_dim}): losses {hist}, step times s {[round(t, 3) for t in loop.step_times]}, "
              f"frontend_proj moved: {moved}; peak memory {peak / 2**30:.2f} GiB")
        require(all(math.isfinite(h) for h in hist) and moved and not nonzero(cuda_lib.launch_counts()),
                f"phase 10 {cfg.name} on embeds: losses {hist}, frontend_proj moved {moved}")
        records[f"{cfg.name} (embeds, adamw)"] = dict(layers=layers, losses=hist, step_s=loop.step_times,
                                                       peak_gib=peak / 2**30)
        del params, final
        gc.collect()
        torch.cuda.empty_cache()
    # (d), both launchers on the card, runs beside phase 12 (Background).
    return launches, device_launches, records


def precond_ranks(devices) -> int:
    """The ranks a ``solve_many(devices=)`` mesh, or ``(mesh, axes)`` pair,
    shards a bucket over."""
    import torch.distributed as dist

    from repro_torch.parallel import axes_group

    mesh, axes = devices if isinstance(devices, tuple) else (devices, devices.mesh_dim_names)
    return dist.get_world_size(axes_group(mesh, axes)[0])


def _digest(torch, *tensors) -> str:
    """A SHA-256 of the tensors' bytes: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _band_input(torch):
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    A = torch.randn((DIST_N, DIST_N), generator=g, device="cuda")
    return A + A.T


def _refresh_stack(torch, blocks: int):
    """Phase 6a's synthetic statistics, G G^T / 256 + 1e-3 I, seeded."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    G = torch.randn((blocks, N_BLOCK, 2 * N_BLOCK), generator=g, device="cuda")
    return G @ G.mT / (2 * N_BLOCK) + 1e-3 * torch.eye(N_BLOCK, device="cuda")


def _psum_input(torch):
    return torch.randn((16, 64), generator=torch.Generator(device="cuda").manual_seed(SEED + 13), device="cuda")


def _dist_refresh(torch, tag: str, devices, blocks: int):
    """``solve_many(op="inverse_pth_root", devices=devices)`` on the synthetic
    statistics: this rank's kernels A, B and C launched exactly its share
    x one ``plan(128)`` solve's, its roots on ``ROOT_BLOCKS`` seeded blocks
    within ``TOL_ROOT`` of float64; then an eigh run.  Returns the record,
    the eigh run's eigenvalues and digests of both results."""
    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan, solve_many

    p, eps, cfg = 4, 1e-6, EvdConfig(b=8, nb=64)
    S = _refresh_stack(torch, blocks)
    pl = plan(N_BLOCK, torch.float32, cfg)
    cuda_lib.reset_launch_counts()
    pl.inverse_pth_root(S[0], p, eps=eps)
    torch.cuda.synchronize()
    one, one_dev = nonzero(cuda_lib.launch_counts()), nonzero(cuda_lib.device_launch_counts())
    share = -(-blocks // precond_ranks(devices))
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = solve_many(S, cfg, op="inverse_pth_root", p=p, eps=eps, devices=devices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, got_dev = nonzero(cuda_lib.launch_counts()), nonzero(cuda_lib.device_launch_counts())
    print(f"{tag} (b) solve_many(inverse_pth_root, devices=) of {blocks} blocks: {secs:.2f} s; this rank "
          f"launched {got} (CUDA {got_dev}) = {share} x one plan({N_BLOCK}) solve's {one} (CUDA {one_dev})")
    require(got == {op: share * c for op, c in one.items()}, f"{tag} (b) launches {got}")
    require(got_dev == {op: share * c for op, c in one_dev.items()}, f"{tag} (b) CUDA launches {got_dev}")
    require(tuple(X.shape) == (blocks, N_BLOCK, N_BLOCK) and bool(torch.isfinite(X).all()), f"{tag} (b) roots")
    idx = torch.randperm(blocks, generator=torch.Generator().manual_seed(SEED))[:ROOT_BLOCKS].cuda()
    err, _, lib_err = root_errors(torch, S, X, idx, eps)
    print(f"{tag} (b) roots on {len(idx)} seeded blocks vs float64: max rel err {float(err.max()):.3e} (tol "
          f"{TOL_ROOT:.0e}; float32 torch.linalg.eigh {float(lib_err.max()):.3e})")
    require(bool((err < TOL_ROOT).all()), f"{tag} (b) roots vs float64")
    t0 = time.perf_counter()
    w, _ = solve_many(S, cfg, devices=devices)
    torch.cuda.synchronize()
    eigh_s = time.perf_counter() - t0
    record = dict(blocks=blocks, share=share, s=secs, eigh_s=eigh_s, launches=got, device_launches=got_dev,
                  root_err=float(err.max()), backend=dist.get_backend())
    return record, w.cpu(), _digest(torch, X), _digest(torch, w)


def _dist_psum(torch, mesh):
    """``compressed_psum`` of a replicated input, then of one input a rank
    (the input times 1 + rank / 4)."""
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum

    x = _psum_input(torch)
    own = x * (1.0 + 0.25 * dist.get_rank())
    return dict(x=x.cpu(), y=compressed_psum(mesh, "x", x).cpu(), x_own=own.cpu(),
                y_own=compressed_psum(mesh, "x", own).cpu())


def _dist_rank():
    """Phase 11 (a)-(d) in one rank of the gloo world (every rank runs it)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.backend.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import dist_band_reduce
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.launch import make_local_mesh
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    tag = f"phase 11 rank {rank}"
    mesh = make_mesh((dist.get_world_size(),), ("x",))
    out = dict(backend=dist.get_backend(), device=torch.cuda.current_device())

    # (a) The distributed band reduction with kernel E's panel QR.
    A = _band_input(torch)
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    B = dist_band_reduce(mesh, "x", A, DIST_B, DIST_NB, panel_qr_fn=ops.panel_qr)
    torch.cuda.synchronize()
    out["a"] = dict(s=time.perf_counter() - t0, launches=nonzero(cuda_lib.launch_counts()),
                    device_launches=nonzero(cuda_lib.device_launch_counts()),
                    digest=_digest(torch, B), input_digest=_digest(torch, A), B=B.cpu() if rank == 0 else None)
    print(f"{tag} (a) dist_band_reduce n={DIST_N} b={DIST_B} nb={DIST_NB}: {out['a']['s']:.2f} s; launches "
          f"{out['a']['launches']} (CUDA {out['a']['device_launches']})")
    del A, B

    # (b) The synthetic refresh, sharded over the local mesh.
    out["b"], w, out["b_X_digest"], out["b_w_digest"] = _dist_refresh(torch, tag, make_local_mesh(), DIST_BLOCKS)
    out["b_w"] = w if rank == 0 else None

    # (c) Shampoo with precond_mesh over both axes of the local mesh.
    arch, layers, batch, seq, steps = DIST_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    _, _, record, (_, _, _, _, first) = shampoo_training(
        torch, f"{tag} (c)", cfg, batch, seq, steps, repeat=False, precond_mesh=(make_local_mesh(), ("data", "model")))
    del record["launches"]
    out["c"] = dict(record, step1_params_digest=_digest(torch, *leaves(first[0])))

    # (d) compressed_psum.
    out["d"] = _dist_psum(torch, mesh)
    return out


def _nccl_rank():
    """Phase 11 (e): a world of one rank on NCCL, (b) at 64 blocks and (d)."""
    import torch
    import torch.distributed as dist

    from repro_torch.backend.compat import make_mesh
    from repro_torch.launch import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "phase 11 (e) a world of one on NCCL")
    record, _, _, _ = _dist_refresh(torch, "phase 11 (e) nccl", make_local_mesh(), DIST_NCCL_BLOCKS)
    psum = _dist_psum(torch, make_mesh((1,), ("x",)))
    return dict(b=record, d=psum)


def _psum_reference(torch, xs):
    """``compressed_psum``'s value from every rank's input, in plain
    PyTorch: each input's per-row int8 payload and float32 scale (max|row| /
    127), the payloads summed exactly, times the mean scale, over n; float64."""
    qs, ss = [], []
    for x in xs:
        s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 127.0
        qs.append(torch.clamp(torch.round(x / s), -127, 127).double())
        ss.append(s.double())
    n = len(xs)
    return sum(qs) * (sum(ss) / n) / n


def _psum_gates(torch, label: str, results) -> float:
    """Each rank's result equal, within ``TOL_PSUM_EXACT`` of each entry,
    to the algorithm's value from every rank's input (``_psum_reference``),
    for the replicated input and for one input a rank; every rank the same
    bits; the replicated input back within ``TOL_PSUM`` of itself.  Prints,
    beside them, how far one input a rank lands from the float mean within
    the int8 bound (half a step of the largest scale a row, plus the
    scales' spread over 127 steps)."""
    errs = {}
    for key in ("", "_own"):
        ref = _psum_reference(torch, [r["d"]["x" + key].cuda() for r in results]).cpu()
        got = results[0]["d"]["y" + key].double()
        errs[key] = float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())
    x = results[0]["d"]["x"].double()
    err = float((results[0]["d"]["y"].double() - x).abs().max() / x.abs().max())
    xs = [r["d"]["x_own"].double() for r in results]
    mean = sum(xs) / len(xs)
    scales = torch.stack([t.abs().amax(-1, keepdim=True) / 127 for t in xs])
    bound = 0.5 * scales.max(0).values + (scales.max(0).values - scales.min(0).values) * 127
    own_err = float(((results[0]["d"]["y_own"].double() - mean).abs() / bound).max())
    print(f"{label} (d) compressed_psum over {len(results)} ranks: vs the int8 algorithm's value from every "
          f"rank's input, max rel err {errs['']:.3e} (replicated input), {errs['_own']:.3e} (one input a rank) "
          f"(tol {TOL_PSUM_EXACT:.0e}); replicated input back within {err:.3e} of max|x| (tol {TOL_PSUM}); "
          f"one input a rank {own_err:.3f} of the int8 bound from their float mean")
    require(errs[""] < TOL_PSUM_EXACT and errs["_own"] < TOL_PSUM_EXACT and err < TOL_PSUM,
            f"{label} (d) compressed_psum")
    require(all(torch.equal(r["d"]["y"], results[0]["d"]["y"]) and torch.equal(r["d"]["y_own"], results[0]["d"]["y_own"])
                for r in results), f"{label} (d) compressed_psum differs across ranks")
    return err


def phase_distributed(torch, phase6a_ms: float):
    """Phase 11: the multi-device EVD and the sharded Shampoo refresh on the
    card, four gloo ranks sharing it, then a world of one on NCCL."""
    import gc

    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.backend import registry
    from repro_torch.parallel import run_ranks
    from repro_torch.solver import EvdConfig, solve_many

    gc.collect()
    torch.cuda.empty_cache()
    R = DIST_RANKS
    t0 = time.perf_counter()
    res = run_ranks(_dist_rank, R, backend="gloo", device_type="cuda", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    require([r["backend"] for r in res] == ["gloo"] * R, "phase 11 gloo ranks")

    # (a) against the one-process band reduction with the same panel QR
    # (kernel E): with the same trailing-update arithmetic (the row blocks
    # of dist_band_reduce's float32 products, or the torch op where the
    # side does not split), and with kernel D's (3xTF32), which rounds
    # otherwise.  The band's entries carry rounding far more than its
    # eigenvalues do: kernel D's band and one with float32 torch.matmul
    # trailing updates sit 2.9e-4 of max|B| apart at n = 4096, both with
    # eigenvalues within 1.1e-7 of float64 (PERF.md).
    def row_blocked_update(C, Y, Z):
        m = C.shape[0]
        if m % R or m < R:
            return registry.resolve("trailing_update", "torch")(C, Y, Z)
        r = m // R
        return torch.cat([C[i * r:(i + 1) * r] - Z[i * r:(i + 1) * r] @ Y.T - Y[i * r:(i + 1) * r] @ Z.T
                          for i in range(R)])

    A = _band_input(torch)
    require(all(r["a"]["input_digest"] == _digest(torch, A) for r in res), "phase 11 (a) one input on every rank")
    B = res[0]["a"]["B"].cuda()
    B_same = band_reduce(A, DIST_B, DIST_NB, panel_method="kernel", syr2k_update=row_blocked_update)
    B_kernel = band_reduce(A, DIST_B, DIST_NB, panel_method="kernel")
    err, err_d, err_dd = rel_err(B, B_same), rel_err(B, B_kernel), rel_err(B_same, B_kernel)
    w_ref = torch.linalg.eigvalsh(A.double())
    e_eig, e_eig_d = (float((torch.linalg.eigvalsh(X.double()) - w_ref).abs().max() / w_ref.abs().max())
                      for X in (B, B_kernel))
    sched = build_stage_schedule(DIST_N, DIST_B, DIST_NB)
    same_a = len({r["a"]["digest"] for r in res}) == 1
    print(f"phase 11 (a) dist_band_reduce on {R} gloo ranks: band vs one-process band_reduce(panel_method="
          f"'kernel', its trailing updates in the same row blocks) {err:.3e} of max|B| (tol {TOL_BAND:.0e}); vs "
          f"band_reduce(panel_method='kernel') (kernel D) {err_d:.3e}, the two one-process bands {err_dd:.3e} "
          f"apart; band eigenvalues vs float64 eigvalsh(A) {e_eig:.3e} of max|w| (kernel D's band {e_eig_d:.3e}; "
          f"tol {TOL_BAND_EIG:.0e}); every rank bitwise equal: {same_a}; kernel E launches per rank "
          f"{[r['a']['launches'].get('panel_qr') for r in res]} ({sched.num_panels} panels); wall s per rank "
          f"{[round(r['a']['s'], 2) for r in res]}")
    require(err < TOL_BAND and e_eig < TOL_BAND_EIG and e_eig_d < TOL_BAND_EIG and same_a,
            "phase 11 (a) distributed band")
    for r in res:
        require(r["a"]["launches"] == {"panel_qr": sched.num_panels}
                and r["a"]["device_launches"] == {"panel_qr": sched.num_panels}, f"phase 11 (a) launches {r['a']}")
    del A, B, B_same, B_kernel

    # (b) against the one-process bucket.
    S = _refresh_stack(torch, DIST_BLOCKS)
    w_one, _ = solve_many(S, EvdConfig(b=8, nb=64))
    w = res[0]["b_w"].cuda()
    e_w = float(((w - w_one).abs().amax(-1) / w_one.abs().amax(-1)).max())
    same_b = len({(r["b_X_digest"], r["b_w_digest"]) for r in res}) == 1
    print(f"phase 11 (b) {DIST_BLOCKS} blocks on {R} gloo ranks ({res[0]['b']['share']} a rank): roots "
          f"{[round(r['b']['s'], 2) for r in res]} s per rank against phase 6a's {phase6a_ms / 1e3:.2f} s for "
          f"1536 in one process; eigh run {[round(r['b']['eigh_s'], 2) for r in res]} s; eigenvalues vs the "
          f"one-process bucket {e_w:.3e} of max|w| (tol {TOL_EIG:.0e}); every rank bitwise equal: {same_b}")
    require(e_w < TOL_EIG and same_b, "phase 11 (b) sharded refresh")
    del S, w_one

    # (c) Shampoo with precond_mesh.
    same_c = len({r["c"]["step1_params_digest"] for r in res}) == 1
    print(f"phase 11 (c) {DIST_TRAIN[0]} Shampoo with precond_mesh on {R} gloo ranks: step 1 s "
          f"{[round(r['c']['step1_s'], 2) for r in res]}, steady ms {[round(r['c']['steady_ms'], 1) for r in res]}, "
          f"peak GiB {[round(r['c']['peak_gib'], 2) for r in res]}; step-1 parameters bitwise equal: {same_c}")
    require(same_c, "phase 11 (c) step-1 parameters differ across ranks")

    # (d) compressed_psum.
    psum_err = _psum_gates(torch, "phase 11", res)

    # (e) A world of one rank on NCCL.
    t1 = time.perf_counter()
    (nccl,) = run_ranks(_nccl_rank, 1, backend="nccl", device_type="cuda", timeout_s=300)
    nccl_s = time.perf_counter() - t1
    require(nccl["b"]["backend"] == "nccl", "phase 11 (e) NCCL world")
    _psum_gates(torch, "phase 11 (e) nccl", [nccl])
    print(f"phase 11 (e) a world of one rank on NCCL: {DIST_NCCL_BLOCKS} blocks in {nccl['b']['s']:.2f} s, roots "
          f"{nccl['b']['root_err']:.3e} from float64; the world {nccl_s:.1f} s with its start-up")
    print(f"phase 11 the {R} gloo ranks took {ranks_s:.1f} s with their start-up")
    return dict(
        ranks=R, ranks_s=ranks_s, nccl_s=nccl_s,
        band=dict(err=err, err_vs_kernel_d=err_d, eig_err=e_eig, s=[r["a"]["s"] for r in res]),
        refresh=dict(blocks=DIST_BLOCKS, share=res[0]["b"]["share"], s=[r["b"]["s"] for r in res],
                     eigh_s=[r["b"]["eigh_s"] for r in res], eig_err=e_w, root_err=[r["b"]["root_err"] for r in res]),
        shampoo=[r["c"] for r in res], psum_err=psum_err, nccl=nccl["b"],
        launches_per_rank={"a": res[0]["a"]["launches"], "b": res[0]["b"]["launches"]})


def _shard_cfg(arch: str, layers: int, dtype: str, **over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype, **over)


def _explicit_policy(mesh, cfg, param: dict, act: dict):
    """``make_policy(mesh, cfg)`` with some rules replaced (a shard mode that
    ``resolve_*`` does not pick at this mesh)."""
    from repro_torch.parallel import ShardingPolicy, make_policy

    base = make_policy(mesh, cfg, fsdp=True)
    return ShardingPolicy(mesh, {**base.param_rules, **param}, {**base.activation_rules, **act})


def _gloo_bf16(torch):
    """Whether gloo sums bfloat16 CUDA tensors right (c10d all_reduce)."""
    import torch.distributed as dist

    x = torch.full((1024,), 1.0 + dist.get_rank(), dtype=torch.bfloat16, device="cuda")
    dist.all_reduce(x)
    n = dist.get_world_size()
    return bool((x.float() == n * (n + 1) / 2).all())


def shard_leaf_gate(paths, got, ref, ref64, scales, floor: float, against: str = "ref", factor: float = 2.0):
    """Per leaf: ``err``, the sharded step's tensor ``got`` against the
    one-process step's ``ref`` (``against="ref"``) or against the same step
    in float64, ``ref64`` (``against="float64"``); ``noise``, ``ref``'s own
    distance from ``ref64``; and the limit ``tol``, ``floor`` or ``factor``
    x ``noise`` where that is larger.  All of the leaf's entry of ``scales``.
    The rows sorted by err / tol, the tightest first."""
    rows = []
    for path, a, b, d, scale in zip(paths, got, ref, ref64, scales):
        a, b, d = a.double(), b.double(), d.double()
        err = float((a - (b if against == "ref" else d)).abs().max()) / scale
        noise = float((b - d).abs().max()) / scale
        rows.append(dict(path=path, err=err, noise=noise, tol=max(floor, factor * noise)))
    return sorted(rows, key=lambda r: r["err"] / r["tol"], reverse=True)


def _shard_case(torch, tag: str, cfg, policy, batch: int, seq: int, steps: int, *, opt=None, sens=False,
                ref=True, momentum=False):
    """``steps`` sharded steps of ``cfg`` under ``policy`` from seeded whole
    weights (the same on every rank) and one seeded batch, this rank's rows
    of it; then the same steps in this process alone on the whole weights.
    Returns the losses (and their bits), per-step ms, the bytes a step
    moved by tag, the peak memory of the sharded steps, the kernels'
    launches, and the gathered weights' distance from the one-process
    step's (in float32 with AdamW, the weights leaf by leaf under
    :func:`shard_leaf_gate`, and with ``momentum`` the momentum too)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib
    from repro_torch.models import model_meta, model_params
    from repro_torch.optim import adamw
    from repro_torch.parallel import comm, gather_params, shard_params
    from repro_torch.train import make_loss_fn, make_train_step
    from repro_torch.train.step import init_opt_state
    from repro_torch.tree import flatten_with_paths, leaves, tree_map

    t_case = time.perf_counter()
    opt = adamw(SHARD_LR) if opt is None else opt
    whole = model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 21), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device="cuda", dtype=torch.int32)
    full = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    res = policy.resolver()
    n, i = res.size("act_batch"), res.index("act_batch")
    rows = {k: v[i * batch // n:(i + 1) * batch // n] for k, v in full.items()}

    def start(state):
        if hasattr(state, "stats_l"):
            return state
        return state._replace(nu=tree_map(torch.ones_like, state.nu))

    params = shard_params(whole, policy.param_shardings(model_meta(cfg)))
    state = start(init_opt_state(opt, params))
    whole = tree_map(lambda t: t.cpu(), whole) if ref else None  # off the card during the sharded steps
    step = make_train_step(cfg, opt, policy=policy)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    losses, bits, ms, traffic, first_state = [], [], [], [], None
    for k in range(steps):
        comm.reset_traffic()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, rows, k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        bits.append(m["loss"].cpu().numpy().tobytes().hex())
        traffic.append(dict(comm.traffic))
        first_state = state if first_state is None else first_state
    launches = nonzero(cuda_lib.launch_counts())
    device_launches = nonzero(cuda_lib.device_launch_counts())
    peak = torch.cuda.max_memory_allocated()
    rec = dict(losses=losses, loss_bits=bits, ms=ms, traffic=traffic, peak_gib=peak / 2**30, launches=launches,
               device_launches=device_launches)
    if opt.whole_leaves:
        rec["state"] = first_state
    print(f"{tag} rank {dist.get_rank()}: losses {losses}, step ms {[round(t, 1) for t in ms]}, peak "
          f"{peak / 2**30:.2f} GiB, bytes a step {traffic[-1]}, launches {launches}")
    rec["case_s"] = time.perf_counter() - t_case
    if not ref:
        return rec
    t_ref = time.perf_counter()
    gated = cfg.dtype == "float32" and steps == 1 and not opt.whole_leaves
    new = gather_params(params)
    mu = gather_params(state.mu) if gated and momentum else None
    del params, state
    rec["gather_s"] = time.perf_counter() - t_ref
    if dist.get_rank() != 0:  # one rank holds the one-process step (four would not fit the card)
        del new, mu, whole
        torch.cuda.empty_cache()
        dist.barrier()
        return rec
    whole = tree_map(lambda t: t.cuda(), whole)
    ref_p, ref_s = whole, start(opt.init(whole))
    ref_step = make_train_step(cfg, opt)
    ref_losses = []
    for k in range(steps):
        ref_p, ref_s, m = ref_step(ref_p, ref_s, full, k)
        ref_losses.append(float(m["loss"]))
    moved = max(float((a - b).abs().max()) for a, b in zip(leaves(ref_p), leaves(whole)))
    rec["ref_losses"] = ref_losses
    paths = flatten_with_paths(whole)[0]
    rec["param_err"] = max(float((a - b).abs().max()) for a, b in zip(leaves(new), leaves(ref_p))) / moved
    rec["max_delta"] = moved
    if gated:  # the one-process float32 step against the same step in float64
        c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
        p64 = tree_map(lambda t: t.double(), whole)
        whole = None  # (sens is for bf16 steps only)
        if not momentum:  # only the momentum gate reads the float32 state
            ref_s = None
        # Off the card during the float64 step (recurrentgemma-2b's unit
        # with its 2.6 GB table takes ~45 GB there), back for the gates.
        new, ref_p = tree_map(lambda t: t.cpu(), new), tree_map(lambda t: t.cpu(), ref_p)
        torch.cuda.empty_cache()
        n64, s64, _ = make_train_step(c64, opt)(p64, start(opt.init(p64)), full, 0)
        del p64
        if not momentum:
            s64 = None
        torch.cuda.empty_cache()
        new, ref_p = tree_map(lambda t: t.cuda(), new), tree_map(lambda t: t.cuda(), ref_p)
        n = len(paths)
        rec["leaf_gate"] = shard_leaf_gate(paths, leaves(new), leaves(ref_p), leaves(n64), [moved] * n,
                                           TOL_SHARD_PARAMS)
        if momentum:
            rec["mu_gate"] = shard_leaf_gate(paths, leaves(mu), leaves(ref_s.mu), leaves(s64.mu),
                                             [max(float(m.abs().max()), 1e-30) for m in leaves(s64.mu)],
                                             TOL_SHARD_MU, against="float64", factor=SHARD_MU_FACTOR)
        del n64, s64, mu
    if sens:  # the bf16 loss's change when the embedding moves by one bf16 ulp
        loss_fn = make_loss_fn(cfg)
        sign = torch.randint(0, 2, whole["embed"].shape, generator=g, device="cuda") * 2.0 - 1
        bumped = dict(whole, embed=whole["embed"] * (1 + sign * 2.0 ** -8))
        with torch.no_grad():
            rec["ulp_sensitivity"] = abs(float(loss_fn(bumped, full)[0]) - float(loss_fn(whole, full)[0]))
        del sign, bumped
    del new, ref_p, ref_s, whole
    torch.cuda.empty_cache()
    rec["ref_s"] = time.perf_counter() - t_ref
    dist.barrier()
    return rec


def _shard_rank():
    """Phase 12 (a)-(d) in one rank of the gloo world (every rank runs it)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_local_mesh
    from repro_torch.optim import ShampooOptions, shampoo
    from repro_torch.parallel import make_policy, resolve_attn_mode, resolve_moe_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(2)
    out = dict(backend=dist.get_backend(), gloo_bf16=_gloo_bf16(torch), started=time.time())
    tag = f"phase 12 rank {dist.get_rank()}"

    # (a) llama3.2-3b, heads mode, FSDP: bf16 AdamW steps, a sequence-parallel step, a float32 step.
    arch, layers, batch, seq = SHARD_DENSE
    mode = resolve_attn_mode(_shard_cfg(arch, layers, "bfloat16"), 2)
    for key, dtype, steps, sp in (("a", "bfloat16", 2, False), ("a_sp", "bfloat16", 1, True),
                                  ("a_f32", "float32", 1, False)):
        cfg = _shard_cfg(arch, layers, dtype, attn_shard_mode=mode)
        out[key] = _shard_case(torch, f"{tag} ({key})", cfg, make_policy(mesh, cfg, fsdp=True, sequence_parallel=sp),
                               batch, seq, steps, sens=dtype == "bfloat16", momentum=dtype == "float32")
    out["a_mode"] = mode

    # (b) the other attention modes, float32, through explicit policies.
    for key, mode, param, act in (
            ("b_q_heads", "q_heads", {"q_heads": "model", "kv_heads": None},
             {"act_heads": "model", "act_kv_heads": None, "act_q_chunks": None}),
            ("b_cp", "cp", {"q_heads": None, "kv_heads": None},
             {"act_heads": None, "act_kv_heads": None, "act_q_chunks": "model"})):
        # cp owns query chunks: 64-token chunks give each model rank one of the 2.
        chunk = dict(attn_chunk=seq // 2) if mode == "cp" else {}
        cfg = _shard_cfg(arch, layers, "float32", attn_shard_mode=mode, **chunk)
        out[key] = _shard_case(torch, f"{tag} ({key})", cfg, _explicit_policy(mesh, cfg, param, act), batch, seq, 1)

    # (c) granite-moe: ep (resolved), capacity and tp, float32.
    arch_m, layers_m, batch_m, seq_m = SHARD_MOE
    base = _shard_cfg(arch_m, layers_m, "float32")
    moe_mode = resolve_moe_mode(base, 2)
    for key, mode, param, act in (
            ("c_" + moe_mode, moe_mode, {}, {}),
            ("c_capacity", "capacity", {"experts": None, "expert_mlp": None},
             {"act_experts": None, "act_capacity": "model", "act_expert_mlp": None}),
            ("c_tp", "tp", {"experts": None, "expert_mlp": "model"},
             {"act_experts": None, "act_capacity": None, "act_expert_mlp": "model"})):
        cfg = _shard_cfg(arch_m, layers_m, "float32", attn_shard_mode=resolve_attn_mode(base, 2),
                         moe_shard_mode=mode)
        out[key] = _shard_case(torch, f"{tag} ({key})", cfg, _explicit_policy(mesh, cfg, param, act),
                               batch_m, seq_m, 1, momentum=mode == moe_mode)
    out["c_mode"] = moe_mode

    # (d) Shampoo under (c)'s resolved policy, its refresh split over both
    # axes (granite's whole leaves and Shampoo state fit four ranks on the
    # card; llama's 1.5 GiB embedding, with its Adam moments and gathered
    # gradient, does not).
    cfg = _shard_cfg(arch_m, layers_m, "float32", attn_shard_mode=resolve_attn_mode(base, 2), moe_shard_mode=moe_mode)
    opts = ShampooOptions(precond_mesh=(mesh, ("data", "model")))
    opt = shampoo(SHARD_LR, opts)
    out["d"] = _shard_case(torch, f"{tag} (d)", cfg, make_policy(mesh, cfg, fsdp=True), batch_m, seq_m, 1, opt=opt,
                           ref=False)
    st = out["d"].pop("state")
    idx = torch.randperm(st.stats_l.shape[0], generator=torch.Generator().manual_seed(SEED))[:ROOT_BLOCKS].cuda()
    out["d"]["blocks"] = st.stats_l.shape[0]
    out["d"]["root_err"] = {side: float(root_errors(torch, getattr(st, "stats_" + side), getattr(st, "pre_" + side),
                                                    idx, opts.eps)[0].max()) for side in ("l", "r")}
    del st, idx  # (d)'s Shampoo state, before phase 13's cases
    out["p13"] = _mixer_rank(mesh)
    return out


def phase_sharding(torch):
    """Phase 12: the sharded train step (model sharding) on four gloo ranks
    sharing the card, on a (2, 2) ("data", "model") mesh."""
    import gc

    from repro_torch.parallel import run_ranks
    from repro_torch.solver import EvdConfig, plan

    gc.collect()
    torch.cuda.empty_cache()
    t0, t_wall = time.perf_counter(), time.time()
    # The ranks' allocators grow segments in place: phase 13's one-process
    # float64 reference on rank 0 left 8 GiB reserved in fragments beside
    # its 41 GiB (an NVIDIA H100 80GB HBM3) and ran out of memory.
    import os

    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        res = run_ranks(_shard_rank, SHARD_RANKS, backend="gloo", device_type="cuda", timeout_s=900)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    mixers = [r.pop("p13") for r in res]  # phase 13 (a), run by the same ranks
    ranks_s = time.perf_counter() - t0 - max(m["s"] for m in mixers)
    start_s = max(r["started"] for r in res) - t_wall
    require([r["backend"] for r in res] == ["gloo"] * SHARD_RANKS, "phase 12 gloo ranks")
    gloo_bf16 = all(r["gloo_bf16"] for r in res)
    print(f"phase 12 gloo all_reduce of bfloat16 CUDA tensors right on every rank: {gloo_bf16} (the step reduces "
          f"in float32 whatever it finds)")
    keys = [k for k in res[0] if isinstance(res[0][k], dict)]  # the cases, in run order
    summary, failed = {}, []
    for key in keys:
        recs = [r[key] for r in res]
        first = recs[0]
        same = all(r["loss_bits"] == first["loss_bits"] for r in recs)
        require(same, f"phase 12 ({key}) losses differ across ranks: {[r['losses'] for r in recs]}")
        traffic = first["traffic"][-1]
        line = (f"phase 12 ({key}) losses {first['losses']} on every rank bit for bit; step ms per rank "
                f"{[[round(t, 1) for t in r['ms']] for r in recs]}; peak GiB per rank "
                f"{[round(r['peak_gib'], 2) for r in recs]}; bytes a step on rank 0: parameter gathers "
                f"{traffic.get('param', 0)}, gradient sums {traffic.get('grad', 0)}, activations {traffic.get('act', 0)}")
        entry = dict(losses=first["losses"], ms=[r["ms"] for r in recs], peak_gib=[r["peak_gib"] for r in recs],
                     traffic=traffic)
        if "ref_losses" in first:
            rel = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], first["ref_losses"]))
            entry.update(ref_losses=first["ref_losses"], loss_rel=rel, param_err=first["param_err"])
            if "ulp_sensitivity" in first:
                bound = SENS_FACTOR * first["ulp_sensitivity"]
                diff = max(abs(a - b) for a, b in zip(first["losses"], first["ref_losses"]))
                line += (f"; bf16 vs one process {first['ref_losses']}: |diff| {diff:.3e} (bound {bound:.3e} = "
                         f"{SENS_FACTOR:g} x the loss's change {first['ulp_sensitivity']:.3e} when the embedding "
                         f"moves one bf16 ulp)")
                entry.update(diff=diff, bound=bound)
                ok = diff <= bound
            else:
                rows, mus = first["leaf_gate"], first.get("mu_gate", [])
                ok = rel < TOL_SHARD_LOSS and all(r["err"] < r["tol"] for r in rows + mus)

                def tight(rs):
                    return [(r["path"], f"{r['err']:.3e}", f"{r['noise']:.3e}", f"{r['tol']:.3e}") for r in rs[:3]]

                line += (f"; float32 vs one process: loss rel {rel:.3e} (tol {TOL_SHARD_LOSS:.0e}), gathered weights "
                         f"{first['param_err']:.3e} of the largest change {first['max_delta']:.3e}; tightest leaves "
                         f"(path, err, one process vs float64, tol): weights (against one process) {tight(rows)}"
                         + (f", momentum (against float64) {tight(mus)}" if mus else ""))
                entry.update(leaf_gate=rows[:3], mu_gate=mus[:3])
            line += (f"; rank 0's case {first['case_s']:.1f} s, the weights' gather {first['gather_s']:.1f} s, the "
                     f"one-process check {first['ref_s']:.1f} s")
        print(line)
        if "ref_losses" in first and not ok:
            failed.append(f"({key}) vs one process")
        if key != "d" and any(r["launches"] for r in recs):
            failed.append(f"({key}) AdamW steps launched kernels")
        summary[key] = entry
    require(not failed, f"phase 12 {failed}")  # after every case's line

    # (d) Shampoo: each rank's share of the refresh, the roots against float64.
    d = [r["d"] for r in res]
    pl = plan(N_BLOCK, torch.float32, EvdConfig(b=8, nb=64))
    one = solve_launches(pl)
    from repro_torch.kernels import cuda_lib

    cuda_lib.reset_launch_counts()
    pl(torch.eye(N_BLOCK, device="cuda"))
    one_dev = nonzero(cuda_lib.device_launch_counts())
    share = -(-d[0]["blocks"] // SHARD_RANKS)
    ref = summary["c_" + res[0]["c_mode"]]["ref_losses"][0]
    d_rel = abs(d[0]["losses"][0] - ref) / abs(ref)
    print(f"phase 12 (d) Shampoo with precond_mesh over both axes: {d[0]['blocks']} blocks a side, {share} a rank; "
          f"launches per rank {[r['launches'] for r in d]} (CUDA {[r['device_launches'] for r in d]}) against 2 x "
          f"{share} x one plan({N_BLOCK}) solve's {one} (CUDA {one_dev}); roots vs float64 on {ROOT_BLOCKS} seeded "
          f"blocks {[r['root_err'] for r in d]} (tol {TOL_ROOT:.0e}); step-1 loss vs (c)'s float32 one-process loss "
          f"(the same weights and batch) rel {d_rel:.3e} (tol {TOL_SHARD_LOSS:.0e}); rank 0's case {d[0]['case_s']:.1f} s")
    for r in d:
        require(r["launches"] == {op: 2 * share * c for op, c in one.items()}, f"phase 12 (d) launches {r['launches']}")
        require(r["device_launches"] == {op: 2 * share * c for op, c in one_dev.items()},
                f"phase 12 (d) CUDA launches {r['device_launches']}")
        require(all(e < TOL_ROOT for e in r["root_err"].values()), f"phase 12 (d) roots {r['root_err']}")
    require(d_rel < TOL_SHARD_LOSS, "phase 12 (d) loss vs one process")
    summary["d"].update(blocks=d[0]["blocks"], share=share, root_err=[r["root_err"] for r in d],
                        launches_per_rank=[r["launches"] for r in d])
    print(f"phase 12 the {SHARD_RANKS} gloo ranks took {ranks_s:.1f} s, {start_s:.1f} s of it their start-up (and "
          f"then phase 13 (a))")
    return dict(ranks=SHARD_RANKS, ranks_s=ranks_s, start_s=start_s, gloo_bf16=gloo_bf16, attn_mode=res[0]["a_mode"],
                moe_mode=res[0]["c_mode"], cases=summary, mixers=mixers)


def _mixer_kw(layers: int, batch: int, seq: int) -> dict:
    """The dry-run keywords of a phase 13 (a) cell on the (2, 2) mesh."""
    return dict(mesh_override=(2, 2), overrides=dict(n_layers=layers, dtype="float32"), pure_dp=False,
                shape_overrides=dict(batch=batch, seq=seq))


def _serve_shard_case(torch, tag: str, cfg, policy, batch: int):
    """Sharded ``make_prefill`` and teacher-forced + greedy
    ``make_serve_step`` from seeded whole weights, then the same positions'
    logits through ``decode_step`` under the resolver (gathered over the
    vocabulary and the batch); on rank 0 the one-process prefill, decode
    and forward (and its change when the embedding moves one ulp)."""
    import torch.distributed as dist

    from repro_torch.launch.cache_specs import cache_partition_specs, shard_cache
    from repro_torch.models import cache_init, cache_meta, decode_step, forward, model_meta, model_params
    from repro_torch.parallel import comm, hints, shard_params
    from repro_torch.train import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    t_case = time.perf_counter()
    P, G = SERVE13_PROMPT, SERVE13_GEN
    T = P + G
    max_len = T + T % 2  # the window splits over the model axis
    mesh = policy.mesh
    whole = model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 31), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    prompts = torch.randint(0, cfg.vocab, (batch, P), generator=g, device="cuda", dtype=torch.int32)
    meta = model_meta(cfg)
    params = shard_params(whole, policy.param_shardings(meta))
    whole = tree_map(lambda t: t.cpu(), whole) if dist.get_rank() == 0 else None
    torch.cuda.empty_cache()
    res = policy.resolver()
    n, i = res.size("act_batch"), res.index("act_batch")
    lo, hi = i * batch // n, (i + 1) * batch // n
    first = make_prefill(cfg, policy=policy)(params, {"tokens": prompts[lo:hi]})
    shardings = cache_partition_specs(cfg, mesh, policy, cache_meta(cfg, batch, max_len))
    step = make_serve_step(cfg, policy=policy)
    fed = torch.zeros((hi - lo, T), dtype=torch.int32, device="cuda")
    fed[:, :P] = prompts[lo:hi]
    cache = shard_cache(cache_init(cfg, batch, max_len), shardings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T - 1):
        tok, cache = step(params, cache, fed[:, t:t + 1])
        if t + 1 >= P:
            fed[:, t + 1] = tok
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (T - 1)
    cache = shard_cache(cache_init(cfg, batch, max_len), shardings)
    local = tree_map(lambda t: t.to_local(), params)
    logits = torch.empty((hi - lo, T, cfg.vocab), dtype=torch.float32, device="cuda")
    vocab, rows = res.axes("act_vocab"), res.batch_axes()
    with torch.inference_mode(), hints.hint_resolver(res.with_params(policy.param_specs(meta))):
        for t in range(T):
            lg, cache = decode_step(local, cfg, cache, tokens=fed[:, t:t + 1])
            logits[:, t] = (comm.all_gather(lg, mesh, vocab, -1) if vocab else lg)[:, 0]
        if rows:
            fed, first, logits = (comm.all_gather(x, mesh, rows, 0) for x in (fed, first, logits))
    del params, local, cache
    rec = dict(step_ms=step_ms, traffic=dict(comm.traffic), tokens=fed[:, P:].cpu())
    if dist.get_rank() != 0:
        del logits
        torch.cuda.empty_cache()
        dist.barrier()
        return rec
    whole = tree_map(lambda t: t.cuda(), whole)
    with torch.inference_mode():
        first_ref = make_prefill(cfg)(whole, {"tokens": prompts})
        ref = _decode_logits(torch, whole, cfg, fed.clone(), T)
        fwd, _ = forward(whole, cfg, tokens=fed)
        ulp = torch.randint(0, 2, whole["embed"].shape, generator=g, device="cuda") * 2.0 - 1
        moved, _ = forward(dict(whole, embed=whole["embed"] * (1 + ulp * 2.0 ** -23)), cfg, tokens=fed)
        del ulp
    scale = float(ref.abs().max())
    rec.update(
        prefill_equal=bool(torch.equal(first, first_ref)),
        tokens_equal=bool(torch.equal(fed[:, P:], ref[:, P - 1:T - 1].argmax(-1).to(fed.dtype))),
        logit_err=float((logits - ref).abs().max()) / scale,
        sens=float((moved - fwd).abs().max()) / float(fwd.abs().max()),
        case_s=time.perf_counter() - t_case)
    del whole, ref, fwd, moved, logits
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _mixer_rank(mesh):
    """Phase 13 (a) and the real half of (c) in one rank of phase 12's
    world."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import cell_config, count_cell
    from repro_torch.parallel import make_policy

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tag = f"phase 13 rank {dist.get_rank()}"
    out = {}
    for key, arch, layers, batch, seq in MIXER_CELLS:
        cfg = cell_config(arch, "train_4k", **_mixer_kw(layers, batch, seq))[0]
        policy = make_policy(mesh, cfg, fsdp=True, pure_dp=False)
        out[key] = _shard_case(torch, f"{tag} ({key})", cfg, policy, batch, seq, 1, momentum=key == "mamba2")
        serve = make_policy(mesh, cfg, fsdp=False, pure_dp=False)  # no FSDP gathers at every decode step
        out[key + "_serve"] = _serve_shard_case(torch, f"{tag} ({key} serve)", cfg, serve, batch)
    _, arch, layers, batch, seq = MIXER_CELLS[0]
    out["counts"] = count_cell(arch, "train_4k", device="cuda", **_mixer_kw(layers, batch, seq))
    out["s"] = time.perf_counter() - t0
    out["shampoo"] = _shampoo_counts()
    return out


def _shampoo_counts():
    """Phase 14 (b)'s real half: the smoke Shampoo cell run for real on
    this rank, without and with the refresh split over the four ranks."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.dryrun import count_cell

    out = {}
    for sharded in SMOKE_SHARDED:
        t0 = time.perf_counter()
        cuda_lib.reset_launch_counts()
        rec = count_cell("llama3.2-3b", "train_4k", device="cuda", timed=False, shampoo_sharded=sharded,
                         **SHAMPOO_SMOKE)
        out[sharded] = dict(rec, launches=nonzero(cuda_lib.launch_counts()), s=time.perf_counter() - t0)
    return out


def _shampoo_rank():
    """:func:`_shampoo_counts` in a rank of its own world (``scripts/phase14.py``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    return _shampoo_counts()


def phase_dryrun(torch, mixers, t_world: float, records=None):
    """Phase 13: (a)'s gates from the ranks' records, (b) the dry-runs of
    the production worlds (``records``: each cell's, as ``Background``
    made it; without, run here), (c) the dry-run against real steps."""
    from repro_torch.launch.dryrun import count_cell, run_cell, summary
    from repro_torch.parallel import comm

    t0 = time.perf_counter()
    failed, out = [], {}
    for key, arch, layers, batch, seq in MIXER_CELLS:
        recs, first = [r[key] for r in mixers], mixers[0][key]
        same = all(r["loss_bits"] == first["loss_bits"] for r in recs)
        rel = abs(first["losses"][0] - first["ref_losses"][0]) / abs(first["ref_losses"][0])
        rows, mus = first["leaf_gate"], first.get("mu_gate", [])
        ok = same and rel < TOL_SHARD_LOSS and all(r["err"] < r["tol"] for r in rows + mus)
        tight = [(r["path"], f"{r['err']:.3e}", f"{r['tol']:.3e}") for r in (rows[:2] + mus[:2])]
        traffic = first["traffic"][-1]
        print(f"phase 13 (a) {arch} ({layers} layers, {batch} x {seq}, mixers tensor-parallel) train step: losses "
              f"{first['losses']} on every rank bit for bit: {same}; vs one process {first['ref_losses']} rel "
              f"{rel:.3e} (tol {TOL_SHARD_LOSS:.0e}); tightest leaves (path, err, tol) {tight}; step ms per rank "
              f"{[round(r['ms'][0], 1) for r in recs]}; peak GiB per rank {[round(r['peak_gib'], 2) for r in recs]}; "
              f"bytes a step on rank 0 {traffic}")
        if not ok:
            failed.append(f"(a) {arch} train step")
        if any(r["launches"] for r in recs):
            failed.append(f"(a) {arch} AdamW step launched kernels")
        sv = [r[key + "_serve"] for r in mixers]
        s0 = sv[0]
        tol = max(TOL_SERVE, SENS_FACTOR * s0["sens"])
        same_tokens = all(torch.equal(r["tokens"], s0["tokens"]) for r in sv)
        ok = s0["prefill_equal"] and s0["tokens_equal"] and same_tokens and s0["logit_err"] <= tol
        print(f"phase 13 (a) {arch} sharded serving (prompt {SERVE13_PROMPT} teacher-forced, {SERVE13_GEN} greedy): "
              f"prefill tokens equal one process's: {s0['prefill_equal']}; greedy tokens equal: {s0['tokens_equal']} "
              f"(every rank the same: {same_tokens}); decode logits {s0['logit_err']:.3e} of max|logits| from one "
              f"process's (tol {tol:.3e} = max({TOL_SERVE:.0e}, {SENS_FACTOR:g} x the forward's 1-ulp change "
              f"{s0['sens']:.3e})); eager step ms per rank {[round(r['step_ms'], 1) for r in sv]}; rank 0's case "
              f"{s0['case_s']:.1f} s")
        if not ok:
            failed.append(f"(a) {arch} serving")
        out[key] = dict(loss_rel=rel, leaf_gate=rows[:3], mu_gate=mus[:3], traffic=traffic,
                        serve=dict(logit_err=s0["logit_err"], tol=tol, step_ms=[r["step_ms"] for r in sv]))
    require(not failed, f"phase 13 {failed}")

    # (b) the production worlds, fake CUDA tensors.
    t_b = time.perf_counter()
    out["dryrun"] = []
    for arch, shape, multi_pod in DRY_CELLS:
        rec = records[(arch, shape, multi_pod)] if records else run_cell(
            arch, shape, multi_pod=multi_pod, device="cuda", top=0, quiet=True)
        require(rec["status"] == "ok" and rec["memory"]["peak_estimate_bytes"] > 0, f"phase 13 (b) {arch} {shape}")
        print(f"phase 13 (b) {summary(rec)}")
        out["dryrun"].append({k: rec[k] for k in ("arch", "shape", "mesh", "trace_s", "memory", "roofline")})
    b_s = time.perf_counter() - t_b

    # (c) the dry-run against real steps: (a)'s mamba2 cell on the world ...
    _, arch, layers, batch, seq = MIXER_CELLS[0]
    rec = run_cell(arch, "train_4k", device="cuda", top=0, quiet=True, **_mixer_kw(layers, batch, seq))
    real = mixers[0]["counts"]
    coll_ok = rec["collectives"] == real["collectives"]
    flops_ok = rec["walk"]["flops_per_device"] == real["flops"]
    bound = rec["roofline"]["bound_step_time_s"]
    print(f"phase 13 (c) {arch} ({layers} layers, {batch} x {seq}) on (2, 2): the fake world's collectives on rank 0 "
          f"equal the real world's exactly: {coll_ok} ({rec['collectives']['total_bytes']} bytes; per kind "
          f"{ {k: (v['count'], v['bytes']) for k, v in rec['collectives']['per_kind'].items()} }); walked FLOPs "
          f"{rec['walk']['flops_per_device']:.6e} equal FlopCounterMode's {real['flops']:.6e}: {flops_ok}; real "
          f"step {real['step_s'] * 1e3:.1f} ms on rank 0 (four gloo ranks share the card) over the bound "
          f"{bound * 1e3:.4f} ms ({rec['roofline']['dominant']}): {real['step_s'] / bound:.1f} x")
    # ... and a one-process llama cell against its real step.
    arch, layers, batch, seq = PEAK_CELL
    kw = dict(mesh_override=(1, 1), overrides=dict(n_layers=layers), shape_overrides=dict(batch=batch, seq=seq))
    prec = run_cell(arch, "train_4k", device="cuda", top=0, quiet=True, **kw)
    with comm.fake_world(1):
        preal = count_cell(arch, "train_4k", device="cuda", **kw)
    ratio = prec["memory"]["peak_estimate_bytes"] / preal["peak_bytes"]
    pflops_ok = prec["walk"]["flops_per_device"] == preal["flops"]
    pbound = prec["roofline"]["bound_step_time_s"]
    print(f"phase 13 (c) {arch} ({layers} layer, {batch} x {seq}, one process): peak estimate "
          f"{prec['memory']['peak_estimate_bytes'] / 2**30:.4f} GiB over the real step's "
          f"{preal['peak_bytes'] / 2**30:.4f} GiB = {ratio:.4f} (gate {TOL_PEAK}); walked FLOPs "
          f"{prec['walk']['flops_per_device']:.6e} equal FlopCounterMode's {preal['flops']:.6e}: {pflops_ok}; step "
          f"{preal['step_s'] * 1e3:.2f} ms over the bound {pbound * 1e3:.4f} ms ({prec['roofline']['dominant']}): "
          f"{preal['step_s'] / pbound:.1f} x, a roofline share of {pbound / preal['step_s']:.4f}")
    require(coll_ok and flops_ok and pflops_ok, "phase 13 (c) the dry-run's counts differ from the real steps'")
    require(TOL_PEAK[0] <= ratio <= TOL_PEAK[1], f"phase 13 (c) peak ratio {ratio}")
    out["check"] = dict(collectives_equal=coll_ok, flops_equal=flops_ok, step_over_bound=real["step_s"] / bound,
                        peak_ratio=ratio, peak_flops_equal=pflops_ok, peak_step_ms=preal["step_s"] * 1e3,
                        peak_bound_ms=pbound * 1e3)
    main_s = time.perf_counter() - t0
    print(f"phase 13 took {max(r['s'] for r in mixers) + main_s:.1f} s: (a) {max(r['s'] for r in mixers):.1f} s in "
          f"the ranks (phase 12's world, started {t_world:.1f} s before its first case), (b) {b_s:.1f} s, the rest "
          f"{main_s - b_s:.1f} s")
    return out


def _host_us(torch, calls) -> dict:
    """Host time (us) a call of each ``(label, fn, args)``, issued ``HOST_CALLS``
    times back to back behind a spin kernel (so the queue does not drain),
    the labels in turn and then in reverse, the two means averaged."""
    out = {label: [] for label, _, _ in calls}
    for order in (calls, calls[::-1]):
        for label, fn, make in order:
            args = [make() for _ in range(HOST_CALLS)]
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for a in args:
                fn(*a)
            out[label].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    return {k: sum(v) / len(v) for k, v in out.items()}


def phase_operators(torch, gen, inputs, shampoo_ranks, phase6a_ms: float, full=None):
    """Phase 14: kernels A-E as ``repro_torch`` operators and the dry-run's
    Shampoo option (``full``: (c)'s record, as ``Background`` made it;
    without, run here)."""
    from repro_torch.core.backtransform import sweep_major_log
    from repro_torch.core.band_reduction import band_reduce
    from repro_torch.kernels import cuda_lib, library
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.kernels.panel import panel_qr_cuda
    from repro_torch.kernels.syr2k import trailing_update_cuda
    from repro_torch.launch.dryrun import count_cell, run_cell, summary
    from repro_torch.parallel import comm

    t0 = time.perf_counter()
    out = {}
    # (a) opcheck of every operator on the card, on phase 2's inputs.
    ops, i = torch.ops.repro_torch, inputs
    b, w = i["b"], i["w"]
    cases = {"fused_panel_update": (i["A"].clone(), b, w), "bulge_wavefront": (i["band"], b),
             "bulge_chase": (i["band"], b), "backtransform_wy": (i["X"], i["vs"], i["taus"], b, False),
             "syr2k": (i["Z"], i["Y"], i["C"], -1.0), "trailing_update": (i["C"], i["Y"], i["Z"]),
             "panel_qr": (i["P"],)}
    require(set(cases) == set(library.OPERATORS), "phase 14 (a) opcheck covers every operator")
    out["opcheck"] = {}
    for name, args in cases.items():
        res = torch.library.opcheck(getattr(ops, name), args)
        out["opcheck"][name] = res
        print(f"phase 14 (a) opcheck repro_torch::{name} on phase 2's inputs "
              f"{[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}: {res}")
        require(set(res.values()) == {"SUCCESS"}, f"phase 14 (a) opcheck {name}: {res}")

    # (b) the smoke Shampoo cell, fake world against the four ranks' real one.
    out["smoke"] = {}
    for sharded in SMOKE_SHARDED:
        rec = run_cell("llama3.2-3b", "train_4k", device="cuda", top=0, quiet=True, shampoo_sharded=sharded,
                       **SHAMPOO_SMOKE)
        real = shampoo_ranks[0][sharded]
        sites = {d["site"] for d in rec["walk"]["data_dependent"]}
        ok_coll = rec["collectives"] == real["collectives"]
        ok_flops = rec["walk"]["flops_outside_loops"] == real["flops_outside_loops"] > 0
        ok_flops = ok_flops and real["walk_flops"] == real["flops"]
        ok_bytes = rec["walk"]["hbm_bytes_outside_loops"] == real["hbm_bytes_outside_loops"] > 0
        ok_ops = {k: v["flops"] for k, v in rec["walk"]["operators"].items()} == real["operators"]
        ok_loops = sites == {d["site"] for d in real["data_dependent"]} == {"core/jacobi.py:jacobi_eigh",
                                                                          "core/tridiag_eig.py:_qr"}
        lanes = rec["shampoo"]["rank0_lanes_per_side"]
        want = {"fused_panel_update": 2 * lanes * 4, "bulge_wavefront": 2 * lanes, "backtransform_wy": 2 * lanes}
        ok_launch = all(r[sharded]["launches"] == want for r in shampoo_ranks)
        print(f"phase 14 (b) smoke Shampoo cell (llama3.2-3b smoke, 1 layer, (2, 2), sharded={sharded}): "
              f"collectives equal the real world's {ok_coll} ({rec['collectives']['total_bytes']} bytes); FLOPs "
              f"outside the data-dependent loops {rec['walk']['flops_outside_loops']:.6e} equal {ok_flops} (the real "
              f"step's walk and FlopCounterMode {real['walk_flops']:.6e} / {real['flops']:.6e}); HBM bytes outside "
              f"the loops {rec['walk']['hbm_bytes_outside_loops']:.6e} equal {ok_bytes} (real "
              f"{real['hbm_bytes_outside_loops']:.6e}; in the loops fake / real "
              f"{rec['walk']['hbm_bytes_per_device'] - rec['walk']['hbm_bytes_outside_loops']:.6e} / "
              f"{real['hbm_bytes'] - real['hbm_bytes_outside_loops']:.6e}); "
              f"operator FLOPs equal {ok_ops} ({real['operators']}); loops {sorted(sites)} equal {ok_loops} "
              f"(real trips {[(d['site'], d['trips']) for d in real['data_dependent']]}, fake "
              f"{[(d['site'], d['trips']) for d in rec['walk']['data_dependent']]}); every rank's launches "
              f"{[r[sharded]['launches'] for r in shampoo_ranks]} = {want}: {ok_launch}; trace {rec['trace_s']} s, "
              f"rank 0's counted step {real['s']:.1f} s")
        require(ok_coll and ok_flops and ok_bytes and ok_ops and ok_loops and ok_launch,
                f"phase 14 (b) sharded={sharded}")
        out["smoke"][str(sharded)] = dict(collectives=rec["collectives"]["total_bytes"],
                                          flops_outside_loops=rec["walk"]["flops_outside_loops"],
                                          hbm_bytes_outside_loops=rec["walk"]["hbm_bytes_outside_loops"],
                                          operators=real["operators"], trace_s=rec["trace_s"])

    # (c) the full-width dry-run: llama3.2-3b train_4k, 1-pod mesh, sharded refresh.
    rec = full or run_cell(*SHAMPOO_FULL[:2], device="cuda", top=0, quiet=True, optimizer_name="shampoo",
                           shampoo_sharded=True)
    require(rec["status"] == "ok", "phase 14 (c)")
    sh, rf = rec["shampoo"], rec["roofline"]
    print(f"phase 14 (c) {summary(rec)}")
    print(f"phase 14 (c) shampoo: {sh['blocks_per_side']} blocks a side, rank 0 refreshes {sh['rank0_lanes_per_side']} "
          f"a side; state bytes {sh['state_bytes']} ({sum(sh['state_bytes'].values()) / 1e9:.2f} GB); refresh FLOPs by "
          f"operator {sh['refresh_flops_by_operator']} (calls {sh['refresh_calls_by_operator']}); peak estimate "
          f"{rec['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB; collectives {rec['collectives']['total_bytes']} "
          f"bytes by kind { {k: v['bytes'] for k, v in rec['collectives']['per_kind'].items()} }; roofline terms "
          f"compute {rf['compute_s']:.4f} s memory {rf['memory_s']:.4f} s collective {rf['collective_s']:.4f} s; "
          f"data-dependent loops {rec['walk']['data_dependent']}; trace {rec['trace_s']} s")
    out["full"] = {k: rec[k] for k in ("mesh", "trace_s", "memory", "roofline", "shampoo", "collectives")}

    # (d) a real one-layer llama3.2-3b Shampoo step against its dry-run.
    arch, layers, batch, seq = PEAK_CELL
    kw = dict(mesh_override=(1, 1), overrides=dict(n_layers=layers), shape_overrides=dict(batch=batch, seq=seq),
              optimizer_name="shampoo")
    prec = run_cell(arch, "train_4k", device="cuda", top=0, quiet=True, **kw)
    cuda_lib.reset_launch_counts()
    t_real = time.perf_counter()
    with comm.fake_world(1):
        preal = count_cell(arch, "train_4k", device="cuda", timed=False, **kw)
    t_real = time.perf_counter() - t_real
    launches = nonzero(cuda_lib.launch_counts())
    lanes = prec["shampoo"]["rank0_lanes_per_side"]
    ratio = prec["memory"]["peak_estimate_bytes"] / preal["peak_bytes"]
    ok_flops = prec["walk"]["flops_outside_loops"] == preal["flops_outside_loops"] == preal["flops"] - sum(
        d["flops"] for d in preal["data_dependent"]) and preal["walk_flops"] == preal["flops"]
    ok_bytes = prec["walk"]["hbm_bytes_outside_loops"] == preal["hbm_bytes_outside_loops"] > 0
    ok_ops = {k: v["flops"] for k, v in prec["walk"]["operators"].items()} == preal["operators"]
    want = {"fused_panel_update": 2 * lanes * 4, "bulge_wavefront": 2 * lanes, "backtransform_wy": 2 * lanes}
    print(f"phase 14 (d) {arch} ({layers} layer, {batch} x {seq}, one process) Shampoo step: {lanes} blocks of 256 a "
          f"side; peak estimate {prec['memory']['peak_estimate_bytes'] / 2**30:.4f} GiB over the real step's "
          f"{preal['peak_bytes'] / 2**30:.4f} GiB = {ratio:.4f} (gate {TOL_PEAK}); FLOPs outside the loops "
          f"{prec['walk']['flops_outside_loops']:.6e} equal {ok_flops}; HBM bytes outside the loops "
          f"{prec['walk']['hbm_bytes_outside_loops']:.6e} equal {ok_bytes} (in the loops fake / real "
          f"{prec['walk']['hbm_bytes_per_device'] - prec['walk']['hbm_bytes_outside_loops']:.6e} / "
          f"{preal['hbm_bytes'] - preal['hbm_bytes_outside_loops']:.6e}); operator FLOPs equal {ok_ops} "
          f"({preal['operators']}); loops real {[(d['site'], d['trips'], d['flops']) for d in preal['data_dependent']]} "
          f"fake {[(d['site'], d['trips'], d['flops']) for d in prec['walk']['data_dependent']]}; launches {launches} "
          f"(want {want}); counted step {t_real:.1f} s (FlopCounterMode on); trace {prec['trace_s']} s")
    require(ok_flops and ok_bytes and ok_ops and launches == want,
            "phase 14 (d) the dry-run's counts differ from the real step's")
    require(TOL_PEAK[0] <= ratio <= TOL_PEAK[1], f"phase 14 (d) peak ratio {ratio}")
    out["real"] = dict(peak_ratio=ratio, peak_bytes=preal["peak_bytes"],
                       hbm_bytes_outside_loops=preal["hbm_bytes_outside_loops"],
                       peak_estimate_bytes=prec["memory"]["peak_estimate_bytes"], launches=launches,
                       counted_s=t_real, operators=preal["operators"])

    # (e) host cost a call: each operator against its bare launcher.
    host = {}
    for n in HOST_SHAPES:
        A = torch.randn((n, n), generator=gen, device="cuda")
        A = A + A.T
        band = band_reduce(A, 8, 64)
        T, log = bulge_wavefront_cuda(band, 8, return_log=True)
        vs, taus = sweep_major_log(log)
        X = torch.randn((n, n), generator=gen, device="cuda")
        C, Y, Z = A[64:, 64:], X[64:, :64].contiguous(), X[64:, 64:128].contiguous()
        P = X[8:, :8].contiguous()
        pairs = {
            "fused_panel_update": ((fused_panel_update_cuda, lambda: (A.clone(), 8, 64)),
                                   (library.fused_panel_update, lambda: (A.clone(), 8, 64))),
            "bulge_wavefront": ((lambda B: bulge_wavefront_cuda(B, 8, return_log=True), lambda: (band,)),
                                (lambda B: library.bulge_wavefront(B, 8, return_log=True), lambda: (band,))),
            "backtransform_wy": ((lambda X: backtransform_wy_cuda(X, vs, taus, b=8), lambda: (X,)),
                                 (lambda X: library.backtransform_wy(X, vs, taus, b=8), lambda: (X,))),
            "trailing_update": ((trailing_update_cuda, lambda: (C, Y, Z)), (library.trailing_update, lambda: (C, Y, Z))),
            "panel_qr": ((panel_qr_cuda, lambda: (P,)), (library.panel_qr, lambda: (P,))),
        }
        calls = []
        for name, ((f_bare, make), (f_op, _)) in pairs.items():
            calls += [(name + " launcher", f_bare, make), (name + " operator", f_op, make)]
        us = _host_us(torch, calls)
        host[n] = {name: dict(launcher_us=us[name + " launcher"], operator_us=us[name + " operator"]) for name in pairs}
        print(f"phase 14 (e) host us a call at n = {n} (launcher / operator / added): " + "; ".join(
            f"{k} {v['launcher_us']:.1f} / {v['operator_us']:.1f} / {v['operator_us'] - v['launcher_us']:+.1f}"
            for k, v in host[n].items()))
    out["host_us"] = host
    print(f"phase 14 (f) phase 6a's refresh (1536 blocks of 128 through the operators) in this run: "
          f"{phase6a_ms:.1f} ms")
    out["phase6a_ms"] = phase6a_ms
    out["s"] = time.perf_counter() - t0
    print(f"phase 14 took {out['s']:.1f} s in the main process (its real smoke cells ran in phase 13's ranks)")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"TF32 off for matmul and cuDNN")
    t0 = time.perf_counter()
    paths = cuda_lib.build()
    for name in paths:
        cuda_lib.library(name)
    print(f"phase 1 built and loaded {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        log = (cuda_lib.build_dir() / f"{name}.ptxas.txt")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line:
                    print(f"phase 1 ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, kernel_inputs = phase_kernels(torch, gen)
    launches, device_launches = phase_main_path(torch, gen)
    phase_inverse_root(torch, gen)
    unfused, unfused_device = phase_unfused(torch, gen)
    launches.update(unfused)
    device_launches.update(unfused_device)
    t6 = time.perf_counter()
    batched, batched_device, shampoo = phase_shampoo(torch, gen)
    phase_buckets(torch, gen)
    t7 = time.perf_counter()
    phase_methods(torch, gen)
    t8 = time.perf_counter()
    trained, trained_device, training = phase_training(torch, gen)
    t9 = time.perf_counter()
    serving = phase_serving(torch, gen)
    t10 = time.perf_counter()
    family, family_device, families = phase_families(torch, gen)
    t11 = time.perf_counter()
    distributed = phase_distributed(torch, shampoo["ms"])
    t12 = time.perf_counter()
    dry_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    background = Background(background_jobs(dry_dir.name))
    sharded = phase_sharding(torch)
    mixers = sharded.pop("mixers")
    t13 = time.perf_counter()
    training["cli_s"] = background.check("train_llama")
    serving["cli_s"] = background.check("serve_mixtral")
    families["serve_cli_s"] = background.check("serve_mamba2")
    families["train_cli_s"] = background.check("train_recurrentgemma")
    dry = {cell: background.record(("dry", *cell, ""), dry_dir.name) for cell in DRY_CELLS}
    full = background.record(("dry", *SHAMPOO_FULL, "_shampoo_sharded"), dry_dir.name)
    dry_dir.cleanup()
    t_bg = time.perf_counter()
    dryrun = phase_dryrun(torch, mixers, sharded["start_s"], dry)
    t14 = time.perf_counter()
    operators = phase_operators(torch, gen, kernel_inputs, [m["shampoo"] for m in mixers], shampoo["ms"], full)
    t_end = time.perf_counter()
    bg_s = sum(r[-1] for r in background.results.values())
    p13_ranks = max(m["s"] for m in mixers)
    p14_ranks = max(max(r["s"] for r in m["shampoo"].values()) for m in mixers)
    print(f"phase 6 took {t7 - t6:.1f} s, phase 7 {t8 - t7:.1f} s, phase 8 {t9 - t8:.1f} s, phase 9 "
          f"{t10 - t9:.1f} s, phase 10 {t11 - t10:.1f} s, phase 11 {t12 - t11:.1f} s, phase 12 "
          f"{t13 - t12 - p13_ranks - p14_ranks:.1f} s, phase 13 {t14 - t_bg + p13_ranks:.1f} s, phase 14 "
          f"{t_end - t14 + p14_ranks:.1f} s, the jobs beside phase 12 {bg_s:.1f} s (the main process waited "
          f"{t_bg - t13:.1f} s more for them); the script {t_end - t_start:.1f} s in all (kernel build included)")

    # Kernel D serves two registry ops (syr2k, trailing_update); its launches
    # are the sum of both counters over the unfused plan(A) run.
    operator_names = {"fused_panel_update": ["repro_torch::fused_panel_update"],
                      "bulge_wavefront": ["repro_torch::bulge_wavefront", "repro_torch::bulge_chase"],
                      "backtransform_wy": ["repro_torch::backtransform_wy"],
                      "syr2k": ["repro_torch::syr2k", "repro_torch::trailing_update"],
                      "panel_qr": ["repro_torch::panel_qr"]}
    meta = {
        "fused_panel_update": ("src/repro_torch/csrc/fused_panel.cu", "src/repro/kernels/fused_panel.py:136"),
        "bulge_wavefront": ("src/repro_torch/csrc/bulge.cu", "src/repro/kernels/bulge.py:128"),
        "backtransform_wy": ("src/repro_torch/csrc/backtransform.cu", "src/repro/kernels/backtransform.py:67"),
        "syr2k": ("src/repro_torch/csrc/syr2k.cu", "src/repro/kernels/syr2k.py:74"),
        "panel_qr": ("src/repro_torch/csrc/panel.cu", "src/repro/kernels/panel.py:107"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "operators": operator_names[name],
               "launches": launches[name], "device_launches": device_launches[name]}
        if name in batched:
            row.update(shampoo_bucket_launches=batched[name],
                       shampoo_bucket_device_launches=batched_device[name])
        if name in trained:
            row.update(training_launches=trained[name], training_device_launches=trained_device[name])
        if name in family:
            row.update(families_training_launches=family[name],
                       families_training_device_launches=family_device[name])
        for sub in ("a", "b"):
            if name in distributed["launches_per_rank"][sub]:
                row[f"distributed_{sub}_launches_per_rank"] = distributed["launches_per_rank"][sub][name]
        row["sharding_launches_per_rank"] = [r.get(name, 0) for r in sharded["cases"]["d"]["launches_per_rank"]]
        row.update(rows[name])
        kernels.append(row)
    print(json.dumps({"kernels": kernels, "shampoo_refresh": shampoo, "shampoo_training": training,
                      "serving": serving, "families": families, "distributed": distributed,
                      "sharding": sharded, "dryrun": dryrun, "operators": operators}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
