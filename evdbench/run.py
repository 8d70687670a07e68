#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's CUDA card(s).

    python3 evdbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; the numbers the
check compared come last in it and as the last lines of standard error,
each beside its limit.  Exits non-zero with no result when the card is
missing, when a module of JAX or of the JAX package ``repro`` was loaded,
or when the run fails.  Every build and kernel cache, and Python's
bytecode, is kept under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# Python's bytecode, torch's too, is cached in the checkout: a machine may
# forbid writing it beside the sources (PYTHONDONTWRITEBYTECODE), and then
# every run compiles torch's modules anew, seconds of its set-up.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from evdbench import harness

    try:
        result, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except harness.NoCard as exc:
        print(f"evdbench: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"evdbench: modules of JAX or of the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    phases = ", ".join(f"{k} {v:.3f}" for k, v in result.get("setup_phases", {}).items())
    print(f"evdbench: {args.workload} seed {args.seed} on {result['card']}; set-up seconds from the "
          f"start: {phases}; readings {json.dumps(result['readings'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
