"""The benchmark's command:

    python3 mvsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Prints the checks as the last lines of standard error and
the result as the last line of standard output; exits non-zero, printing
no result, without the cards, without the port beside it, or if jax or
the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_CALL = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache at a fixed path inside the checkout, so only
# the first run of a checkout builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="mvsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int):
    print(f"mvsbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    from mvsbench import harness, spec
    args = parse(argv)
    t_start = T_CALL - harness.process_age()
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no result", 2)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{torch.cuda.device_count()} CUDA device(s), the cell asks "
             f"for {cell.chips}: no result", 2)
    try:
        import multiviewstitch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not beside the benchmark ({e}): no result", 3)
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"), t_start)
    try:
        line = harness.report(run, bench, bool(args.trace), cell.chips)
    finally:
        run.close()
    bad = harness.forbidden_modules()
    if bad:
        fail(f"loaded {', '.join(bad)} (the port must not): no result", 4)
    harness.emit(line)


if __name__ == "__main__":
    main()
