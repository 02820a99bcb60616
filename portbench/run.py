#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on this machine's CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. It generates the cell's corpus and queries from
the seed, ingests them into ``grape_vector_db_tpu_torch`` and warms up (the
set-up), drives the cell's traffic for ``--seconds``, judges the answers
against the plain reference, and prints the result as the last line of
standard output: the end-to-end metrics with ``--trace 0``, the per-layer
metrics from spans and a device trace with ``--trace 1``. Without enough
CUDA cards it exits with code 2 and prints no result. ``--rehearse`` runs
the same path on the CPU at a small size and reports no metric.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_portbench_cache")
# kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run compiles (the port's nvcc builds already go to
# grape_vector_db_tpu_torch/_build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from portbench.harness import bench, runner

    cell = bench.load_cell(args.workload)
    if not args.rehearse:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
                  f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             rehearse=args.rehearse, t_start=T_START)
    found = runner.jax_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
