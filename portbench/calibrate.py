#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--control-seeds 4,5,6] [--out FILE]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a short
window, and prints the numbers compared (the lower readings: sound runs of
the program). For each of ``--control-seeds`` it puts the reference,
computed in fp8 (the step below the configuration's bf16), in the program's
place on as many calls as a run checks, and prints the same numbers (the
upper readings), each beside its limit with the verdict the cell's runs
would give, which has to be ``correct: false``. The benchmark's own runs
never run the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(cell, seed: int, device: str, rehearse: bool = False) -> dict:
    """The control's numbers for ``seed``: the first ``max_checked`` distinct
    batches of the mix, answered by the reference in fp8 and judged."""
    import numpy as np

    from portbench.harness import data, runner

    ds, traffic = runner.sizes(cell, rehearse)
    batch, k = int(traffic["batch"]), int(traffic["k"])
    corpus = data.make_corpus(ds, seed, device)
    queries = data.make_queries(corpus, ds, traffic, seed)
    batches = [np.ascontiguousarray(queries[r]) for r in data.batch_rows(len(queries), batch)]
    ref = cell.reference()
    rows = ref.prepare(corpus.x, cell.config)
    del corpus
    n = min(int(traffic.get("max_checked", 32)), len(batches))
    out = {"score_gap": 0.0, "rank_gap": 0.0, "bad_hits": 0}
    for j in range(n):
        ids, scores = ref.control(rows, cell.config, batches[j], k)
        runner.fold(out, ref.judge(rows, cell.config, batches[j], k, ids,
                                   scores.astype(np.float32)))
    out["checked_calls"] = n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from portbench.harness import bench, runner

    cell = bench.load_cell(args.workload)
    device = "cpu" if args.rehearse else "cuda"
    lines = []

    def put(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)

    for s in [int(v) for v in args.seeds.split(",") if v]:
        t0 = time.perf_counter()
        res = runner.run_cell(cell, s, args.seconds, False, rehearse=args.rehearse,
                              t_start=t0)
        put({"workload": cell.name, "side": "program", "seed": s, "correct": res["correct"],
             "checks": {n: c["value"] for n, c in res["checks"].items()},
             "metrics": {n: m["value"] for n, m in res["metrics"].items()},
             "memory_peak_bytes": res["device"]["memory_peak_bytes"]})
    for s in [int(v) for v in args.control_seeds.split(",") if v]:
        numbers = control_numbers(cell, s, device, args.rehearse)
        checks, within = runner.judge_limits(numbers, cell.limits)
        put({"workload": cell.name, "side": "control", "seed": s, "correct": within,
             "checks": checks, "checked_calls": numbers["checked_calls"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
