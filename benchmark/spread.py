"""Runs of one cell in sets, and the spread of each metric, for setting the
bounds of ``BENCHMARK.json``.

    python3 benchmark/spread.py --workload <cell> --seeds 1 2 3 4 5 6 --sets 2 \
        [--trace-seeds 7 8 9] --out <file.jsonl>

Each run is ``benchmark/run.py`` in a process of its own, with
``run_seconds`` from ``BENCHMARK.json``; every set runs the same seeds in
the same order. A run's result line goes to ``--out`` with its set, seed
and exit code. Per set and metric: the median and the spread, the distance
between the first and the third quartile (``statistics.quantiles(values,
n=4)``) as a share of the median. The bound for a metric is about five
times the widest spread over the sets and cells, and never under 1%.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def one_run(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", workload, "--seed",
                           str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"rc": proc.returncode, "result": result, "wall_s": time.perf_counter() - t,
            "stderr_tail": proc.stderr[-1500:] if result is None else proc.stderr[-300:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=int, default=None, help="default: run_seconds of BENCHMARK.json")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    values = {}
    with open(args.out, "a") as out:
        plan = [(s, seed, 0) for s in range(args.sets) for seed in args.seeds]
        plan += [("trace", seed, 1) for seed in args.trace_seeds]
        for which, seed, trace in plan:
            rec = {"workload": args.workload, "set": which, "seed": seed, "trace": trace, "seconds": seconds,
                   **one_run(args.workload, seed, seconds, trace)}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            r = rec["result"]
            brief = {k: v["value"] for k, v in r["metrics"].items()} if r else rec["stderr_tail"]
            print(json.dumps({"set": which, "seed": seed, "rc": rec["rc"], "correct": r and r["correct"],
                              "wall_s": round(rec["wall_s"], 1), "metrics": brief,
                              "checks": r and {k: v["value"] for k, v in r["checks"].items()}}), flush=True)
            if r and trace == 0:
                for k, v in r["metrics"].items():
                    values.setdefault(k, {}).setdefault(which, []).append(v["value"])
    for metric, sets in values.items():
        for which, vals in sets.items():
            if len(vals) >= 2:
                print(f"{metric} set {which}: n {len(vals)} median {statistics.median(vals)!r} "
                      f"spread {spread(vals)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
