"""The readings the correctness limits are set from, on the card, at the
cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3 \
        [--fault-seeds 1 2 3 --faults half_batch stale_inputs] --seconds <s> --out <file.jsonl>

Per seed of ``--seeds``: a sound run of the cell (``run.run_cell`` with a
window of ``--seconds``), its compared numbers the lower readings. Per seed
of ``--control-seeds``: the control, the reference computed one precision
step below the configuration's (``CONTROL``: fp8 operands for bf16 work,
TF32 operands for float32 work) in the program's place, compared with the
float32 reference by the same numbers; its readings are the upper ones. Per
seed of ``--fault-seeds`` and fault of ``--faults`` (training cells): a run
with that fault of ``benchmark/faults.py`` planted. Training readings hold,
beside the compared numbers, candidates that decide nothing
(:func:`candidates`). One JSON line per reading. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def candidates(port: dict, ref: dict, cfg: dict) -> dict:
    """Training numbers read beside the compared ones, none of them
    compared: the well-conditioned losses' gap of the first and of the last
    compared cycle alone, and the last cycle's own gradients (a network's
    first moment after it less ``beta1`` to the power of its Adam steps in
    the cycle times its moment before it), by the median leaf's norm of the
    difference, over both networks and by network."""
    import torch

    from benchmark import checks
    from benchmark.reference import train as ref_train

    t = cfg["train"]
    n = len(ref["moments"])
    branches = ref_train.schedule((n - 1) * t["cycle_length"], t["cycle_length"], t["critic_every"],
                                  t["generator_every"])
    updates = {"generator": sum(b in ("combined", "generator") for b in branches),
               "critic": sum(b in ("combined", "critic") for b in branches)}
    out = {"first_loss_gap": checks.loss_gap(port["losses"][:1], ref["losses"][:1])[0],
           "last_loss_gap": checks.loss_gap(port["losses"][-1:], ref["losses"][-1:])[0]}
    every = []
    for net in checks.NETWORKS:
        leaves = checks.counted_leaves(ref["moments"][0][net])
        decay = t["betas"][0] ** updates[net]
        p, r = ({k: m[-1][net][k].float() - decay * m[-2][net][k].float() for k in leaves}
                for m in (port["moments"], ref["moments"]))
        diff = list(checks.leaf_gaps(p, r, leaves, difference=True).values())
        out[f"last_grad_diff_median.{net}"] = float(torch.tensor(sorted(diff)).median())
        every += diff
    out["last_grad_diff_median"] = float(torch.tensor(sorted(every)).median())
    return out


def train_readings(port: dict, ref: dict, initial: dict, cfg: dict, compare=None) -> dict:
    """The compared numbers by ``compare`` (``checks.train_checks``) and the
    candidates."""
    from benchmark import checks

    compare = compare or checks.train_checks
    return {**{k: v[0] for k, v in compare(port, ref, initial).items()}, **candidates(port, ref, cfg)}


def control_reading(workload: str, seed: int, device: str = "cuda", config: dict = None, mix: dict = None) -> dict:
    """The control's compared numbers for one seed: {name: value}."""
    import torch

    from benchmark import checks, harness
    from benchmark import spec as specs
    from benchmark.reference import train as ref_train

    spec = specs.load_spec()
    cell = specs.workload(spec, workload)
    config = config or specs.config(spec, cell["config"])
    mix = mix or specs.traffic(cell["traffic"])
    loop = specs.loop(mix)
    dev = torch.device(device)
    if mix["loop"] == "train_cycles":
        prec = CONTROL[config["train"]["dtype"]]
        params, pool = loop.make_inputs(config, mix, seed, dev)
        first = loop.reference_batches(pool, mix["reference_cycles"])
        del pool
        with harness.full_f32():
            ref = ref_train.train(params["generator"], params["critic"], first, config)
            ctl = ref_train.train(params["generator"], params["critic"], first, config, prec=prec)
        return train_readings(ctl, ref, params, config)
    prec = CONTROL[config["correct"]["dtype"]]
    params, stats, volumes = loop.make_inputs(config, mix, seed, dev)
    vol = torch.from_numpy(volumes[0]).to(dev)
    ref = loop.reference(config, params, stats, vol)
    ctl = loop.reference(config, params, stats, vol, prec=prec)
    return {"hu_gap": checks.hu_gap(ctl, ref)}


def reading_run(workload: str, seed: int, seconds: float, **kwargs):
    """``run.run_cell``, with every number it read: (result, outcome,
    readings), the compared numbers and, in a training cell, the
    candidates."""
    from unittest import mock

    from benchmark import checks, run
    from benchmark import spec as specs

    spec = specs.load_spec()
    cfg = kwargs.get("config") or specs.config(spec, specs.workload(spec, workload)["config"])
    seen = {}
    real = checks.train_checks

    def train_checks(port, ref, initial):
        seen["readings"] = train_readings(port, ref, initial, cfg, real)
        return real(port, ref, initial)

    with mock.patch.object(checks, "train_checks", train_checks):
        result, outcome = run.run_cell(workload, seed, seconds, False, **kwargs)
    return result, outcome, seen.get("readings") or {k: v["value"] for k, v in result["checks"].items()}


def main(argv=None) -> int:
    from benchmark import faults, run

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=["half_batch"])
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    run.cache_dirs(ROOT)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        def emit(kind, seed, readings, **extra):
            line = {"workload": args.workload, "kind": kind, "seed": seed, "readings": readings, **extra}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            out.flush()

        for seed in args.seeds:
            t = time.perf_counter()
            result, outcome, found = reading_run(args.workload, seed, args.seconds)
            emit("sound", seed, found, metrics=result["metrics"], notes=outcome.notes,
                 seconds=time.perf_counter() - t)
        for seed in args.control_seeds:
            t = time.perf_counter()
            emit("control", seed, control_reading(args.workload, seed), seconds=time.perf_counter() - t)
        for fault in args.faults:
            for seed in args.fault_seeds:
                t = time.perf_counter()
                with getattr(faults, fault)():
                    _, _, found = reading_run(args.workload, seed, args.seconds)
                emit(fault, seed, found, seconds=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
