"""Find what a cell is made of, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry names; the mix
is ``traffic/<mix>.json``, whose ``loop`` names the general loop in
``loops/<loop>.py`` that makes the mix's inputs and runs its window; a
per-layer metric ``<name>`` is read by ``metrics/<name>.py`` or, failing
that, by ``metrics/<name up to its first dot>.py`` (``mfu.train`` and
``mfu.correct`` share ``metrics/mfu.py``). Adding a cell, a configuration,
a mix or a metric therefore adds files and entries, and edits no code.
"""

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(spec["configs"], name, "configuration")
    with open(Path(root) / entry["file"]) as f:
        return json.load(f)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def loop(mix: dict, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The loop module of a traffic mix (``loops/<loop>.py``)."""
    return _module(Path(bench_dir) / "loops" / f"{mix['loop']}.py")


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    own = Path(bench_dir) / "metrics" / f"{metric}.py"
    if own.exists():
        return own
    shared = Path(bench_dir) / "metrics" / f"{metric.split('.')[0]}.py"
    if shared.exists():
        return shared
    raise FileNotFoundError(f"no reader for the metric {metric!r}: expected {own} or {shared}")


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(measured) -> value or None`` function of a per-layer
    metric."""
    return _module(reader_path(metric, bench_dir)).read


def end_to_end(spec: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports: those without a
    ``workloads`` key, and those whose key lists the cell."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those whose ``workloads``
    list it, or, without the key, those that move an end-to-end metric the
    cell reports."""
    reported = {m["name"] for m in end_to_end(spec, cell)}

    def applies(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in reported

    return [m for m in spec["per_layer"] if applies(m)]
