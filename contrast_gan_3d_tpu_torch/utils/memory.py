"""Device memory of the port's programs (counterpart of
``contrast_gan_3d_tpu/utils/memory.py``).

XLA knows a compiled program's memory before it runs; the port compiles
nothing, so its figures are measured on the card:
- :func:`program_memory_summary`: the peak allocated bytes of one warm call
  (``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``),
  beside the analytic bytes of its arguments and outputs;
- :func:`live_buffer_table`: the caching allocator's live blocks
  (``torch.cuda.memory_snapshot``) aggregated by size;
- :func:`record_memory_history` / :func:`dump_heap_profile`: the
  allocator's allocation history with stack traces
  (``torch.cuda.memory._record_memory_history`` / ``_dump_snapshot``), the
  pickle ``https://pytorch.org/memory_viz`` reads;
- :func:`write_memory_snapshot`: the table and the heap profile into a
  directory (the train CLI's ``--profiler-dir`` records the history over
  each traced window and writes both after it).

On the CPU there is no allocator to read: the peak is None ("not
measured"), the table is empty and no heap profile is written.
"""

import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of tensors, modules, optimizers,
    dicts, lists and tuples (each tensor counted once)."""
    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = (x.untyped_storage().data_ptr(), x.device) if x.numel() else id(x)
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, torch.optim.Optimizer):
            for state in x.state.values():
                visit(state)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return total


def program_memory_summary(fn: Callable, arguments, device) -> Dict[str, Optional[float]]:
    """Run ``fn()`` twice (the first warms the allocator, cuDNN and lazily
    built state) and measure the second: ``peak_bytes``, the most bytes
    allocated on the device during it (None on the CPU), ``baseline_bytes``
    allocated before it, ``argument_bytes`` of ``arguments`` (what the call
    reads: inputs, parameters, optimizer state), ``output_bytes`` of what it
    returns, and its ``seconds``. Keeps nothing alive."""
    device = torch.device(device)
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        baseline = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {
        "argument_bytes": tensor_bytes(arguments),
        "output_bytes": tensor_bytes(out),
        "baseline_bytes": baseline if cuda else None,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "seconds": seconds,
    }


def live_buffer_table(top: int = 30, device=None) -> Dict:
    """The allocator's live (allocated) blocks on the card, aggregated by
    block size: ``{"total_bytes", "n_buffers", "rows": [{"bytes", "count",
    "block"}]}``, the largest totals first, at most ``top`` rows (the rest
    folded into one). Empty without a card."""
    if not torch.cuda.is_available():
        return {"total_bytes": 0, "n_buffers": 0, "rows": []}
    index = None if device is None else torch.device(device).index
    agg: Dict[int, List[int]] = {}
    for seg in torch.cuda.memory_snapshot():
        if index is not None and seg.get("device") != index:
            continue
        for block in seg.get("blocks", ()):
            if block.get("state") == "active_allocated":
                ent = agg.setdefault(int(block["size"]), [0, 0])
                ent[0] += int(block["size"])
                ent[1] += 1
    rows = [{"block": size, "bytes": v[0], "count": v[1]}
            for size, v in sorted(agg.items(), key=lambda kv: -kv[1][0])]
    if len(rows) > top:
        rest = rows[top:]
        rows = rows[:top] + [{"block": f"...other ({len(rest)} sizes)", "bytes": sum(r["bytes"] for r in rest),
                              "count": sum(r["count"] for r in rest)}]
    return {"total_bytes": sum(r["bytes"] for r in rows), "n_buffers": sum(r["count"] for r in rows), "rows": rows}


def format_bytes(n: Optional[float]) -> str:
    if n is None:
        return "not measured"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} GiB"


def format_live_buffer_table(table: Dict) -> str:
    lines = [f"live device blocks: {table['n_buffers']}  total {format_bytes(table['total_bytes'])}",
             f"{'bytes':>12}  {'count':>5}  block"]
    lines += [f"{format_bytes(r['bytes']):>12}  {r['count']:>5}  {r['block']}" for r in table["rows"]]
    return "\n".join(lines)


def record_memory_history(enabled: bool = True, max_entries: int = 100_000) -> bool:
    """Start recording the allocator's history with stack traces, or stop
    it and drop what was recorded; False without a card."""
    if not torch.cuda.is_available():
        return False
    torch.cuda.memory._record_memory_history("all" if enabled else None, max_entries=max_entries)
    return True


def dump_heap_profile(path) -> bool:
    """Write the allocator's snapshot, with the history recorded since
    ``record_memory_history`` (its segments alone when none was), as the
    pickle ``https://pytorch.org/memory_viz`` reads, to ``path``; returns
    whether a file was written (not without a card)."""
    if not torch.cuda.is_available():
        return False
    torch.cuda.memory._dump_snapshot(str(path))
    return True


def write_memory_snapshot(directory, tag: str) -> Iterable[str]:
    """``memory_<tag>.txt`` (the live-block table) and, on the card,
    ``memory_<tag>.pickle`` (``dump_heap_profile``) in ``directory``.
    Returns the paths written."""
    os.makedirs(directory, exist_ok=True)
    txt = os.path.join(directory, f"memory_{tag}.txt")
    with open(txt, "w") as f:
        f.write(format_live_buffer_table(live_buffer_table()) + "\n")
    written = [txt]
    pickle_path = os.path.join(directory, f"memory_{tag}.pickle")
    if dump_heap_profile(pickle_path):
        written.append(pickle_path)
    return written
