"""The comparisons that decide ``correct``.

Training (the first cycles of the timed path, eager, captured and
replayed, against the plain reference from the same weights and batches):
- ``loss_gap``: the well-conditioned losses (``G-full``, ``sim``, ``HU``;
  not ``D`` and ``G``, means of critic logits of both signs that nearly
  cancel) of every compared cycle: the largest relative gap. The last
  cycle is a replay of the captured graph on batches copied into it, as
  every window cycle is.
- ``grad_gap``: per parameter leaf, the gap between the norms of the
  optimizer's first moment after the first cycle (the gradients as Adam
  got them: the generator's single update, the critic's moment over its
  updates), over the reference's norm of that leaf or of its network's
  median leaf, whichever is larger; the worst leaf.
- ``grad_diff_median``: the norm of the difference of those first moments,
  on the same scale; the median leaf.
- ``change_gap``: as ``grad_gap``, of each leaf's change over the compared
  cycles.
Leaves whose reference first moment after the first cycle is under a
thousandth of their network's median leaf are left out of all of these:
their gradient is nought up to rounding, and Adam moves them by round-off
alone.

Correction: ``hu_gap``, the largest absolute difference in HU between a
corrected volume and the reference's, over the checked volumes.
"""

from typing import Dict, List, Sequence, Tuple

import torch

NEGLIGIBLE = 1e-3
WELL_CONDITIONED = ("G-full", "sim", "HU")
NETWORKS = ("generator", "critic")


def loss_gap(port: Sequence[Dict[str, float]], ref: Sequence[Dict[str, float]]) -> Tuple[float, str]:
    """The well-conditioned losses of the cycles: the largest relative gap,
    and which loss of which cycle it is."""
    gaps = {f"{k}@{c}": abs(p[k] - r[k]) / abs(r[k])
            for c, (p, r) in enumerate(zip(port, ref)) for k in WELL_CONDITIONED if r[k]}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _median(values) -> float:
    return float(torch.tensor(sorted(values)).median())


def counted_leaves(ref_moments: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves a network's gaps count (see the module docstring)."""
    norms = _norms(ref_moments)
    median = _median(norms.values())
    return [k for k, n in norms.items() if n >= NEGLIGIBLE * median]


def leaf_gaps(port: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves: Sequence[str],
              difference: bool = False) -> Dict[str, float]:
    """Per leaf of ``leaves``: | |port| - |ref| | (``difference``: |port -
    ref|) / max(|ref|, median |ref|)."""
    rn = _norms({k: ref[k] for k in leaves})
    if difference:
        gap = _norms({k: port[k].float() - ref[k].float() for k in leaves})
    else:
        pn = _norms({k: port[k] for k in leaves})
        gap = {k: abs(pn[k] - rn[k]) for k in leaves}
    median = _median(rn.values())
    return {k: gap[k] / max(rn[k], median) for k in leaves}


def train_checks(port: dict, ref: dict, initial: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, tuple]:
    """{name: (value, where)} of the compared training numbers. ``port`` and
    ``ref`` hold ``losses`` and ``moments`` (first moments per network) per
    cycle and the weights after the compared cycles per network;
    ``initial`` the weights both started from."""
    out = {"loss_gap": loss_gap(port["losses"], ref["losses"])}
    found = {"grad_gap": {}, "grad_diff": {}, "change_gap": {}}
    for net in NETWORKS:
        leaves = counted_leaves(ref["moments"][0][net])
        first_p, first_r = port["moments"][0][net], ref["moments"][0][net]
        delta_p = {k: port[net][k].float() - initial[net][k].float() for k in leaves}
        delta_r = {k: ref[net][k].float() - initial[net][k].float() for k in leaves}
        for name, p, r, difference in (("grad_gap", first_p, first_r, False), ("grad_diff", first_p, first_r, True),
                                       ("change_gap", delta_p, delta_r, False)):
            found[name].update({f"{net}.{k}": v for k, v in leaf_gaps(p, r, leaves, difference).items()})
    for name in ("grad_gap", "change_gap"):
        worst = max(found[name], key=found[name].get)
        out[name] = (found[name][worst], worst)
    out["grad_diff_median"] = (_median(found["grad_diff"].values()), "")
    return out


def hu_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    return float((port.float() - ref.float()).abs().max())
