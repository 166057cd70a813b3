"""The comparisons fail where they must, on the CPU at small sizes and
under the cells' own limits:
- the control, the reference one precision step below the
  configuration's in the program's place (fp8 operands for the bf16
  training, TF32 operands for the float32 correction), comes out not
  correct;
- a run of the benchmark with the timed path broken underneath (the
  look for a card skipped, everything else as a run does it) comes out
  not correct, for each fault the cell can have (``benchmark/faults.py``);
  one chip holds no exchange between chips to leave out;
- training cycles that replay on stale batches (the copy into the captured
  graph left out) leave the reference's losses.
The sound runs these start from pass (``test_port_bench_reference.py``)."""

import pytest

from benchmark import calibrate, faults
from benchmark.tests import small


def _fails(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= limit for k, limit in limits.items())


@pytest.mark.parametrize("cell", ["train.basic_3d", "train.conf_2d", "correct.basic_3d.z400",
                                  "correct.conf_2d.z400"])
def test_control_is_not_correct(cell):
    cfg_name, mix_name = small.CELLS[cell]
    kind = "train" if cell.startswith("train") else "correct"
    cfg = small.config(cfg_name, "bfloat16" if kind == "train" else "float32")
    readings = calibrate.control_reading(cell, 2**31 + 17, "cpu", config=cfg, mix=small.mix(mix_name))
    assert _fails(readings, cfg["limits"][kind]), readings


FAULTS = [(cell, fault) for cell in ("train.basic_3d", "train.conf_2d") for fault in ("unchanged", "half_batch")]
FAULTS += [(cell, fault) for cell in ("correct.basic_3d.z400", "correct.conf_2d.z400")
           for fault in ("unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault):
    with getattr(faults, fault)():
        result, _ = small.run(cell, seed=2**31 + 23)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", ["train.basic_3d", "train.conf_2d"])
def test_stale_inputs_move_the_replayed_cycles_losses(cell):
    """Every cycle after the second trains on the second one's batches: the
    last compared cycle's losses leave the reference's. At these sizes, in
    float32, a sound run's ``loss_gap`` is rounding and the stale run's a
    hundredfold of it and more; on the card the cells' limits catch it on
    most seeds (PERF.md), so this holds the reading's sensitivity, not a
    verdict."""
    seed = 2**31 + 23
    sound, _ = small.run(cell, seed=seed)
    with faults.stale_inputs():
        stale, _ = small.run(cell, seed=seed)
    assert sound["checks"]["loss_gap"]["value"] < 1e-4
    assert stale["checks"]["loss_gap"]["value"] > 100 * max(sound["checks"]["loss_gap"]["value"], 1e-5)
