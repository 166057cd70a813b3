"""The port's spans and the corrector's counters, on the CPU at tiny sizes:
``utils/spans.span`` is a shared null context without a profiler; under a
CPU ``torch.profiler`` an eager ``Trainer.train_step_cycle`` and a 2D and a
3D correction emit their named spans, nested as the layers nest; the
corrector's ``counts`` count padded and useful samples."""

from functools import partial

import numpy as np
import pytest
import torch

from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.models.discriminator import PatchGANDiscriminator
from contrast_gan_3d_tpu_torch.models.generator import ResnetGenerator
from contrast_gan_3d_tpu_torch.ops.sliding_window import num_patches
from contrast_gan_3d_tpu_torch.trainer.optim import make_optimizer
from contrast_gan_3d_tpu_torch.trainer.steps import StepConfig
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from contrast_gan_3d_tpu_torch.utils.spans import span

GEN = dict(n_resnet_blocks=1, n_updownsample_blocks=1, init_channels_out=4)
STAGES = ("gen.first", "gen.down_0", "gen.resnet_0", "gen.up_0", "gen.last_conv")


def test_span_is_the_shared_null_context_without_a_profiler():
    assert span("train.cycle") is span("correct.batch")
    with span("train.cycle") as entered:
        assert entered is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("train.cycle"), torch.profiler.record_function)


def _spans(run):
    """(name, start_ns, end_ns) of the program's spans while ``run()``
    runs under a CPU profiler (torch's own ranges, such as the optimizers',
    left out)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().split(".")[0] in ("train", "correct", "gen")]


def _parent(spans, child):
    """The innermost span that holds ``child``."""
    holders = [s for s in spans if s is not child and s[1] <= child[1] and child[2] <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


def _tiny_cycle():
    torch.manual_seed(0)
    tx = partial(make_optimizer, "adam", lr=1e-3)
    trainer = Trainer(ResnetGenerator(**GEN, ndim=2), PatchGANDiscriminator(init_channels_out=4, discriminator_depth=2,
                                                                           ndim=2),
                      tx, tx, StepConfig(), TrainerConfig(train_generator_every=2, cycle_length=2), device="cpu")
    rng = np.random.default_rng(0)
    draw = lambda n: rng.integers(-1000, 1500, (n, 16, 16)).astype(np.int16)
    batches = [{0: {"data": draw(2)}, -1: {"data": draw(1), "seg": draw(1) > 0},
                1: {"data": draw(1), "seg": draw(1) > 0}} for _ in range(2)]
    return lambda: trainer.train_step_cycle(batches, 0, pattern=("combined", "critic"))


def _tiny_correction(ndim):
    torch.manual_seed(0)
    patch = (16,) * ndim
    corrector = CCTAContrastCorrector(ResnetGenerator(**GEN, ndim=ndim), inference_patch_size=patch,
                                      batch_size=8 if ndim == 2 else 2, device="cpu")
    volume = torch.randint(-1000, 1500, (16, 16, 20) if ndim == 2 else (24, 20, 16), dtype=torch.int16)
    return corrector, lambda: corrector(volume)


@pytest.mark.parametrize("case", ["train", "correct_2d", "correct_3d"])
def test_entry_points_emit_nested_spans(case):
    run = _tiny_cycle() if case == "train" else _tiny_correction(int(case[-2]))[1]
    spans = _spans(run)
    parents = {}
    for s in spans:
        parents.setdefault(s[0], set()).add(_parent(spans, s))
    if case == "train":
        want = {"train.cycle": {None}, "train.assemble": {"train.cycle"}, "train.stack": {"train.cycle"},
                "train.eager": {"train.cycle"}, **{g: {"train.eager"} for g in STAGES}}
    else:
        want = {"correct.volume": {None}, "correct.h2d": {"correct.volume"}, "correct.prepare": {"correct.volume"},
                "correct.batch": {"correct.volume"}, "correct.accumulate": {"correct.batch"},
                "correct.blend": {"correct.volume"}, **{g: {"correct.batch"} for g in STAGES}}
        if case == "correct_3d":
            want["correct.gather"] = {"correct.batch"}
    assert parents == want
    # every forward runs every stage once; a correction, one per batch
    forwards = {sum(s[0] == g for s in spans) for g in STAGES}
    assert len(forwards) == 1 and min(forwards) > 1
    if case != "train":
        assert forwards == {sum(s[0] == "correct.batch" for s in spans)}


def test_corrector_counts_padded_and_useful_samples():
    corrector, run = _tiny_correction(2)
    run()
    # D = 20 at batch 8: three batches, the last with 4 zero slices
    assert corrector.counts == {"volumes": 1, "batches": 3, "samples": 24, "useful": 20}
    corrector, run = _tiny_correction(3)
    run()
    run()
    n = num_patches((24, 20, 16), (16, 16, 16), 0.5, packed_io=corrector.packed)
    assert n == 4
    assert corrector.counts == {"volumes": 2, "batches": 4, "samples": 2 * n, "useful": 2 * n}
    # sharded over three CPU shares: 4 patches in batches of 2 pad to 6
    corrector.shard_over(["cpu"] * 3)
    corrector.counts.update(dict.fromkeys(corrector.counts, 0))
    run()
    assert corrector.counts == {"volumes": 1, "batches": 3, "samples": 6, "useful": 4}
