"""The JAX package's ``<step>.msgpack`` checkpoints read by the port without
JAX or ``msgpack`` (``utils/msgpack.py``, ``trainer/checkpoint.py``), on
the CPU. This test module may import ``msgpack`` and flax; the port may not.

- the decoder against the ``msgpack`` package on hypothesis-drawn trees
  (every msgpack type, float32 and float64, ext types of every size) and
  flax's ``msgpack_restore`` (ndarrays of each dtype, bf16 widened to f32
  exactly, chunked arrays, complex and numpy scalars): equal;
- a checkpoint written by JAX's ``save_checkpoint``: the tree equal to
  flax's reading, the generator's ``state_dict`` bit-equal to
  ``utils/weights.py`` on that tree;
- ``from_checkpoint`` and ``correct_scans`` on a JAX run directory: within
  0.1 HU of JAX's corrector (f32), for both ``tconv_placement``s;
- ``import_jax_checkpoint``, then one port step against one JAX step after
  JAX's own restore: the losses within 1e-3 relative (1e-5 absolute) and
  the parameters within 2 lr of the update, the fit test's tolerances.
"""

import dataclasses
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from contrast_gan_3d_tpu.eval.corrector import CCTAContrastCorrector as JaxCorrector
from contrast_gan_3d_tpu.experiments import builder as jax_builder
from contrast_gan_3d_tpu.experiments import config as jax_config
from contrast_gan_3d_tpu.models.generator import ResnetGenerator as JaxGenerator
from contrast_gan_3d_tpu.trainer import checkpoint as jax_ckpt
from contrast_gan_3d_tpu.trainer import steps as jax_steps
from contrast_gan_3d_tpu_torch import correct_scans, import_jax_checkpoint
from contrast_gan_3d_tpu_torch.eval.corrector import CCTAContrastCorrector
from contrast_gan_3d_tpu_torch.eval.utils import device_int16
from contrast_gan_3d_tpu_torch.experiments import builder, config
from contrast_gan_3d_tpu_torch.trainer import checkpoint as ckpt_lib
from contrast_gan_3d_tpu_torch.trainer.steps import build_train_steps, init_state
from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils import msgpack as port_msgpack
from contrast_gan_3d_tpu_torch.utils.weights import critic_state_dict_from_jax, generator_state_dict_from_jax
from tests.test_torch_port_models import TINY, _np_tree, randomize_norms

PATCH = (16, 16, 16)

# --- the decoder ----------------------------------------------------------------

_leaves = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300)
           | st.builds(msgpack.ExtType, st.integers(0, 127),
                       st.sampled_from([1, 2, 4, 8, 16, 3, 300, 70000]).map(lambda n: b"\x07" * n)))
_trees = st.recursive(_leaves, lambda kids: st.lists(kids, max_size=20) | st.dictionaries(st.text(max_size=10), kids,
                                                                                          max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(tree=_trees, single=st.booleans())
def test_decoder_matches_the_msgpack_package(tree, single):
    data = msgpack.packb(tree, use_single_float=single)
    assert _typed(port_msgpack.unpackb(data)) == _typed(msgpack.unpackb(data, raw=False, strict_map_key=False))


def _typed(obj):
    """``obj`` with each value's type beside it (1 and 1.0, and a float32
    and a float64, compare equal), ext values as (code, data)."""
    if isinstance(obj, (port_msgpack.ExtType, msgpack.ExtType)):
        return ("ext", obj.code, obj.data)
    if isinstance(obj, list):
        return [_typed(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _typed(v) for k, v in obj.items()}
    return (type(obj).__name__, obj)


def test_decoder_refuses_truncated_and_trailing_data():
    data = msgpack.packb({"a": [1, 2.5, b"xyz"]})
    with pytest.raises(ValueError, match="ends"):
        port_msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match="follow"):
        port_msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="0xc1"):
        port_msgpack.unpackb(b"\xc1")


_DTYPES = ["float32", "float64", "float16", "int8", "int16", "int32", "int64", "uint8", "uint32", "bool", "bfloat16"]


@settings(max_examples=60, deadline=None)
@given(dtype=st.sampled_from(_DTYPES), shape=st.lists(st.integers(0, 5), max_size=4), seed=st.integers(0, 2**16),
       chunk=st.sampled_from([None, 8, 64]))
def test_flax_restore_matches_flax(dtype, shape, seed, chunk):
    """ndarrays (ext 1), numpy scalars (ext 3), complex (ext 2), and arrays
    flax split into chunks (``MAX_CHUNK_SIZE`` lowered so small ones are)."""
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 100, shape)
    arr = jnp.asarray(values, jnp.bfloat16) if dtype == "bfloat16" else values.astype(dtype)
    tree = {"a": {"x": arr, "s": np.float32(rng.normal()), "i": np.int64(seed)}, "c": complex(seed, -1.5),
            "n": [1, "t", None]}
    limit = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = chunk or limit
    try:
        data = serialization.msgpack_serialize(tree)
    finally:
        serialization.MAX_CHUNK_SIZE = limit
    got, want = port_msgpack.msgpack_restore(data), serialization.msgpack_restore(data)
    expect = np.asarray(want["a"]["x"]).astype(np.float32) if dtype == "bfloat16" else want["a"]["x"]
    assert got["a"]["x"].dtype == expect.dtype and got["a"]["x"].shape == expect.shape
    np.testing.assert_array_equal(got["a"]["x"], expect)
    for k in ("s", "i"):
        assert type(got["a"][k]) is type(want["a"][k]) and got["a"][k] == want["a"][k]
    assert got["c"] == want["c"] and got["n"] == want["n"]


# --- JAX checkpoints --------------------------------------------------------------


def _jax_state(kw, seed, tx):
    """A JAX generator and critic state at tiny widths, with non-trivial
    BatchNorm parameters and statistics."""
    gen = JaxGenerator(**TINY, **kw)
    built = jax_builder.build(dataclasses.replace(jax_config.basic_3d(), critic_args={"init_channels_out": 4,
                                                                                      "discriminator_depth": 2}))
    st0 = jax_steps.init_state(gen, built.critic, tx, tx, jax.random.key(seed), PATCH)
    g = randomize_norms({"params": _np_tree(st0.gen_params), "batch_stats": _np_tree(st0.gen_stats)},
                        np.random.default_rng(seed))
    return gen, st0.replace(gen_params=jax.tree.map(jnp.asarray, g["params"]),
                            gen_stats=jax.tree.map(jnp.asarray, g["batch_stats"]))


def test_jax_checkpoint_reads_like_flax_and_weights(tmp_path):
    tx = jax_builder.build(jax_config.basic_3d()).gen_tx
    _, state = _jax_state({}, 1, tx)
    meta = {"generator": {"tconv_placement": "same", "norm": "batch"}}
    path = jax_ckpt.save_checkpoint(state.replace(step=jnp.asarray(7, jnp.int32)), tmp_path, meta=meta)
    want = serialization.msgpack_restore(path.read_bytes())
    got = ckpt_lib.load_jax_state(tmp_path)
    flat_w, flat_g = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (p, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w, err_msg=str(p))
    jgen = ckpt_lib.load_jax_generator(tmp_path)
    assert jgen["step"] == 7 and jgen["meta"] == meta
    ref = generator_state_dict_from_jax({"params": want["gen_params"], "batch_stats": want["gen_stats"]})
    loaded = ckpt_lib.load_generator(tmp_path)
    assert loaded["step"] == 7 and loaded["meta"] == meta and loaded["state_dict"].keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(loaded["state_dict"][k], v), k
    # ``iteration`` names the file; a file path is read as it is
    with pytest.raises(FileNotFoundError):
        ckpt_lib.load_generator(tmp_path, iteration=8)
    assert ckpt_lib.load_generator(tmp_path / "7.msgpack")["step"] == 7


@pytest.mark.parametrize("placement", ["same", "torch"])
def test_from_checkpoint_and_correct_scans_on_a_jax_run(tmp_path, placement):
    """The architecture from the tree, ``tconv_placement`` and ``norm`` from
    the sidecar; f32, JAX's default corrector against the port's."""
    tx = jax_builder.build(jax_config.basic_3d()).gen_tx
    _, state = _jax_state({"tconv_placement": placement}, 2, tx)
    run = tmp_path / "jax_run"
    jax_ckpt.save_checkpoint(state, run, step=4, meta={"generator": {"tconv_placement": placement, "norm": "batch"}})
    vol = np.random.default_rng(3).normal(300, 200, (40, 36, 32)).astype(np.int16)
    want = np.asarray(JaxCorrector.from_checkpoint(run, inference_patch_size=PATCH)(jnp.asarray(vol)))
    corrector = CCTAContrastCorrector.from_checkpoint(run, inference_patch_size=PATCH, device="cpu")
    assert corrector.generator.tconv_placement == placement
    got = corrector(vol).numpy()
    assert np.abs(got - want).max() <= 0.1
    scan = tmp_path / "scan.mhd"
    io_utils.write_mhd(vol, scan, spacing=(0.5, 0.5, 0.5), origin=(0.0, 0.0, 0.0))
    (written,) = correct_scans.main([str(run), str(tmp_path / "out"), str(scan), "--patch-size", "16", "16", "16",
                                     "--device", "cpu"])
    # the command writes the int16 rounding of the same correction
    np.testing.assert_array_equal(io_utils.read_image(written)[0], device_int16(torch.from_numpy(got)).numpy())


OVERRIDE = '''
from dataclasses import replace


def config(base):
    return replace(base, name="tiny", train_patch_size=(16, 16, 16), val_patch_size=(16, 16, 16),
                   train_batch_size={{0: 2, -1: 1, 1: 1}},
                   generator_args={{"n_resnet_blocks": 1, "n_updownsample_blocks": 1, "init_channels_out": 4}},
                   critic_args={{"init_channels_out": 4, "discriminator_depth": 2}}, compute_dtype="float32",
                   augment=False, optimizer="{kind}", lr=1e-3, milestones=(2,), lr_gamma=0.1, logger="none")
'''


def _batch(seed):
    rng = np.random.default_rng(seed)
    b = lambda n: rng.integers(-300, 700, (n, *PATCH)).astype(np.int16)
    return b(2), b(2), (rng.random((2, *PATCH)) < 0.05).astype(np.int16)


@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_import_jax_checkpoint_resumes_like_jax(tmp_path, kind):
    """Two JAX steps (the schedule's milestone falls on the third update),
    its checkpoint and a data sidecar; the import; then one step on each
    side from the restored states."""
    conf = tmp_path / "tiny.py"
    conf.write_text(OVERRIDE.format(kind=kind))
    jcfg, cfg = jax_config.load_config(str(conf)), config.load_config(str(conf))
    jb = jax_builder.build(jcfg)
    steps = jax_steps.build_train_steps(jb.generator, jb.critic, jb.gen_tx, jb.critic_tx, jb.step_config)
    state = jax_steps.init_state(jb.generator, jb.critic, jb.gen_tx, jb.critic_tx, jax.random.key(0), PATCH)
    for i in range(2):
        state, _ = steps.combined_step(state, *map(jnp.asarray, _batch(i)))
    jdir = tmp_path / "jax_run"
    jax_ckpt.save_checkpoint(state, jdir, meta={"generator": {"tconv_placement": "same", "norm": "batch"}})
    sidecar = {"format": 2, "process_count": 1, "process_index": 0, "loaders": {0: {"rng": {"state": 1}}}}
    (jdir / "2.data.pkl").write_bytes(pickle.dumps(sidecar))
    template = jax_steps.init_state(jb.generator, jb.critic, jb.gen_tx, jb.critic_tx, jax.random.key(0), PATCH)
    jstate, jmetrics = steps.combined_step(jax_ckpt.load_checkpoint(jdir, target=template),
                                           *map(jnp.asarray, _batch(2)))

    pdir = tmp_path / "port_run"
    out = import_jax_checkpoint.main([str(jdir), str(pdir), "--conf", str(conf), "--device", "cpu"])
    assert out == pdir / "2.pt" and (pdir / "2.data.pkl").read_bytes() == (jdir / "2.data.pkl").read_bytes()
    assert json.loads((pdir / "2.meta.json").read_text()) == {"generator": {"tconv_placement": "same",
                                                                             "norm": "batch"}}
    built = builder.build(cfg, device="cpu")
    trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                      TrainerConfig(checkpoint_dir=str(pdir)), seed=built.seed, device="cpu")
    pstate = trainer.state
    assert pstate.step == 2 and int(pstate.gen_opt.scheduler.count) == 2
    # no random generator state in the file: the resume seeds it from the
    # config, so a file imported on one device resumes on another
    assert "rng" not in torch.load(out, weights_only=True)
    b2 = builder.build(cfg, device="cpu")
    fresh = init_state(b2.generator, b2.critic, b2.gen_tx, b2.critic_tx, seed=built.seed, device="cpu")
    assert torch.equal(pstate.rng.get_state(), fresh.rng.get_state())
    assert pstate.gen_opt.scheduler.lr_at(2) == pytest.approx(1e-4)
    pstate, pmetrics = build_train_steps(built.step_config).combined_step(pstate, *_batch(2))
    assert pstate.step == int(jstate.step) == 3
    assert set(jmetrics) == set(pmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=1e-3, atol=1e-5, err_msg=k)
    for module, params, stats, carry in (
            (pstate.generator, jstate.gen_params, jstate.gen_stats, generator_state_dict_from_jax),
            (pstate.critic, jstate.critic_params, jstate.critic_stats, critic_state_dict_from_jax)):
        want = carry({"params": _np_tree(params), "batch_stats": _np_tree(stats)})
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            limit = 1e-4 if k.endswith(("running_mean", "running_var")) else 2 * cfg.lr
            assert np.abs(got[k].numpy() - v.numpy()).max() <= limit, k
    with pytest.raises(ValueError, match="tconv_placement"):
        (jdir / "2.meta.json").write_text(json.dumps({"generator": {"tconv_placement": "torch"}}))
        import_jax_checkpoint.main([str(jdir), str(tmp_path / "other"), "--conf", str(conf), "--device", "cpu"])
