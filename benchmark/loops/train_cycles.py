"""Training cycles fed from a pool of device-resident batches.

Set-up makes the benchmark's weights and a pool of ``pool_cycles`` distinct
cycles of int16 batches on the device (each iteration: OPT patches or
slices and the LOW and HIGH ones with their centerline masks, as the
program's loaders hand them over), builds the program's ``Trainer`` from
the configuration's preset (``experiments/builder.build``), loads the
weights, and trains the first ``reference_cycles`` cycles of the pool
through ``Trainer.train_step_cycle``: the first runs eagerly, the second
captures the cycle's CUDA graph, later ones replay it. Those cycles are
also what the reference follows. The window then calls
``train_step_cycle`` on the pool's cycles in turn, with at most
``in_flight`` cycles queued on the device, until ``--seconds`` have passed,
and ends at the device's synchronisation after the last cycle dispatched.

``train_samples_per_s``: the samples of the window's cycles (3D patches or
2D slices, every stream counted) over the window's seconds.
"""

import time

import torch

from benchmark import checks, counts, harness, inputs
from benchmark.measured import Measured
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

OPT, LOW, HIGH = 0, -1, 1


def make_pool(cfg: dict, mix: dict, gen: torch.Generator, device) -> list:
    """``pool_cycles`` cycles of ``cycle_length`` iteration dicts, as the
    program's loaders hand them to the trainer."""
    t = cfg["train"]
    shape = tuple(t["patch"]) + (1,) * (3 - len(t["patch"]))
    is_2d = len(t["patch"]) == 2
    pool = []
    for _ in range(mix["pool_cycles"]):
        cycle = []
        for _ in range(t["cycle_length"]):
            batch = {}
            for key, label in ((OPT, "opt"), (LOW, "low"), (HIGH, "high")):
                vol, mask = inputs.phantoms(gen, t["batch"][label], shape, mix["hu"][label], device)
                if is_2d:
                    vol, mask = vol[..., 0], mask[..., 0]
                batch[key] = {"data": vol} if key == OPT else {"data": vol, "seg": mask}
            cycle.append(batch)
        pool.append(cycle)
    return pool


def build_trainer(cfg: dict, seed: int, params: dict, device):
    """The program's trainer for the configuration, holding ``params``; the
    run refuses a preset that resolves otherwise than the configuration
    states."""
    from dataclasses import replace

    from contrast_gan_3d_tpu_torch.experiments import builder
    from contrast_gan_3d_tpu_torch.experiments import config as presets
    from contrast_gan_3d_tpu_torch.trainer.trainer import Trainer

    xcfg = replace(presets.load_config(cfg["preset"]), seed=seed, **cfg.get("preset_overrides", {}))
    built = builder.build(xcfg, device=device)
    harness.load_into(built.generator, params["generator"])
    harness.load_into(built.critic, params["critic"])
    trainer = Trainer(built.generator, built.critic, built.gen_tx, built.critic_tx, built.step_config,
                      built.trainer_config, seed=built.seed, logger_interface=built.logger_interface,
                      device=device)
    t = cfg["train"]
    stated = {"cycle_length": t["cycle_length"], "layout": t["layout"], "dtype": t["dtype"]}
    resolved = {"cycle_length": trainer.cfg.cycle_length, "layout": built.generator.layout,
                "dtype": str(built.step_config.dtype).replace("torch.", "")}
    if stated != resolved:
        raise ValueError(f"the preset {cfg['preset']!r} resolves to {resolved}, the configuration states {stated}")
    return trainer


def _snapshot(module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _moments(opt, module) -> dict:
    state = opt.optimizer.state
    return {k: state[p]["exp_avg"].detach().clone() for k, p in module.named_parameters()}


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> tuple:
    """(weights by network, pool of cycles), drawn from ``seed`` on
    ``device`` in this order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g_arch, c_arch = cfg["generator"], cfg["critic"]
    ndim = len(cfg["train"]["patch"])
    params = {
        "generator": ref_model.make_params(ref_model.generator_spec(
            g_arch["n_resnet_blocks"], g_arch["n_updownsample_blocks"], g_arch["init_channels_out"], ndim),
            gen, device),
        "critic": ref_model.make_params(ref_model.critic_spec(
            c_arch["init_channels_out"], c_arch["discriminator_depth"], ndim, c_arch.get("norm", "batch")),
            gen, device),
    }
    return params, make_pool(cfg, mix, gen, device)


def reference_batches(pool: list, n: int) -> list:
    """The first ``n`` cycles as the reference takes them: (OPT, LOW then
    HIGH, their masks) per iteration, joined as the trainer joins them."""
    return [[(it[OPT]["data"], torch.cat([it[LOW]["data"], it[HIGH]["data"]]),
              torch.cat([it[LOW]["seg"], it[HIGH]["seg"]])) for it in pool[k]] for k in range(n)]


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device: torch.device):
    t = cfg["train"]
    params, pool = make_inputs(cfg, mix, seed, device)
    trainer = build_trainer(cfg, seed, params, device)

    # the first cycles: eager, capture, replay; the reference follows them
    n_ref = mix["reference_cycles"]
    port = {"losses": [], "moments": []}
    for c in range(n_ref):
        metrics = trainer.train_step_cycle(pool[c], trainer.iteration)[0]
        port["losses"].append({k: float(v) for k, v in metrics.items()})
        port["moments"].append({"generator": _moments(trainer.state.gen_opt, trainer.state.generator),
                                "critic": _moments(trainer.state.critic_opt, trainer.state.critic)})
    port["generator"], port["critic"] = _snapshot(trainer.state.generator), _snapshot(trainer.state.critic)
    harness.sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    pool_bytes = sum(t.nbytes for cycle in pool for it in cycle for stream in it.values() for t in stream.values())

    # the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    queued, units, c = [], 0, n_ref
    prof, stretch_units, prof_s = None, 0, 0.0

    def one_cycle():
        nonlocal c
        with torch.profiler.record_function("bench.cycle"):
            trainer.train_step_cycle(pool[c % len(pool)], trainer.iteration)
        c += 1
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            queued.append(event)
            if len(queued) > mix["in_flight"]:
                with torch.profiler.record_function("bench.wait"):
                    queued.pop(0).synchronize()

    def stretch():
        for _ in range(mix["profile_cycles"]):
            one_cycle()
        return mix["profile_cycles"]

    t0 = time.perf_counter()
    # a traced window runs on until its stretch has been profiled
    while time.perf_counter() - t0 < seconds or (traced and prof is None):
        if traced and prof is None and time.perf_counter() - t0 >= seconds / 2:
            harness.sync(device)
            prof, stretch_units, prof_s = harness.profile_stretch(stretch, device)
            units += stretch_units
            continue
        one_cycle()
        units += 1
    harness.sync(device)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the replayed graphs' activations live in their private pool, which is
    # reserved and never allocated during a replay
    held = torch.cuda.max_memory_reserved(device) - pool_bytes if device.type == "cuda" else 0
    samples_per_cycle = t["cycle_length"] * sum(t["batch"].values())

    # the reference, from the same weights over the same first cycles
    del trainer
    first = reference_batches(pool, n_ref)
    del pool
    harness.free_device_memory()
    t_ref = time.perf_counter()
    with harness.full_f32():
        ref = ref_train.train(params["generator"], params["critic"], first, cfg)
    t_ref = time.perf_counter() - t_ref
    found = checks.train_checks(port, ref, params)
    limits = cfg["limits"]["train"]
    out = {k: (v[0], limits[k]) for k, v in found.items() if k in limits}
    failed = sum(not v <= lim for v, lim in out.values())
    pattern = ref_train.schedule(0, t["cycle_length"], t["critic_every"], t["generator_every"])
    measured = Measured("train", t["dtype"], units, window_s, held, counts.train_cycle(cfg, pattern),
                        stretch_units, prof_s, harness.reduce_profile(prof))
    return harness.Outcome(
        end_to_end={"train_samples_per_s": units * samples_per_cycle / window_s},
        measured=measured, checks=out, attempted=units, failed=failed,
        memory_peak_bytes=max(setup_peak, window_peak), window_start=t0,
        notes={"worst": {k: v[1] for k, v in found.items() if v[1]}, "losses": port["losses"],
               "reference_losses": ref["losses"], "reference_s": t_ref})
