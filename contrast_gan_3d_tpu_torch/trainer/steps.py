"""The WGAN train and validation steps (counterpart of
``contrast_gan_3d_tpu/trainer/steps.py``), eager PyTorch.

One iteration, as in the JAX package:
- batches arrive as raw int16 ``(B, X, Y, Z)`` patches, or ``(B, X, Y)``
  slices for the 2D family; the step casts them to f32, applies the
  scaler, casts to ``StepConfig.dtype`` (the networks' compute dtype; the
  mask stays f32) and adds the channel dim at dim 1 (NCDHW / NCHW);
- the generator runs ONE forward per iteration, in train mode (its
  BatchNorm running statistics update once), and its graph is kept across
  the critic update (the JAX step's ``jax.vjp``);
- the critic updates first, on the detached output: Wasserstein loss on
  real then fake (its BatchNorm statistics update on real, then on fake,
  and nowhere else), plus the gradient penalty (``weight_clip=None``) or
  followed by weight clipping;
- the generator's loss (adversarial + ZNCC + HU corridor) is then taken
  against the UPDATED critic, in train mode with the critic's statistics
  frozen, and its gradients are taken over the generator's parameters only
  (``torch.autograd.grad``), so no gradient reaches the critic's ``.grad``.

With ``StepConfig.augment`` (an ``AugmentConfig``, or an
``Augment2DConfig`` for 2D slices) the int16 batches are augmented on the device in f32 before the scaler and the
cast, as ``_prepare_batches`` does in the JAX package: the sub-optimal
batch and its mask share one coordinate field per sample (trilinear scan,
nearest mask), the OPT batch is augmented as data only. The draws come
from ``state.rng`` in this fixed order at the start of each step: the
sub-optimal batch's, then the OPT batch's, then (gradient penalty) the
penalty's ``eps``. A generator with dropout (``resnet_dropout_prob``)
draws its masks from ``state.rng`` too, in its forward, after the
augmentation draws; a generator without dropout draws nothing, so its
streams are those of the steps before dropout was ported. The fused steps
run one generator forward per iteration, so the critic's fake batch and
the generator's gradient share one mask; the split phases run a second
forward, which draws a new mask, as the JAX phases redraw theirs. The
masks cannot equal JAX's bits (threefry is not Philox). ``build_preview_step`` re-derives a step's augmented
sub-optimal batch from the generator state saved before it.

The steps update the state in place and return ``(state, metrics)``, with
metrics as detached 0-d tensors. ``build_cycle_step`` runs several
iterations as one ``CycleStep``: a replayed CUDA graph on the card, the
loop over the steps on the CPU (the JAX package's fused schedule cycles). ``StepConfig.dtype`` bf16 with networks
built with ``dtype=torch.bfloat16`` is the JAX package's default training
(parameters, optimizer state and BatchNorm statistics stay f32).

Data parallelism (``state.mesh``, a ``parallel/mesh.DataMesh``; the JAX
steps under a ``mesh``; one device is ``parallel/mesh.LOCAL``, whose
collectives are identities): each rank passes its share of the global batch
(``Trainer._assemble`` slices it). The augmentation draws and the penalty's
``eps`` are drawn for the global batch on every rank, in lockstep, and each
rank keeps its slice; BatchNorm's statistics and every loss reduce over the
global batch (``models/norm.py``, ``models/losses.py``); after each backward
the parameters' gradients are all-reduced as one flattened buffer and
divided by the world size (``DataMesh.reduce_gradients``: the
differentiable reductions already give each rank its share of the
gradient of the sum of the ranks' equal losses). Weight clipping runs on
every rank, and the metrics are the global values. The state's networks
must start equal on every rank (``init_state`` broadcasts rank 0's).

Spatial partitioning (a mesh with ``space`` S > 1, JAX's dp x sp mesh;
3D on either generator layout, 2D slices on the direct one): each rank
still passes its data index's share of whole patches or slices; the step
augments them whole (the 2D rotation and mirroring too), scales them, and
keeps its X-slab (``parallel/spatial.split_slab``: the first dim of each
patch or slice), so the draws are those of the one-rank step. The networks exchange conv halos between the slabs, and
the norms and losses reduce with global counts; the val steps return the
corrected batch and the attenuation whole again (``gather_slab``).
"""

import gc
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from contrast_gan_3d_tpu_torch.data import augment as aug
from contrast_gan_3d_tpu_torch.data.scaler import FactorZeroCenterScaler, Scaler
from contrast_gan_3d_tpu_torch.models import losses
from contrast_gan_3d_tpu_torch.models.blocks import set_dropout_generator
from contrast_gan_3d_tpu_torch.models.norm import frozen_batch_stats, set_mesh
from contrast_gan_3d_tpu_torch.ops.block_conv import ROADMAP_NOTE, add_launch_counts, launch_counts
from contrast_gan_3d_tpu_torch.parallel.mesh import LOCAL
from contrast_gan_3d_tpu_torch.parallel.spatial import gather_slab, split_slab
from contrast_gan_3d_tpu_torch.trainer.optim import ScheduledOptimizer, clip_params
from contrast_gan_3d_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class StepConfig:
    """Training-step configuration."""

    weight_clip: Optional[float] = 0.01  # None -> WGAN-GP
    gp_weight: float = 10.0
    gan_loss_weight: float = 1.0
    sim_loss_weight: float = 1.0
    hu_loss_weight: float = 1.0
    hu_bounds: Tuple[float, float] = (350.0, 450.0)  # unscaled HU corridor
    scaler: Scaler = field(default_factory=FactorZeroCenterScaler)
    # on-device spatial augmentation (``experiments/builder.py`` sets it for
    # augment_backend="device"); None: the batches arrive as they train
    # (host-augmented or not augmented). The JAX StepConfig defaults to
    # AugmentConfig(); this one keeps the bare step its default.
    augment: Optional[aug.AugmentConfig] = None
    # fixed GP interpolation eps for every sample (deterministic penalty for
    # parity tests); None draws it per sample from the state's generator
    gp_eps: Optional[float] = None
    # the scaled batches' dtype: the networks' compute dtype (bf16 is the
    # JAX package's training default; its StepConfig default is f32)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.augment is not None and type(self.augment) not in (aug.AugmentConfig, aug.Augment2DConfig):
            raise NotImplementedError(
                f"augmentation {type(self.augment).__name__} (the port's AugmentConfig and Augment2DConfig are "
                f"ported) is {ROADMAP_NOTE}"
            )

    @property
    def hu_bounds_scaled(self) -> Tuple[float, float]:
        return losses.scale_bounds(self.scaler, self.hu_bounds)


@dataclass
class GANTrainState:
    """Both networks (their parameters and BatchNorm statistics), both
    optimizers with their schedules, the random generator, the iteration
    counter, and the data-parallel mesh the steps run over (``LOCAL``: one
    device)."""

    step: int
    generator: nn.Module
    critic: nn.Module
    gen_opt: ScheduledOptimizer
    critic_opt: ScheduledOptimizer
    rng: torch.Generator
    mesh: object = LOCAL

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def init_state(
    generator: nn.Module,
    critic: nn.Module,
    gen_tx: Callable[..., ScheduledOptimizer],
    critic_tx: Callable[..., ScheduledOptimizer],
    seed: int = 0,
    device="cuda",
    mesh=None,
) -> GANTrainState:
    """Move both networks to ``device`` in train mode and build their
    optimizers (``gen_tx(params)``, e.g. ``partial(make_optimizer, "adam")``)
    and a ``torch.Generator`` on that device seeded with ``seed``. With a
    ``mesh`` (None: ``LOCAL``) their BatchNorms take global statistics and
    rank 0's weights are broadcast to every rank."""
    device = resolve_device(device)
    mesh = mesh or LOCAL
    generator.to(device).train()
    critic.to(device).train()
    for module in (generator, critic):
        set_mesh(module, mesh)
        mesh.broadcast_module(module)
    rng = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(generator, rng, mesh)
    return GANTrainState(
        step=0,
        generator=generator,
        critic=critic,
        gen_opt=gen_tx(generator.parameters()),
        critic_opt=critic_tx(critic.parameters()),
        rng=rng,
        mesh=mesh,
    )


def _scaled(cfg: StepConfig, batch, device, dtype=torch.float32) -> torch.Tensor:
    """int16 (B, *spatial) -> scaled (B, 1, *spatial) on ``device``: the
    scaler in f32, then ``dtype``."""
    return cfg.scaler(torch.as_tensor(batch).to(device, torch.float32)).to(dtype).unsqueeze(1)


def _prepare_batches(cfg: StepConfig, opt, subopt, subopt_mask, device, draws=None, mesh=LOCAL):
    """int16 -> f32, the augmentation (``draws`` = (sub-optimal, OPT) draws
    when ``cfg.augment`` is set), the scaler, ``cfg.dtype``, the channel dim
    (the mask is neither scaled nor cast: it stays f32), then this rank's
    X-slab under spatial partitioning."""
    opt, subopt, mask = (torch.as_tensor(b).to(device, torch.float32) for b in (opt, subopt, subopt_mask))
    if cfg.augment is not None:
        d_sub, d_opt = draws
        subopt, mask = aug.augment_batch(subopt, mask, d_sub, cfg.augment)
        opt, _ = aug.augment_batch(opt, None, d_opt, cfg.augment)
    return tuple(split_slab(t, mesh) for t in (_scaled(cfg, opt, device, cfg.dtype),
                                               _scaled(cfg, subopt, device, cfg.dtype), mask.unsqueeze(1)))


class TrainSteps(NamedTuple):
    critic_step: Callable          # generator forward + critic update
    combined_step: Callable        # critic update, then generator update
    generator_only_step: Callable  # generator update only
    critic_phase: Callable         # combined_step split in two: the critic
    generator_phase: Callable      # phase hands its prepared batch over


def _draw_augment(cfg: StepConfig, draw, rng: torch.Generator, n_subopt: int, n_opt: int, mesh=LOCAL):
    """The step's augmentation draws, sub-optimal batch first (the order
    ``build_preview_step`` relies on), or None without augmentation: the
    draws of ``mesh``'s global batch, this rank's slice kept."""
    if cfg.augment is None:
        return None
    drawn = [(draw(rng, n * mesh.data_size, cfg.augment), n) for n in (n_subopt, n_opt)]
    return tuple(type(d)(*(t[mesh.global_slice(n)] for t in d)) for d, n in drawn)


def build_train_steps(cfg: StepConfig, draw: Callable = aug.draw) -> TrainSteps:
    """The three per-iteration steps, each ``(state, opt, subopt, mask) ->
    (state, metrics)`` on raw int16 batches, and ``combined_step`` split in
    two phases: ``critic_phase(state, opt, subopt, mask) -> (state,
    {"D"}, subopt_s, mask_s)``, then ``generator_phase(state, subopt_s,
    mask_s) -> (state, metrics)`` (the JAX package's memory fallback; the
    same math as ``combined_step``). ``draw(rng, batch, augment)`` makes a
    batch's augmentation draws (tests feed fixed ones)."""
    hu_lo, hu_hi = cfg.hu_bounds_scaled
    use_gp = cfg.weight_clip is None

    def critic_loss(state: GANTrainState, real, fake):
        real_logits = state.critic(real)
        fake_logits = state.critic(fake)
        loss = cfg.gan_loss_weight * losses.wasserstein_loss(fake_logits, real_logits, state.mesh,
                                                             state.critic.logit_rows(real))
        if use_gp:
            eps = None
            if cfg.gp_eps is not None:
                n = min(real.shape[0], fake.shape[0])
                eps = torch.full((n,) + (1,) * (real.dim() - 1), cfg.gp_eps, dtype=real.dtype, device=real.device)
            with frozen_batch_stats(state.critic):
                loss = loss + losses.gradient_penalty(
                    state.critic, real, fake, state.rng, cfg.gp_weight, eps=eps, mesh=state.mesh
                )
        return loss

    def update_critic(state: GANTrainState, real, fake):
        state.critic_opt.optimizer.zero_grad(set_to_none=True)
        loss = critic_loss(state, real, fake.detach())
        loss.backward()
        state.mesh.reduce_gradients([p.grad for p in state.critic.parameters() if p.grad is not None])
        state.critic_opt.step()
        if cfg.weight_clip is not None:
            clip_params(state.critic, cfg.weight_clip)
        return loss.detach()

    def update_generator(state: GANTrainState, opt_hat, subopt, mask):
        """The generator's loss head against the current critic, then one
        optimizer step from gradients over the generator's parameters."""
        with frozen_batch_stats(state.critic):
            fake_logits = state.critic(opt_hat)
        mesh = state.mesh
        loss_g = cfg.gan_loss_weight * -losses.wasserstein_loss(fake_logits, mesh=mesh,
                                                                rows=state.critic.logit_rows(opt_hat))
        loss_sim = cfg.sim_loss_weight * losses.zncc_loss(opt_hat, subopt, mesh)
        loss_hu = cfg.hu_loss_weight * losses.hu_loss(opt_hat, mask, hu_lo, hu_hi, mesh)
        full = loss_g + loss_sim + loss_hu
        params = list(state.generator.parameters())
        grads = torch.autograd.grad(full, params)
        mesh.reduce_gradients(grads)
        for p, g in zip(params, grads):
            p.grad = g
        state.gen_opt.step()
        return {"G": loss_g.detach(), "G-full": full.detach(), "sim": loss_sim.detach(), "HU": loss_hu.detach()}

    def begin(state: GANTrainState, opt_b, subopt_b, subopt_mask):
        state.step += 1
        draws = _draw_augment(cfg, draw, state.rng, len(subopt_b), len(opt_b), state.mesh)
        return _prepare_batches(cfg, opt_b, subopt_b, subopt_mask, state.device, draws, state.mesh)

    def critic_phase(state: GANTrainState, opt_b, subopt_b, subopt_mask):
        """The generator forward (its statistics update) and the critic
        update; returns the prepared sub-optimal batch and mask too."""
        opt_b, subopt_b, mask = begin(state, opt_b, subopt_b, subopt_mask)
        with torch.no_grad():
            opt_hat = subopt_b - state.generator(subopt_b)
        return state, {"D": update_critic(state, opt_b, opt_hat)}, subopt_b, mask

    def critic_step(state: GANTrainState, opt_b, subopt_b, subopt_mask):
        state, metrics, _, _ = critic_phase(state, opt_b, subopt_b, subopt_mask)
        return state, metrics

    def generator_phase(state: GANTrainState, subopt_s, mask_s):
        """The generator update on ``critic_phase``'s prepared batch: the
        forward again, in train mode with its statistics frozen (they
        updated in the critic phase), as the JAX phase reuses them."""
        with frozen_batch_stats(state.generator):
            opt_hat = subopt_s - state.generator(subopt_s)
        return state, update_generator(state, opt_hat, subopt_s, mask_s)

    def combined_step(state: GANTrainState, opt_b, subopt_b, subopt_mask):
        opt_b, subopt_b, mask = begin(state, opt_b, subopt_b, subopt_mask)
        opt_hat = subopt_b - state.generator(subopt_b)
        loss_d = update_critic(state, opt_b, opt_hat)
        return state, {"D": loss_d, **update_generator(state, opt_hat, subopt_b, mask)}

    def generator_only_step(state: GANTrainState, opt_b, subopt_b, subopt_mask):
        _, subopt_b, mask = begin(state, opt_b, subopt_b, subopt_mask)
        opt_hat = subopt_b - state.generator(subopt_b)
        return state, update_generator(state, opt_hat, subopt_b, mask)

    return TrainSteps(critic_step, combined_step, generator_only_step, critic_phase, generator_phase)


def build_preview_step(cfg: StepConfig):
    """``preview(state, rng_state, subopt, mask)``: the augmented sub-optimal
    batch a train step trained on, re-derived for image logging from
    ``rng_state``, the ``state.rng.get_state()`` saved before that step
    (the sub-optimal draws come first in a step; under a mesh, this rank's
    share of the global draws). Returns the scaled batch,
    the eval-mode reconstruction and attenuation, and the augmented mask,
    NCDHW or NCHW (the counterpart of the JAX ``build_preview_step``)."""
    if cfg.augment is None:
        raise ValueError("the preview re-derives on-device augmentation; StepConfig.augment is None")

    def preview(state: GANTrainState, rng_state: torch.Tensor, subopt, mask):
        rng = torch.Generator(device=state.device)
        rng.set_state(rng_state)
        subopt, mask = (torch.as_tensor(b).to(state.device, torch.float32) for b in (subopt, mask))
        draws = _draw_augment(cfg, aug.draw, rng, len(subopt), 0, state.mesh)[0]
        subopt, mask = aug.augment_batch(subopt, mask, draws, cfg.augment)
        x = _scaled(cfg, subopt, state.device, cfg.dtype)
        with torch.no_grad(), _eval_mode(state.generator):
            atten = gather_slab(state.generator(split_slab(x, state.mesh)), state.mesh, x.shape[2])
        return x, x - atten, atten, mask.unsqueeze(1)

    return preview


def schedule_branches(
    critic_every: Optional[int],
    generator_every: Optional[int],
    start: int,
    length: int,
) -> tuple:
    """Branch name per iteration for iterations ``[start, start+length)``:
    the critic is due iff ``i % critic_every == 0`` (iteration 0 included;
    ``None`` = never), likewise the generator."""
    def due(i, every):
        return every is not None and i % every == 0

    out = []
    for i in range(start, start + length):
        c, g = due(i, critic_every), due(i, generator_every)
        out.append("combined" if c and g else "critic" if c else "generator" if g else "none")
    return tuple(out)


def graphed(state: GANTrainState) -> bool:
    """Whether a cycle on ``state`` runs as a replayed CUDA graph: on the
    card, on one device or a mesh whose collectives can be captured (NCCL);
    gloo's cannot, so a gloo mesh runs its cycles eagerly."""
    return state.device.type == "cuda" and state.mesh.capturable


class CycleStep:
    """``len(pattern)`` schedule iterations as one call (the counterpart of
    the JAX ``build_cycle_step``): ``cycle(state, opt_c, subopt_c, mask_c)
    -> (state, metrics)``, the batches stacked on a leading cycle axis
    ``(K, B, ...)``, branch k of ``pattern`` ("combined", "critic",
    "generator" or "none", which only advances ``state.step``) on batch k.
    Metrics: the last value of each key, except ``D``, the mean over the
    cycle's critic updates.

    On the CPU, and under a gloo mesh, the cycle is the loop over the
    per-iteration steps. On a CUDA state (under an NCCL mesh with its
    all-reduces captured) the cycle is one CUDA graph:
    - the first call runs the loop eagerly on a side stream: real training
      iterations, which also warm the allocator, cuDNN and the optimizers'
      state;
    - the second call captures the loop into a ``torch.cuda.CUDAGraph``
      (from the static copies of its batches, ``state.rng`` registered with
      the graph so each replay draws on from where the generator stands),
      then replays it once;
    - later calls copy the batches into the static buffers and replay.
    The graph holds the state's tensors: the state must stay the one it was
    captured with (the steps update it in place). ``pool`` and ``stream``
    are the memory pool and the side stream the captures share
    (``torch.cuda.graph_pool_handle()``, a ``torch.cuda.Stream``). A capture
    that fails raises; no call stands in for a replay with an eager loop.
    The metrics of a replay are the graph's static outputs, overwritten by
    the next replay: a caller that keeps them clones them. A pattern of
    "none" branches only has no device work and captures nothing.

    The block-conv wrappers' launch counts stay true: the capture's counts
    are taken back (nothing ran) and added at each replay. ``calls`` counts
    the eager, capture and replay calls; ``copy_s`` and ``replay_s`` are
    the host seconds of the last copy into the static buffers and of the
    last ``replay()`` call."""

    def __init__(self, steps: TrainSteps, pattern: tuple, pool=None, stream=None):
        self.steps = steps
        self.pattern = tuple(pattern)
        self.pool = pool
        self.stream = stream
        self.calls = {"eager": 0, "capture": 0, "replay": 0}
        self.copy_s: Optional[float] = None
        self.replay_s: Optional[float] = None
        self._graph = None
        self._state = None
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._metrics: dict = {}
        self._launches: dict = {}

    def run_eager(self, state: GANTrainState, opt_c, subopt_c, mask_c):
        """The cycle as the loop over the per-iteration steps."""
        fns = {"combined": self.steps.combined_step, "critic": self.steps.critic_step,
               "generator": self.steps.generator_only_step}
        metrics, d_losses = {}, []
        for k, branch in enumerate(self.pattern):
            if branch == "none":  # advance the step counter only (Trainer parity)
                state.step += 1
                continue
            state, mt = fns[branch](state, opt_c[k], subopt_c[k], mask_c[k])
            metrics.update(mt)
            if "D" in mt:
                d_losses.append(mt["D"])
        if d_losses:
            metrics["D"] = sum(d_losses) / len(d_losses)
        return state, metrics

    def __call__(self, state: GANTrainState, opt_c, subopt_c, mask_c):
        if len(opt_c) != len(self.pattern):
            raise ValueError(f"{len(opt_c)} stacked batches for a cycle of {len(self.pattern)}")
        if not graphed(state) or all(b == "none" for b in self.pattern):
            self.calls["eager"] += 1
            return self.run_eager(state, opt_c, subopt_c, mask_c)
        if self.calls["eager"] == 0:
            return self._warm_up(state, opt_c, subopt_c, mask_c)
        if self._graph is None:
            self._capture(state, opt_c, subopt_c, mask_c)
        else:
            self._copy_inputs(state, opt_c, subopt_c, mask_c)
        return self._replay(state)

    def _warm_up(self, state, opt_c, subopt_c, mask_c):
        side = torch.cuda.Stream(device=state.device)
        side.wait_stream(torch.cuda.current_stream(state.device))
        with torch.cuda.stream(side):
            state, metrics = self.run_eager(state, opt_c, subopt_c, mask_c)
        torch.cuda.current_stream(state.device).wait_stream(side)
        self.calls["eager"] += 1
        return state, metrics

    def _capture(self, state, opt_c, subopt_c, mask_c):
        self._state = state
        # static batches, outside the graph's pool
        self._inputs = tuple(torch.as_tensor(t, device=state.device).clone() for t in (opt_c, subopt_c, mask_c))
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=state.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(state.device):
            graph.register_generator_state(state.rng)
        step, before = state.step, launch_counts()
        # a graph or a pool that dies mid-capture frees device memory, which
        # invalidates the capture: collect the dead ones now, none during
        gc.collect()
        gc_enabled = gc.isenabled()
        gc.disable()
        # as torch.cuda.graph does, the device cache goes back to the card
        # for the graph's pool; unlike it, the pinned host cache stays, so
        # that the loaders' threads need not allocate pinned memory anew
        # while the capture runs
        torch.cuda.synchronize(state.device)
        torch.cuda.empty_cache()
        try:
            with torch.cuda.stream(self.stream):
                # thread_local: the loaders' threads may allocate and copy
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    _, metrics = self.run_eager(state, *self._inputs)
                finally:
                    graph.capture_end()
        finally:
            if gc_enabled:
                gc.enable()
        state.step = step  # the capture ran the Python side only
        self._launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        add_launch_counts({k: -n for k, n in self._launches.items()})
        self._graph, self._metrics = graph, metrics
        self.calls["capture"] += 1

    def _copy_inputs(self, state, opt_c, subopt_c, mask_c):
        if state is not self._state:
            raise ValueError("a captured cycle runs only on the state it was captured with")
        t = time.perf_counter()
        for dst, src in zip(self._inputs, (opt_c, subopt_c, mask_c)):
            src = torch.as_tensor(src)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"cycle batches {tuple(src.shape)} {src.dtype}: the graph was captured for "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src, non_blocking=True)
        self.copy_s = time.perf_counter() - t

    def _replay(self, state):
        t = time.perf_counter()
        self._graph.replay()
        self.replay_s = time.perf_counter() - t
        add_launch_counts(self._launches)
        state.step += len(self.pattern)
        self.calls["replay"] += 1
        return state, self._metrics


def build_cycle_step(steps: TrainSteps, pattern: tuple, pool=None, stream=None) -> CycleStep:
    """One :class:`CycleStep` for the branch ``pattern``."""
    return CycleStep(steps, pattern, pool, stream)


def _wcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) validity weights broadcast against x's shape."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1)).float()


def _masked_mean(x: torch.Tensor, w: torch.Tensor, mesh=LOCAL) -> torch.Tensor:
    """Mean over valid samples only (``x.mean()`` when w is all ones), over
    ``mesh``'s global batch."""
    per = x.numel() // x.shape[0]
    return mesh.all_sum((x.float() * _wcast(w, x)).sum()) / mesh.all_sum(w.sum() * per)


def _masked_zncc(source: torch.Tensor, target: torch.Tensor, w: torch.Tensor, mesh=LOCAL) -> torch.Tensor:
    """``zncc_loss`` restricted to valid samples (ddof=1 std, same
    epsilons), over ``mesh``'s global batch."""
    wf = _wcast(w, source)
    total = mesh.all_sum
    n = total(w.sum() * (source.numel() // source.shape[0]))
    ms = total((source * wf).sum()) / n
    mt = total((target * wf).sum()) / n
    cc = total(((source - ms) * (target - mt) * wf).sum()) / n
    std = torch.sqrt(total(((source - ms).square() * wf).sum()) / (n - 1)) * torch.sqrt(
        total(((target - mt).square() * wf).sum()) / (n - 1)
    )
    return -(cc / (std + 1e-8))


@contextmanager
def _eval_mode(*modules: nn.Module):
    was = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, t in zip(modules, was):
            m.train(t)


def build_val_steps(cfg: StepConfig):
    """Eval-mode steps ``(state, batch, w)``, w a (B,) 0/1 validity vector:
    ``val_opt_step`` scores the critic on real (OPT) data;
    ``val_subopt_step`` runs the generator on sub-optimal data and returns
    (realism, ZNCC similarity, corrected batch, attenuation), NCDHW / NCHW. As in
    the JAX val steps the scaled batch stays f32 whatever ``cfg.dtype``:
    the networks' first blocks cast it, and the corrected batch is f32.
    Under ``state.mesh`` each rank passes its share of a batch padded to the
    data ranks (``parallel/mesh.pad_batch_to_multiple``) and the masked
    reductions run over the global batch; under spatial partitioning each
    rank runs its X-slab of the whole patches it passes, and the corrected
    batch and the attenuation come back whole."""

    def val_opt_step(state: GANTrainState, batch, w):
        x = split_slab(_scaled(cfg, batch, state.device), state.mesh)
        w = torch.as_tensor(w).to(state.device, torch.float32)
        with torch.no_grad(), _eval_mode(state.critic):
            return _masked_mean(state.critic(x), w, state.mesh)

    def val_subopt_step(state: GANTrainState, batch, w):
        whole = _scaled(cfg, batch, state.device)
        x = split_slab(whole, state.mesh)
        w = torch.as_tensor(w).to(state.device, torch.float32)
        with torch.no_grad(), _eval_mode(state.generator, state.critic):
            atten = state.generator(x)
            sample_hat = x - atten
            loss_fake = _masked_mean(state.critic(sample_hat), w, state.mesh)
            zncc = _masked_zncc(sample_hat, x, w, state.mesh)
            rows = whole.shape[2]
            return loss_fake, zncc, gather_slab(sample_hat, state.mesh, rows), gather_slab(atten, state.mesh, rows)

    return val_opt_step, val_subopt_step
