"""Ahead-of-time correction artifacts (counterpart of
``contrast_gan_3d_tpu/eval/export.py``, which lowers through ``jax.export``).

The whole correction of one volume shape (z bucketing, the patch grid's
gathers, HU scaling, every generator forward, the Gaussian blend, unscale)
is traced once with ``torch.export`` under ``torch.no_grad`` and saved with
``torch.export.save``, the generator's weights inside. A serving process
loads it with :func:`load_exported_corrector` and calls it without the
generator's class, a checkpoint or a new trace; it needs this package only
for the block-conv operators of a direct-layout artifact
(``ops/block_conv.py``), which it registers on import.

Artifacts are shape-specialised: the window's Python loop unrolls for the
exported shape (a 512x512x128 volume at overlap 0.25 is 25 patches, two
packed batches). :class:`ArtifactBundle` serves a directory of them as one
corrector, one artifact per z bucket. ``save_exported_corrector`` writes
``<path>.pt2corr`` and ``<path>.pt2corr.json`` with the I/O contract. An
artifact exported on one device loads onto another (an artifact exported
on the CPU runs on the card; ``torch.export.passes.move_to_device_pass``).
"""

import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from contrast_gan_3d_tpu_torch.ops import block_conv  # noqa: F401  (registers the block-conv operators)
from contrast_gan_3d_tpu_torch.utils.device import full_f32, resolve_device

ARTIFACT_SUFFIX = ".pt2corr"


class _Correction(nn.Module):
    """The corrector as a module whose parameters and buffers are its
    generator's, so that ``torch.export`` lifts the weights into the
    artifact."""

    def __init__(self, corrector):
        super().__init__()
        self.generator = corrector.generator
        self.correct = corrector.correct

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        return self.correct(volume)


def export_corrector(corrector, volume_shape: Sequence[int], in_dtype: torch.dtype = torch.int16):
    """Trace ``corrector.correct(volume)`` for one fixed ``volume_shape``
    (``(W, H, D)``, 3D or 2D family) on the corrector's device into a
    ``torch.export.ExportedProgram``."""
    example = torch.zeros(tuple(int(s) for s in volume_shape), dtype=in_dtype, device=corrector.device)
    with torch.no_grad():
        return torch.export.export(_Correction(corrector), (example,))


def _io_values(program):
    """The fake tensors of the program's volume input and its output."""
    inputs = [n for n in program.graph.nodes if n.op == "placeholder"
              and n.name in program.graph_signature.user_inputs]
    output = next(n for n in program.graph.nodes if n.op == "output")
    return inputs[0].meta["val"], output.args[0][0].meta["val"]


def save_exported_corrector(
    path,
    corrector,
    volume_shape: Sequence[int],
    in_dtype: torch.dtype = torch.int16,
    extra_meta: Optional[dict] = None,
) -> Path:
    """Export and save to ``path`` (``.pt2corr`` appended if it has another
    suffix) with a ``<path>.json`` sidecar describing the I/O contract:
    ``platforms`` holds the torch device type it was exported on, and
    ``calling_convention_version`` the torch version that wrote it."""
    program = export_corrector(corrector, volume_shape, in_dtype)
    path = Path(path)
    if path.suffix != ARTIFACT_SUFFIX:
        path = path.with_name(path.name + ARTIFACT_SUFFIX)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:  # a file object: torch.export names its own files .pt2
        torch.export.save(program, f)
    _, out = _io_values(program)
    meta = {
        "volume_shape": [int(s) for s in volume_shape],
        "in_dtype": _dtype_name(in_dtype),
        "out_shape": [int(s) for s in out.shape],
        "out_dtype": _dtype_name(out.dtype),
        "platforms": [corrector.device.type],
        "calling_convention_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta, indent=2) + "\n")
    return path


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ExportedCorrector:
    """A loaded correction artifact: checks a volume against the exported
    contract, then runs the traced program on ``device``, its f32
    convolutions in full f32 (``utils/device.full_f32``: the TF32 switches
    act when a program runs, not when it is traced)."""

    def __init__(self, program, meta: dict, device: torch.device):
        self._module = program.module()
        self.meta = meta
        self.device = device
        self.volume_shape: Tuple[int, ...] = tuple(meta["volume_shape"])
        self.in_dtype: torch.dtype = getattr(torch, meta["in_dtype"])
        self.platforms = tuple(meta["platforms"])

    def __call__(self, volume) -> torch.Tensor:
        volume = torch.as_tensor(volume)
        if tuple(volume.shape) != self.volume_shape:
            raise ValueError(
                f"artifact was exported for volume shape {self.volume_shape}, got {tuple(volume.shape)} — export "
                "one artifact per served (z-bucketed) shape")
        volume = volume.to(self.device)
        if volume.dtype != self.in_dtype:
            if volume.dtype.is_floating_point and not self.in_dtype.is_floating_point:
                # round half to even AND saturate: a cast alone truncates and
                # wraps an out-of-range value (40000.0 -> -25536 HU)
                info = torch.iinfo(self.in_dtype)
                volume = torch.round(volume).clamp_(info.min, info.max)
            volume = volume.to(self.in_dtype)
        with torch.no_grad(), full_f32():
            return self._module(volume)


class ArtifactBundle:
    """A directory of shape-specialised artifacts served as one corrector,
    the artifacts' counterpart of the live corrector's ``z_bucket``:
    ``__call__`` picks the artifact of the volume's (W, H) with the
    smallest exported depth >= its own, edge-pads z up to it (as
    ``CCTAContrastCorrector.correct`` pads), corrects, and crops back."""

    def __init__(self, artifacts: Sequence[ExportedCorrector]):
        if not artifacts:
            raise ValueError("empty artifact bundle")
        self.artifacts = sorted(artifacts, key=lambda a: a.volume_shape)
        self.device = self.artifacts[0].device

    @classmethod
    def from_dir(cls, path, device="cuda") -> "ArtifactBundle":
        files = sorted(Path(path).glob(f"*{ARTIFACT_SUFFIX}"))
        return cls([load_exported_corrector(f, device=device) for f in files])

    def pick(self, shape: Sequence[int]) -> ExportedCorrector:
        w, h, d = shape
        fits = [a for a in self.artifacts if a.volume_shape[:2] == (w, h) and a.volume_shape[2] >= d]
        if not fits:
            raise ValueError(
                f"no artifact serves shape {tuple(shape)}; bundle has {[a.volume_shape for a in self.artifacts]} "
                "— export one with python -m contrast_gan_3d_tpu_torch.export_corrector")
        return min(fits, key=lambda a: a.volume_shape[2])

    def __call__(self, volume) -> torch.Tensor:
        volume = torch.as_tensor(volume)
        if volume.dim() != 3:
            raise ValueError(f"bundle serves (W, H, D) volumes, got {tuple(volume.shape)}")
        art = self.pick(volume.shape)
        d = volume.shape[2]
        pad = art.volume_shape[2] - d
        if pad:
            volume = volume.to(art.device)
            volume = torch.cat([volume, volume[:, :, -1:].expand(-1, -1, pad)], dim=2)
        out = art(volume)
        return out[:, :, :d] if pad else out

    def warmup(self):
        """Run every artifact once on zeros (the first call of a loaded
        program pays its allocations)."""
        for art in self.artifacts:
            art(torch.zeros(art.volume_shape, dtype=art.in_dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_exported_corrector(path, device="cuda") -> ExportedCorrector:
    """Load ``save_exported_corrector`` output onto ``device`` (the card
    unless the caller names the CPU; raises without one). Needs no model
    code, weights or configuration; an artifact exported on another device
    is moved with ``move_to_device_pass``. Without a sidecar the contract
    is read from the program's input."""
    device = resolve_device(device)
    path = Path(path)
    if not path.exists() and path.suffix != ARTIFACT_SUFFIX:
        path = path.with_name(path.name + ARTIFACT_SUFFIX)
    with open(path, "rb") as f:
        program = torch.export.load(f)
    vin, vout = _io_values(program)
    meta_path = path.with_suffix(path.suffix + ".json")
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    else:
        meta = {"volume_shape": [int(s) for s in vin.shape], "in_dtype": _dtype_name(vin.dtype),
                "platforms": [vin.device.type]}
    if vin.device.type != device.type:
        program = move_to_device_pass(program, device)
    return ExportedCorrector(program, meta, device)

