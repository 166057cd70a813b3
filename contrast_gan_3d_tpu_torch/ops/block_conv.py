"""The block-space 3^3 conv (counterpart of
``contrast_gan_3d_tpu/ops/pallas_conv.py``).

- ``block_conv3x3x3`` (B1): VALID 3^3 conv, x (B, Z, X, Y, Ci) z-major
  channels-last, w (3, 3, 3, Ci, Co) indexed [qx, qy, qz], f32 out
  (B, Z-2, X-2, Y-2, Co). A CUDA tensor runs the hand-written Hopper kernel
  ``csrc/block_conv.cu`` on the tensor cores (3xTF32 for f32, native bf16);
  a CPU tensor runs the plain version ``block_conv3x3x3_reference``. There
  is no fallback between the two.
- ``block_conv3x3x3_v2`` (B2): the same contraction on x (B, Z, Y, X, Ci),
  out (B, Z-2, Y-2, X-2, Co), w still indexed [qx, qy, qz]; the same CUDA
  kernel body with the tap decode for that axis order, plain version
  ``block_conv3x3x3_v2_reference``. The TPU kernel's ``k_splits`` (channel
  chunks sized to fit VMEM) is not carried over: each CUDA block reduces
  the whole K = 27 * Ci itself.
- ``s2d_conv3d_block`` (B3): stride-1 SAME conv through space-to-depth and
  B1, with B3's dispatch: plain ``s2d_conv3d`` for block kernels other than
  3^3 or dims that do not divide f; ``ValueError`` on an unknown
  ``padding_mode``. B1 reads the (B, X, Y, Z) block grid as it is: the
  weights are permuted to that spatial order, not the data.

Every launch takes the weights K-major per tap, (27, Co, Ci) with tap =
qx*9 + qy*3 + qz (``kmajor``), as wgmma reads a tf32 operand; for f32 they
are split into TF32 big and small parts (``tf32_split``), the kernel's
3xTF32 products. Channels are zero-padded to 16 bytes (``pad_channels``)
where Ci is not a multiple of 4 (f32) or 8 (bf16).

B1 and B2 are differentiable through ``BlockConv3x3x3Function``: the
input gradient is a FULL 3^3 conv of dy with the flipped, transposed
weight, i.e. the same kernel on dy padded by 2, whose K-major weight is
the flipped weight as it lies (``dx_weight``); the weight gradient is 27
per-tap products in ``torch.matmul`` (the JAX package differentiates its
XLA conv there, never a Pallas kernel). In bf16 both take dy rounded to
bf16 and return bf16, as the VJP of XLA's bf16 conv does. On the CPU the
forward and backward run the plain versions.

The forward launch is the ``torch.library`` operator
``contrast_gan_3d_torch::block_conv3x3x3`` (``block_conv_op``: the plain
version as its CPU implementation, the counted launch as its CUDA one, a
fake for shapes), which ``BlockConv3x3x3Function`` calls and which B1 and
B2 call directly where no gradient is wanted; B3 without a gradient is the
operator ``contrast_gan_3d_torch::s2d_conv3d_block``. ``torch.export``
keeps operators whole, so an exported direct-layout correction
(``eval/export.py``) runs these kernels on the card; importing this module
registers them.

Each wrapper counts, in its ``launches`` attribute, the times it launched
the CUDA kernel (forward and backward); ``backward_launches`` counts the
backward's share. A captured CUDA graph keeps the counts true through
``launch_counts`` / ``add_launch_counts`` (``trainer/steps.py``
``build_cycle_step``). Launches take torch's current stream and scratch
from torch's allocator, so they capture into a graph.

Both operators have a flop formula (``torch.utils.flop_counter``), so
``FlopCounterMode`` counts the hand-written kernels: each counts the work
its operator executes, ``block_conv_flops`` for B1 (the dx launch too) and
B3's B1 launch on the f=4 block grid for B3 (``s2d_conv3d_block_flops``,
about 5x the model FLOPs of the 7^3 conv, ``s2d_conv3d_model_flops``).
While ``FLOP_LOG`` is a list, each counted launch (and each
``weight_grad``) also appends ``(name, executed, model)``: model is the
7^3 conv's count where the launch serves a B3 stage (``flops_accounting``
reports both totals).
"""

import ctypes
import math
import threading
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import flop_registry, register_flop_formula

from contrast_gan_3d_tpu_torch.ops import _build
from contrast_gan_3d_tpu_torch.ops.s2d_conv import (
    _axis_map,
    check_padding_mode,
    depth_to_space,
    pad_spatial,
    s2d_conv3d,
    space_to_depth,
    transform_kernel,
)

# keyed by x's spatial axes in memory order: B1 (Z, X, Y), B2 (Z, Y, X)
_C_SYMBOLS = {
    ("zxy", torch.float32): "block_conv3x3x3_f32",
    ("zxy", torch.bfloat16): "block_conv3x3x3_bf16",
    ("zyx", torch.float32): "block_conv3x3x3_v2_f32",
    ("zyx", torch.bfloat16): "block_conv3x3x3_v2_bf16",
}
ROADMAP_NOTE = "not ported yet; see ROADMAP.md"
# (name, executed FLOPs, model FLOPs) of each counted launch while a list
FLOP_LOG: Optional[list] = None
# the model FLOPs of the B3 stage whose B1 work runs now, per thread
_stage = threading.local()
OP_NAMESPACE = "contrast_gan_3d_torch"
TF32_DROP = 0x1FFF  # the 13 low mantissa bits that TF32 does not keep


@lru_cache(maxsize=None)
def _kernel_fn(layout: str, dtype: torch.dtype):
    fn = getattr(_build.load("block_conv"), _C_SYMBOLS[layout, dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> the (27, Co, Ci) view the kernel reads."""
    return w.reshape(27, w.shape[3], w.shape[4]).transpose(1, 2)


def from_kmajor(w_km: torch.Tensor) -> torch.Tensor:
    """(27, Co, Ci) -> (3, 3, 3, Ci, Co)."""
    return w_km.transpose(1, 2).reshape(3, 3, 3, w_km.shape[2], w_km.shape[1])


def dx_weight(w: torch.Tensor) -> torch.Tensor:
    """The K-major weight of B1's input gradient: dx is the VALID conv of
    dy padded by 2 with ``w.flip(0, 1, 2).transpose(3, 4)``, whose K-major
    form (27, Ci, Co) is the flipped weight without the transpose."""
    return w.flip(0, 1, 2).reshape(27, w.shape[3], w.shape[4])


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~TF32_DROP).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(big, small): ``big = tf32_round(v)``, ``small = tf32_round(v - big)``;
    ``|v - big - small| <= 2^-22 |v|``."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


def pad_channels(x: torch.Tensor, w_km: torch.Tensor):
    """Zero-pad x's and the K-major weight's Ci to a multiple of 16 bytes
    (4 f32, 8 bf16), the kernel's copy width; returns them unchanged where
    Ci already is one. Zero channels add nothing to the contraction."""
    pad = -x.shape[-1] % (16 // x.element_size())
    if not pad:
        return x, w_km
    return F.pad(x, (0, pad)), F.pad(w_km, (0, pad))


def block_conv_flops(x_shape, w_km_shape) -> int:
    """FLOPs of one B1 (or B2) launch: 2 B (Z-2)(X-2)(Y-2) 27 Ci Co, for x
    (B, Z, ., ., Ci) and the K-major weight (27, Co, Ci) (Ci before the
    kernel's channel padding, which adds only zeros)."""
    b, z, d2, d3 = x_shape[:4]
    return 2 * b * (z - 2) * (d2 - 2) * (d3 - 2) * 27 * w_km_shape[2] * w_km_shape[1]


def s2d_pads(dims, kernel, f: int):
    """B3's padding of the (X, Y, Z) ``dims`` for a ``kernel`` conv: the
    SAME pad per side, then the right pad that makes each padded length
    ceil(d/f) + 2 whole blocks, so the VALID block conv yields the whole
    output, rounded up to whole blocks (a halo-extended slab's d need not
    divide f; where d does, this is the JAX wrapper's pad)."""
    pads = [(k - 1) // 2 for k in kernel]
    extra = [(-(-d // f) + 2) * f - (d + 2 * p) for d, p in zip(dims, pads)]
    return pads, extra


def s2d_conv3d_block_flops(x_shape, w_shape, f: int = 4) -> int:
    """FLOPs B3 executes: its B1 launch on the f-block grid of x (B, X, Y,
    Z, Ci) padded for w (k, k, k, Ci, Co), f^3 Ci -> f^3 Co channels."""
    pads, extra = s2d_pads(x_shape[1:4], w_shape[:3], f)
    blocks = [(d + 2 * p + e) // f for d, p, e in zip(x_shape[1:4], pads, extra)]
    return block_conv_flops((x_shape[0], *blocks), (27, f**3 * w_shape[4], f**3 * w_shape[3]))


def s2d_conv3d_model_flops(x_shape, w_shape) -> int:
    """FLOPs of the stride-1 SAME conv B3 computes, counted as a plain
    conv: 2 B X Y Z kx ky kz Ci Co."""
    return 2 * math.prod(x_shape[:4]) * math.prod(w_shape)


def _log_flops(name: str, executed: int, model: Optional[int] = None) -> None:
    if FLOP_LOG is not None:
        FLOP_LOG.append((name, executed, executed if model is None else model))


def _reference(x: torch.Tensor, w: torch.Tensor, layout: str) -> torch.Tensor:
    """27 shifted slices, each contracted with ``w[qx, qy, qz]`` in f32; the
    slice offsets follow x's axis order."""
    b, zi, d2, d3, ci = x.shape
    zo, d2o, d3o = zi - 2, d2 - 2, d3 - 2
    x, w = x.float(), w.float()
    out = torch.zeros((b, zo, d2o, d3o, w.shape[-1]), dtype=torch.float32, device=x.device)
    for qz in range(3):
        for qx in range(3):
            for qy in range(3):
                q2, q3 = (qx, qy) if layout == "zxy" else (qy, qx)
                xa = x[:, qz : qz + zo, q2 : q2 + d2o, q3 : q3 + d3o, :]
                out += torch.einsum("bzuvc,cd->bzuvd", xa, w[qx, qy, qz])
    return out


def block_conv3x3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: x (B, Z, X, Y, Ci) -> f32 (B, Z-2, X-2, Y-2, Co)."""
    return _reference(x, w, "zxy")


def block_conv3x3x3_v2_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of B2: x (B, Z, Y, X, Ci) -> f32 (B, Z-2, Y-2, X-2, Co)."""
    return _reference(x, w, "zyx")


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{name}: expected x (B,Z,.,.,Ci), w (3,3,3,Ci,Co); got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.shape[3] != x.shape[-1] or min(x.shape[1:4]) < 3:
        raise ValueError(f"{name}: incompatible x {tuple(x.shape)} and w {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {x.device}")
    if x.device.type == "cuda":
        if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} takes f32 or bf16 x and w of one dtype; got {x.dtype}, {w.dtype}")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError(f"{name} needs contiguous x and w")


def _launch(x: torch.Tensor, w_km: torch.Tensor, layout: str) -> torch.Tensor:
    """One counted kernel launch on CUDA tensors (checked by ``_check``)."""
    x, w_km = pad_channels(x, w_km)
    if x.data_ptr() % 16:  # a view at an odd offset; the copies are 16-byte
        x = x.clone()
    if x.dtype == torch.float32:
        w_big, w_small = tf32_split(w_km)
    else:
        w_big = w_small = w_km.contiguous()
    b, zi, d2, d3, ci = x.shape
    co = w_km.shape[1]
    out = torch.empty((b, zi - 2, d2 - 2, d3 - 2, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_fn(layout, x.dtype)(
            x.data_ptr(), w_big.data_ptr(), w_small.data_ptr(), out.data_ptr(),
            b, zi, d2, d3, ci, co, torch.cuda.current_stream().cuda_stream,
        )
    wrapper = _WRAPPERS[layout]
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


@torch.library.custom_op(f"{OP_NAMESPACE}::block_conv3x3x3", mutates_args=(), device_types="cpu")
def block_conv_op(x: torch.Tensor, w_km: torch.Tensor, layout: str) -> torch.Tensor:
    """One contraction with the K-major weight ``w_km`` (27, Co, Ci), as an
    operator ``torch.export`` keeps whole: the plain version for a CPU
    tensor, one counted kernel launch for a CUDA tensor; no other device."""
    return _reference(x, from_kmajor(w_km), layout)


block_conv_op.register_kernel("cuda")(_launch)


@block_conv_op.register_fake
def _(x, w_km, layout):
    b, zi, d2, d3, _ = x.shape
    return x.new_empty((b, zi - 2, d2 - 2, d3 - 2, w_km.shape[1]), dtype=torch.float32)


class BlockConv3x3x3Function(torch.autograd.Function):
    """B1/B2 with a backward. ``apply(x, w, layout)``, layout ``"zxy"``
    (B1) or ``"zyx"`` (B2).

    - dx (only when x needs it): a FULL 3^3 conv of dy with the flipped,
      transposed weight, which is the same VALID kernel on dy zero-padded
      by 2 on each spatial side: ``w.flip(0, 1, 2).transpose(3, 4)``
      reverses the taps in all three axes and swaps Ci with Co; its K-major
      form is ``dx_weight(w)``. One counted launch on the card.
    - dw: ``dw[qx, qy, qz] = x_tap^T @ dy`` for each of the 27 taps, with
      x_tap the (M, Ci) slice of x at that tap's offset.
    - bf16 x and w: dy (the f32 output's gradient) is rounded to bf16 first,
      dx is the bf16 launch and dw the products of bf16 operands (f32
      accumulation), each returned in its input's dtype.
    """

    @staticmethod
    def forward(ctx, x, w, layout):
        ctx.layout = layout
        ctx.model = getattr(_stage, "model", None)
        ctx.save_for_backward(x, w)
        return block_conv_op(x, kmajor(w), layout)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        layout = ctx.layout
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        with _model_flops(ctx.model):
            if ctx.needs_input_grad[0]:
                dy_pad = F.pad(dy, (0, 0, 2, 2, 2, 2, 2, 2))  # (B, Z+2, ., ., Co)
                dx = block_conv_op(dy_pad, dx_weight(w), layout).to(x.dtype)
                if dx.is_cuda:
                    _WRAPPERS[layout].backward_launches += 1
            if ctx.needs_input_grad[1]:
                dw = weight_grad(x, dy, layout).to(w.dtype)
        return dx, dw, None


class _model_flops:
    """Within the scope, launches count ``model`` as their model FLOPs
    (``FLOP_LOG``); None leaves the enclosing scope's."""

    def __init__(self, model: Optional[int]):
        self.model = model

    def __enter__(self):
        self.prev = getattr(_stage, "model", None)
        if self.model is not None:
            _stage.model = self.model

    def __exit__(self, *exc):
        _stage.model = self.prev


def weight_grad(x: torch.Tensor, dy: torch.Tensor, layout: str = "zxy") -> torch.Tensor:
    """The block conv's weight gradient, f32 (3, 3, 3, Ci, Co):
    ``dw[qx, qy, qz] = x_tap^T @ dy`` over the 27 taps, in ``torch.matmul``
    on x's and dy's dtype (bf16 operands give bf16 products, summed in f32
    by the matmul; a hand-written wgrad kernel is ROADMAP work)."""
    zo, d2o, d3o = dy.shape[1:4]
    dy_m = dy.reshape(-1, dy.shape[-1])
    _log_flops("weight_grad", 2 * dy_m.shape[0] * 27 * x.shape[-1] * dy.shape[-1], getattr(_stage, "model", None))
    dw = torch.empty((3, 3, 3, x.shape[-1], dy.shape[-1]), dtype=torch.float32, device=x.device)
    for qx in range(3):
        for qy in range(3):
            for qz in range(3):
                q2, q3 = (qx, qy) if layout == "zxy" else (qy, qx)
                xa = x[:, qz : qz + zo, q2 : q2 + d2o, q3 : q3 + d3o, :]
                dw[qx, qy, qz] = xa.reshape(-1, x.shape[-1]).t() @ dy_m
    return dw


def block_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B1: VALID 3^3 conv, x (B, Z, X, Y, Ci) -> f32 (B, Z-2, X-2, Y-2, Co)."""
    _check(x, w, "block_conv3x3x3")
    return _contract(x, w, "zxy")


def block_conv3x3x3_v2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B2: VALID 3^3 conv, x (B, Z, Y, X, Ci) -> f32 (B, Z-2, Y-2, X-2, Co),
    w (3, 3, 3, Ci, Co) indexed [qx, qy, qz] as for B1."""
    _check(x, w, "block_conv3x3x3_v2")
    return _contract(x, w, "zyx")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _contract(x: torch.Tensor, w: torch.Tensor, layout: str) -> torch.Tensor:
    """Through ``BlockConv3x3x3Function`` where a gradient is wanted, else
    the operator alone: what ``torch.export`` records, under no_grad."""
    if _needs_grad(x, w):
        return BlockConv3x3x3Function.apply(x, w, layout)
    return block_conv_op(x, kmajor(w), layout)


_WRAPPERS = {"zxy": block_conv3x3x3, "zyx": block_conv3x3x3_v2}
for _fn in _WRAPPERS.values():
    _fn.launches = 0
    _fn.backward_launches = 0


def launch_counts() -> dict:
    """Every wrapper's launch counts, keyed by (wrapper, attribute)."""
    return {(fn, attr): getattr(fn, attr) for fn in COUNTED for attr in ("launches", "backward_launches")
            if hasattr(fn, attr)}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (a :func:`launch_counts` difference) to the counts.
    A CUDA graph's capture runs the wrappers without launching, and its
    replays launch without running them: the capture's counts are taken
    back and added once per replay."""
    for (fn, attr), n in delta.items():
        setattr(fn, attr, getattr(fn, attr) + n)


def s2d_conv3d_block(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    f: int = 4,
    padding_mode: str = "zeros",
    halo: bool = False,
) -> torch.Tensor:
    """B3: drop-in for ``s2d_conv3d`` (stride 1, 3^3 block kernels — k in
    5..8 at f=4) backed by B1; x (B, X, Y, Z, Ci), w (k, k, k, Ci, Co).
    Where no gradient is wanted it runs as the operator
    ``s2d_conv3d_block_op``, which ``torch.export`` keeps whole.

    ``halo``: x's X already holds the conv's (k-1)//2 rows on each side
    (an X-slab extended by its halo, ``parallel/spatial.halo_extend``), so
    X is not padded here and the output has ``X - (k - 1)`` rows, any
    number of them (the block grid is rounded up with zeros and cropped);
    Y and Z are padded as without it. The gradient of those rows comes
    back unfolded, for the exchange to return to their owners."""
    Ks = [_axis_map(k, f)[1] for k in w.shape[:3]]
    if Ks != [3, 3, 3] or any(d % f for d in x.shape[1 + halo : 4]):
        if halo:
            raise ValueError(f"s2d_conv3d_block(halo=True) needs Y, Z {tuple(x.shape[2:4])} that divide f={f} and "
                             f"3^3 block kernels")
        return s2d_conv3d(x, w, bias, f=f, padding_mode=padding_mode)
    check_padding_mode(padding_mode)
    if _needs_grad(x, w, bias):
        return _s2d_block(x, w, bias, f, padding_mode, halo)
    if halo:
        return s2d_conv3d_block_op(x, w, bias, f, padding_mode, True)
    return s2d_conv3d_block_op(x, w, bias, f, padding_mode)


def _s2d_block(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], f: int,
               padding_mode: str, halo: bool = False) -> torch.Tensor:
    """B3's glue around one B1 launch (counted here on the card): pad,
    space-to-depth, B1, depth-to-space, bias in x's dtype; X unpadded
    with ``halo``."""
    mode = check_padding_mode(padding_mode)
    B, X, Y, Z, ci = x.shape
    if halo:
        X -= w.shape[0] - 1
    pads, extra = s2d_pads((X, Y, Z), w.shape[:3], f)  # as the JAX wrapper pads
    xp = pad_spatial(x, [(0, 0) if halo and i == 0 else (p, p) for i, p in enumerate(pads)], mode)
    if any(extra):
        xp = pad_spatial(xp, [(0, e) for e in extra])
    xs = space_to_depth(xp, f)  # (B, Xb+2, Yb+2, Zb+2, f^3 ci)
    ws = transform_kernel(w, f).to(x.dtype)  # [kx, ky, kz] block taps
    # B1 pairs w's axes (0, 1, 2) with x's spatial axes (2, 3, 1); on the
    # (X, Y, Z) block grid that takes the taps ordered [ky, kz, kx]
    with _model_flops(s2d_conv3d_model_flops((B, X, Y, Z, ci), w.shape)):
        out = block_conv3x3x3(xs, ws.permute(1, 2, 0, 3, 4).contiguous())  # (B, Xb', Yb', Zb', f^3 co) f32
    if x.is_cuda:
        s2d_conv3d_block.launches += 1
    out = out[:, : -(-X // f), : Y // f, : Z // f].to(x.dtype)
    out = depth_to_space(out, f)[:, :X]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


@torch.library.custom_op(f"{OP_NAMESPACE}::s2d_conv3d_block", mutates_args=(), device_types=("cpu", "cuda"))
def s2d_conv3d_block_op(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], f: int,
                        padding_mode: str, halo: bool = False) -> torch.Tensor:
    """B3 without a gradient, as one operator: ``_s2d_block``, whose B1 is
    ``block_conv_op`` (the plain version on the CPU, the kernel on the
    card)."""
    return _s2d_block(x, w, bias, f, padding_mode, halo)


@s2d_conv3d_block_op.register_fake
def _(x, w, bias, f, padding_mode, halo=False):
    out_x = x.shape[1] - (w.shape[0] - 1) if halo else x.shape[1]
    return x.new_empty((x.shape[0], out_x, *x.shape[2:-1], w.shape[-1]))


s2d_conv3d_block.launches = 0
COUNTED = (block_conv3x3x3, block_conv3x3x3_v2, s2d_conv3d_block)


def _b1_flop(x_shape, w_km_shape, layout, *args, out_shape=None, **kwargs) -> int:
    n = block_conv_flops(x_shape, w_km_shape)
    _log_flops("block_conv3x3x3" if layout == "zxy" else "block_conv3x3x3_v2", n, getattr(_stage, "model", None))
    return n


def _b3_flop(x_shape, w_shape, bias_shape, f, padding_mode, halo=False, *args, out_shape=None, **kwargs) -> int:
    if halo:  # the output's rows, as without a halo
        x_shape = (x_shape[0], x_shape[1] - (w_shape[0] - 1), *x_shape[2:])
    n = s2d_conv3d_block_flops(x_shape, w_shape, f)
    _log_flops("s2d_conv3d_block", n, s2d_conv3d_model_flops(x_shape, w_shape))
    return n


for _op, _formula in ((torch.ops.contrast_gan_3d_torch.block_conv3x3x3, _b1_flop),
                      (torch.ops.contrast_gan_3d_torch.s2d_conv3d_block, _b3_flop)):
    if _op not in flop_registry:  # registered once per process
        register_flop_formula(_op)(_formula)
