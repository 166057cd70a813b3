"""The port's device rule: entry points default to CUDA and never fall back
to the CPU on their own; and the f32 precision rule: entry points run f32
convolutions and matmuls in full f32, not in TF32 (``full_f32``)."""

import contextlib
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (the CPU runs only when the caller names it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device


# the TF32 switches are process-wide, and correctors run in several threads
# (the daemon's handlers, the overlapped file cohort): the outermost scope
# saves and sets them, the last one out restores them
_F32_LOCK = threading.Lock()
_f32_depth = 0
_f32_saved = None


def tf32_flags():
    """(``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.
    allow_tf32``)."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set_tf32(cudnn: bool, matmul: bool):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def full_f32():
    """Run the enclosed f32 work with cuDNN's and cuBLAS's TF32 off.

    PyTorch leaves ``cudnn.allow_tf32`` on by default, which rounds every
    f32 convolution's inputs to a 10-bit mantissa: the correction then
    misses the 0.1 HU agreement the port holds with the JAX package
    (PERF.md, C6). The entry points (the corrector, correction artifacts,
    the daemon, the train CLI) run inside this scope. Only the two TF32
    switches change; ``deterministic``, ``benchmark`` and every other flag
    are the caller's. On exit of the outermost scope the switches are as
    it found them. bf16 work is not affected, nor is the packed stage
    convs' kernel (``ops/packed_conv.py``), which is 3xTF32 either way."""
    global _f32_depth, _f32_saved
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_saved = tf32_flags()
            _set_tf32(False, False)
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                _set_tf32(*_f32_saved)
