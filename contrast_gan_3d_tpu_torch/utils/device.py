"""The port's device rule: entry points default to CUDA and never fall back
to the CPU on their own."""

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
