"""contrast_gan_3d_tpu_torch — the PyTorch/CUDA port of ``contrast_gan_3d_tpu``.

The port mirrors the JAX package's module paths (``models/generator.py``,
``ops/sliding_window.py``, ``eval/corrector.py``, ...) so each module's
counterpart is easy to find. It imports torch and numpy only — nothing of
JAX and nothing of the JAX package. Every TPU (Pallas) kernel on a ported
path is a hand-written CUDA kernel for Hopper (``ops/csrc``), built at first
use into ``build/torch_kernels/`` (``ops/_build.py``).

Entry points run on the card by default (``device="cuda"``) and raise when
CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
