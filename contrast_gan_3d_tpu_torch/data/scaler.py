"""Invertible HU intensity scalers (the port's own copy of
``contrast_gan_3d_tpu/data/scaler.py``).

``ZeroCenterScaler`` subtracts ``shift = (high - |low|) // 2`` (not the range
midpoint — a reference quirk kept for parity: with (low, high) = (-1024,
1500) the shift is 238); ``FactorZeroCenterScaler`` additionally divides by a
factor (default 600 = MAX_HU_DELTA). Frozen dataclasses of pure functions, so
the same object works on numpy arrays and torch tensors.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Scaler:
    """Identity scaler (base)."""

    def __call__(self, x):
        return x

    def unscale(self, x):
        return x


@dataclass(frozen=True)
class ZeroCenterScaler(Scaler):
    low: int = -1024
    high: int = 1500
    shift: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "shift", (self.high - abs(self.low)) // 2)

    def __call__(self, x):
        return x - self.shift

    def unscale(self, x):
        return x + self.shift


@dataclass(frozen=True)
class FactorZeroCenterScaler(ZeroCenterScaler):
    factor: int = 600

    def __call__(self, x):
        return (x - self.shift) / self.factor

    def unscale(self, x):
        return x * self.factor + self.shift
