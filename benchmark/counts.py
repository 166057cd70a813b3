"""The model's convolution work, counted from shapes (frozen formulas: the
program's own accounting is not read).

Each convolution of the published networks at the direct layout's shapes:
a convolution's forward is ``2 * N * Ci * Co * prod(k) * prod(out)``
operations, a stride-2 transpose convolution's ``2 * N * Ci * Co * prod(k)
* prod(in)``; its input gradient (dgrad) and its weight gradient (wgrad)
each as many. Bytes: every operand read once and the result written once,
at the element size of the work (2 for bf16, 4 for float32). Training counts
what one iteration's branch needs: no input gradient into a network's
input, no weight gradient of the critic in the generator's update.
"""

import math
from dataclasses import dataclass
from typing import List, Sequence

ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class Conv:
    name: str
    c_in: int
    c_out: int
    kernel: int
    spatial_in: tuple
    spatial_out: tuple
    transpose: bool = False

    def flops(self, n: int) -> float:
        k = self.kernel ** len(self.spatial_in)
        points = math.prod(self.spatial_in if self.transpose else self.spatial_out)
        return 2.0 * n * self.c_in * self.c_out * k * points

    def elements(self, n: int) -> tuple:
        """(input, weight, output) element counts."""
        k = self.kernel ** len(self.spatial_in)
        return (n * self.c_in * math.prod(self.spatial_in), self.c_in * self.c_out * k,
                n * self.c_out * math.prod(self.spatial_out))


def _down(s, k, stride, pad):
    return tuple((d + 2 * pad - k) // stride + 1 for d in s)


def generator_convs(arch: dict, spatial: Sequence[int]) -> List[Conv]:
    c0, n = arch["init_channels_out"], arch["n_updownsample_blocks"]
    s = tuple(spatial)
    out = [Conv("first", 1, c0, 7, s, s)]
    for i in range(n):
        s2 = _down(s, 3, 2, 1)
        out.append(Conv(f"down_{i}", c0 * 2**i, c0 * 2 ** (i + 1), 3, s, s2))
        s = s2
    c = c0 * 2**n
    for i in range(arch["n_resnet_blocks"]):
        out += [Conv(f"resnet_{i}.block0", c, c, 3, s, s), Conv(f"resnet_{i}.block1", c, c, 3, s, s)]
    for i in range(n, 0, -1):
        s2 = tuple(2 * d for d in s)
        out.append(Conv(f"up_{i - 1}", c0 * 2**i, c0 * 2 ** (i - 1), 3, s, s2, transpose=True))
        s = s2
    out.append(Conv("last_conv", c0, 1, 7, s, s))
    return out


def critic_convs(arch: dict, spatial: Sequence[int]) -> List[Conv]:
    c0, s = arch["init_channels_out"], tuple(spatial)
    s2 = _down(s, 4, 2, 1)
    out, c_in, s = [Conv("first", 1, c0, 4, s, s2)], c0, s2
    for i in range(arch["discriminator_depth"]):
        c_out = min(2 ** (i + 1), 8) * c0
        s2 = _down(s, 4, 2, 1)
        out.append(Conv(f"middle_{i}", c_in, c_out, 4, s, s2))
        c_in, s = c_out, s2
    out.append(Conv("last", c_in, 1, 4, s, _down(s, 4, 1, 1)))
    return out


class Tally:
    """Operations and bytes of a list of convolution passes, and their
    least time on a chip of given peaks."""

    def __init__(self, element_bytes: int):
        self.eb = element_bytes
        self.passes: List[tuple] = []  # (flops, bytes)

    def add(self, convs: Sequence[Conv], n: int, kind: str, skip_first: bool = False):
        """``kind``: fwd, dgrad or wgrad over every conv of ``convs`` at batch
        ``n``; ``skip_first`` leaves out the first conv (no gradient into
        the network's input)."""
        for i, c in enumerate(convs):
            if skip_first and i == 0:
                continue
            x, w, y = c.elements(n)
            # fwd reads x, w and writes y; dgrad reads dy, w, writes dx;
            # wgrad reads x, dy, writes dw
            self.passes.append((c.flops(n), (x + w + y) * self.eb))
        return self

    @property
    def flops(self) -> float:
        return sum(f for f, _ in self.passes)

    @property
    def bytes(self) -> float:
        return sum(b for _, b in self.passes)

    def bound_s(self, peak_flops: float, peak_bytes: float) -> float:
        """Sum over the passes of max(operations / peak, bytes / bandwidth)."""
        return sum(max(f / peak_flops, b / peak_bytes) for f, b in self.passes)


def train_cycle(config: dict, pattern: Sequence[str]) -> Tally:
    """The convolutions of one training cycle of ``pattern`` (branch per
    iteration) at the configuration's patch and batch sizes."""
    t = config["train"]
    g = generator_convs(config["generator"], t["patch"])
    d = critic_convs(config["critic"], t["patch"])
    b_opt = t["batch"]["opt"]
    b_sub = t["batch"]["low"] + t["batch"]["high"]
    tally = Tally(ELEMENT_BYTES[t["dtype"]])
    for branch in pattern:
        if branch == "none":
            continue
        tally.add(g, b_sub, "fwd")
        if branch in ("critic", "combined"):
            tally.add(d, b_opt + b_sub, "fwd").add(d, b_opt + b_sub, "wgrad")
            tally.add(d, b_opt + b_sub, "dgrad", skip_first=True)
        if branch in ("generator", "combined"):
            tally.add(d, b_sub, "fwd").add(d, b_sub, "dgrad")
            tally.add(g, b_sub, "wgrad").add(g, b_sub, "dgrad", skip_first=True)
    return tally


def correct_volume(config: dict, volume_shape: Sequence[int], windows: int) -> Tally:
    """The generator forwards of one corrected volume: ``windows`` patches
    (3D) or the volume's slices (2D), at the correction's precision."""
    c = config["correct"]
    tally = Tally(ELEMENT_BYTES[c["dtype"]])
    if len(c["patch"]) == 2:
        return tally.add(generator_convs(config["generator"], volume_shape[:2]), volume_shape[2], "fwd")
    return tally.add(generator_convs(config["generator"], c["patch"]), windows, "fwd")
