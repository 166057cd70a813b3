"""What a run measured, as the per-layer metric readers see it, and the
table of peaks they divide by.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W
limit: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
outside them (the corrector's f32 convolutions run with TF32 off), and
3.35 TB/s of HBM3. A card set below 700 W reaches less; the run prints its
limit beside the numbers.
"""

from dataclasses import dataclass
from typing import Optional

from benchmark.counts import Tally
from benchmark.trace import Reduced

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


@dataclass
class Measured:
    kind: str                 # "train" or "correct": the loop that ran
    dtype: str                # the precision of the work, a key of PEAK_FLOPS
    units: int                # cycles or volumes completed in the window
    seconds: float            # the window's length
    peak_bytes: int           # the window's peak of torch.cuda.memory_reserved(), less the benchmark's own inputs
    unit_work: Tally          # the model's convolutions in one unit
    stretch_units: int = 0    # units inside the profiled stretch
    profiler_seconds: float = 0.0  # the profiled stretch with the profiler's start and stop
    trace: Optional[Reduced] = None

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]
