"""The table of peaks a roofline share is taken against, and the context a
per-layer reader reads.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit; the result line carries the card's own power limit beside them):
HBM at 3.35 TB/s; 67 T operations/s outside the tensor cores (the float32
rate: the data sheet gives no int32 rate, and the integer pipe is no wider,
so integer compares and adds are held to it too); 1,979 T int8
operations/s on the tensor cores."""
from __future__ import annotations

import dataclasses
import re

BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12


def least_seconds(work: dict) -> float:
    """The least time of `{"ops", "bytes"}` on the card: the larger of the
    operations at the scalar peak and the bytes at the memory peak."""
    return max(work["ops"] / OPS_PER_S, work["bytes"] / BYTES_PER_S)


@dataclasses.dataclass
class Context:
    """What a per-layer reader (`metrics/<name>.py`, `read(ctx)`) reads."""
    cfg: dict                      # the configuration file
    trace: object                  # harness.trace.Trace of the traced window
    requests: int                  # requests in the traced window
    least_work: list               # per request: {"match"|"search": {"ops", "bytes"}}
    own_kernels: re.Pattern        # names of the program's own CUDA kernels
    readings: dict = dataclasses.field(default_factory=dict)   # the loop's, by name

    def count_kernels(self) -> re.Pattern:
        """The configuration's count layer kernels (`count_kernels`)."""
        return re.compile(r"\b(?:" + "|".join(map(re.escape, self.cfg["count_kernels"])) + r")\b")

    def least_seconds(self, part: str) -> float:
        """Least seconds of `part` a request, averaged over the requests."""
        return sum(least_seconds(w[part]) for w in self.least_work) / len(self.least_work)
