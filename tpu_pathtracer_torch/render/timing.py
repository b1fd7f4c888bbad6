"""Per-pass timing utilities.

The port of `tpu_pathtracer.render.timing`.  The reference wraps every GPU
pass in timestamp queries and smooths the readback over a 30-sample rolling
window (reference: src/timing.ts:1-20, 28-146).  On the card a pass is timed
by CUDA events recorded on the stream before and after it, the counterpart
of those timestamp queries; on the CPU by the wall clock once the work has
run (CPU tensors compute eagerly).  Which clock is used follows the timer's
device and nothing else.
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager

from ..utils import spans


class RollingAverage:
    """30-sample ring-buffer mean (reference: src/timing.ts:1-20)."""

    def __init__(self, num_samples: int = 30) -> None:
        self._num_samples = num_samples
        self._samples: list[float] = []
        self._cursor = 0

    def add_sample(self, value: float) -> None:
        if len(self._samples) < self._num_samples:
            self._samples.append(value)
        else:
            self._samples[self._cursor] = value
        self._cursor = (self._cursor + 1) % self._num_samples

    @property
    def value(self) -> float:
        if not self._samples:
            return 0.0
        return sum(self._samples) / len(self._samples)


class PassTimer:
    """Times one named pass on `device`; `value` is the rolling mean in
    microseconds.  On the card a pass's CUDA events are read only when
    `value` is asked for, so timing a pass makes the host wait for nothing."""

    def __init__(self, name: str, device="cpu") -> None:
        import torch

        self.name = name
        self.device = torch.device(device)
        self.average = RollingAverage()
        # the passes timed on the card since `value` was last read; older
        # ones would leave the rolling window unread
        self._pending: collections.deque = collections.deque(maxlen=self.average._num_samples)

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    @contextmanager
    def measure(self):
        """Time the work enqueued inside the block: CUDA events around it on
        the card (`spans.DeviceTiming`; the span ends when the last of it
        finishes), the wall clock on the CPU."""
        if self._on_card:
            with spans.device_timed(self.device) as timing:
                yield
            self._pending.append(timing)
        else:
            t0 = time.perf_counter()
            yield
            self.average.add_sample((time.perf_counter() - t0) * 1e6)

    def time_device(self, fn, *args, **kwargs):
        """Run fn and record its span on the device (`measure`); returns
        fn's output."""
        with self.measure():
            out = fn(*args, **kwargs)
        return out

    @property
    def value(self) -> float:
        while self._pending:
            self.average.add_sample(self._pending.popleft().ms() * 1e3)
        return self.average.value
