"""Profiling hooks, port of ``multimodal_pl_tpu/utils/profiling.py``: a
``torch.profiler`` trace written as a Chrome trace, and a rolling step timer
that synchronizes the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator[None]:
    """Profile the body with ``torch.profiler`` and write a Chrome trace
    (``trace_<pid>_<ns>.json``, viewable in Perfetto) into ``log_dir``, also
    when the body raises. CPU activity always; CUDA activity (device kernel
    events) when ``device`` is a CUDA device, which then must exist."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: device 'cuda' asked for, but no CUDA device is "
                               "available; pass device='cpu' for a host-only trace")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))


class StepTimer:
    """Rolling per-step wall clock over the last ``window`` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        """Seconds since ``start``. A ``sync_value`` tensor on a CUDA device
        first waits for that device's queued work."""
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def rate(self, items_per_step: float = 1.0) -> float:
        return items_per_step / self.mean if self.times else 0.0
