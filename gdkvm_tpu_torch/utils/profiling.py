"""Tracing and step timing (port of gdkvm_tpu/utils/profiling.py).

``trace_annotation`` names a region in a ``torch.profiler`` trace,
``maybe_profile`` captures one into a directory when asked
(``runtime.profile``), and ``StepTimer`` measures steps/s over windows
without a host synchronization every step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named region visible in the profiler's trace."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a CPU (and, with a card, CUDA) trace of the block into
    ``trace_dir/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing) when ``trace_dir`` is set; nothing otherwise."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StepTimer:
    """Steps/s over windows of steps, the first ``skip`` steps left out.

    A lap only counts: CUDA work is queued asynchronously, and a fetch
    every step would stall the host behind the device.  The caller forces
    execution once a window, by fetching its metrics for the log, and calls
    :meth:`stats` right after: window seconds over window laps is then the
    pipelined rate.  The first ``skip`` laps (kernel builds, cuDNN's
    algorithm search, allocator warm-up) are fetched and the clock is
    restarted after them, so they are in no window.
    """

    def __init__(self, skip: int = 1) -> None:
        self.skip = skip
        self._laps = 0
        self._window_laps = 0
        self._t0 = time.perf_counter()

    def lap(self, result: Optional[torch.Tensor] = None) -> None:
        """Mark a step boundary.  ``result`` (a 0-dim tensor) is fetched
        only during the first ``skip`` laps."""
        self._laps += 1
        if self._laps <= self.skip:
            if result is not None:
                result.item()
            self._t0 = time.perf_counter()
            return
        self._window_laps += 1

    def stats(self) -> Dict[str, float]:
        """The window's rate; call right after fetching a step's results.
        Empty when the window has no lap (a rate of 0 or infinity would
        poison the JSON log)."""
        if not self._window_laps:
            return {}
        sec = (time.perf_counter() - self._t0) / self._window_laps
        return {"steps_per_sec": 1.0 / sec, "sec_per_step": sec}

    def reset_window(self) -> None:
        self._window_laps = 0
        self._t0 = time.perf_counter()
