"""Timers (counterpart of ``eppm_tpu/utils/timing.py``, after the
reference's timer classes, SURVEY.md §5):

* ``Timer``: the wall clock (bao_timer_cpu);
* ``DeviceTimer``: on a CUDA device the time between two CUDA events on
  the current stream, read after the end event has completed
  (bao_timer_gpu); on the CPU, where the caller asks for it, the wall
  clock;
* ``time_stage``: the least of n runs of a callable, each ending in a
  synchronize of the device.

Spans of the program's own stages are the tracer's (``trace.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch

__all__ = ["Timer", "DeviceTimer", "time_stage"]


def _device(device) -> torch.device:
    """``device``, by default the current CUDA device; a CUDA device where
    there is none raises (``device="cpu"`` times the host)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the timers run on the CUDA device and there is "
                           "none: pass device='cpu' for the CPU")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock timer (bao_timer_cpu): start / stop / time_display."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        """Seconds since ``start``."""
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        return time.perf_counter() - self._t0

    def time_display(self, label: str = "") -> float:
        dt = self.stop()
        print(f"[{label}] {dt * 1000:.2f} ms")
        return dt


class DeviceTimer(Timer):
    """Seconds from ``start`` until the device has done the work enqueued
    before ``stop``: CUDA events on ``device`` (the current CUDA device
    by default; it raises without one), the wall clock on the CPU."""

    def __init__(self, device: Union[str, torch.device, None] = None):
        super().__init__()
        self.device = _device(device)
        self._event = None

    def start(self) -> "DeviceTimer":
        if self.device.type == "cuda":
            self._event = torch.cuda.Event(enable_timing=True)
            self._event.record(torch.cuda.current_stream(self.device))
        return super().start()

    def stop(self) -> float:
        if self.device.type != "cuda":
            return super().stop()
        if self._event is None:
            raise RuntimeError("DeviceTimer.stop() before start()")
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        end.synchronize()
        return self._event.elapsed_time(end) / 1e3


def time_stage(fn: Callable, *args, n: int = 5, label: str = "",
               verbose: bool = True,
               device: Union[str, torch.device, None] = None) -> float:
    """The least wall time in seconds of ``n`` runs of ``fn(*args)``
    after one warm-up run, each ending in a synchronize of ``device``
    (the current CUDA device by default; it raises without one)."""
    device = _device(device)
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    if verbose and label:
        print(f"[{label}] {best * 1000:.2f} ms")
    return best
