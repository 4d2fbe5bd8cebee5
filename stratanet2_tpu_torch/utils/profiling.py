"""Tracing / profiling utilities (counterpart of
`stratanet2_tpu/utils/profiling.py`).

- `Phase`: nested wall-clock phase timers with points/sec counters, dumped
  as JSON (a copy).
- `trace`: context manager around `torch.profiler` that writes a
  TensorBoard trace of the host and, where there is one, the card
  (a no-op with a warning where the profiler cannot start).
- `device_sync`: waits for the card's queued work and returns a host
  scalar of `x`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("stratanet2_tpu_torch")


def device_sync(x) -> float:
    """Force completion of the device work feeding `x`; returns a host
    scalar (its sum)."""
    x = torch.as_tensor(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.sum())


@dataclass
class Phase:
    """Hierarchical phase timing with throughput counters.

    Usage:
      prof = Phase("train")
      with prof.phase("epoch"):
          with prof.phase("forward", points=B * N):
              ...
      prof.report()
    """

    name: str = "root"
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    points: Dict[str, int] = field(default_factory=dict)
    _stack: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, points: int = 0):
        key = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.totals[key] = self.totals.get(key, 0.0) + dt
            self.counts[key] = self.counts.get(key, 0) + 1
            if points:
                self.points[key] = self.points.get(key, 0) + points

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for key, total in sorted(self.totals.items()):
            row = {
                "seconds": round(total, 4),
                "calls": self.counts[key],
                "mean_ms": round(total / self.counts[key] * 1000, 3),
            }
            if key in self.points:
                row["points_per_sec"] = round(self.points[key] / total, 1)
            out[key] = row
        return out

    def report(self, path: Optional[str] = None) -> str:
        s = json.dumps({"profile": self.name, "phases": self.summary()}, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        else:
            logger.info("profile %s:\n%s", self.name, s)
        return s


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the host and the card into `log_dir`, in
    TensorBoard's format; a no-op if the profiler cannot start."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    started = False
    try:
        prof.start()
        started = True
    except Exception as err:  # pragma: no cover
        logger.warning("torch profiler trace unavailable: %s", err)
    try:
        yield
    finally:
        if started:
            prof.stop()
