"""Tracing / profiling utilities (counterpart of
`stratanet2_tpu/utils/profiling.py`).

- `Phase`: nested wall-clock phase timers with points/sec counters, dumped
  as JSON (a copy).
- `trace`: context manager around `torch.profiler` that writes a
  TensorBoard trace of the host and, where there is one, the card (it
  raises where the profiler cannot start).
- `device_sync`: waits for the card's queued work and returns a host
  scalar of `x`.
- Reading a trace (the counterpart of the JAX side's
  `scripts/trace_step.py` parser, which `scripts/trace_raw.py` shares):
  `load_trace` reads the newest trace a `trace` wrote, `is_device_op`
  picks the operations of a device from it and `device_table` groups them
  by name into time a step, with the device's busy time and idle share.
- `time_ms`: a callable's time on its device (CUDA events on the card,
  the host clock on the CPU); `card_name`: the card's name and power limit
  as `nvidia-smi` gives them; `record_calls`: the arguments of every call
  of a module's named functions while a step runs (the sites a step gives
  each kernel).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

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
def trace(log_dir: str, warmup: int = 0):
    """torch.profiler trace of the host and, where there is one, the card
    into `log_dir`, in TensorBoard's format, each operator with its input
    shapes (`load_trace` reads it back); yields the profiler. With `warmup`,
    the first `warmup` steps, each ended by the caller's `prof.step()`, run
    under the profiler's warm-up and are left out of the trace (late in a
    long run on an H100 a trace's first tens of ms lost their kernels).
    Raises where the profiler cannot start: a measurement never goes on
    without it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = (torch.profiler.schedule(wait=0, warmup=warmup, active=1, repeat=1)
                if warmup else None)
    prof = torch.profiler.profile(
        activities=activities, record_shapes=True, schedule=schedule,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    try:
        prof.start()
    except Exception as err:
        raise RuntimeError(f"torch profiler trace unavailable: {err}") from err
    try:
        yield prof
    finally:
        prof.stop()


# the trace's categories of device operations: kernels, copies and memsets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(log_dir: str) -> List[dict]:
    """The events of the newest trace under `log_dir` (a `trace`'s
    `*.pt.trace.json`, or gzipped)."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json*"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)["traceEvents"]


def is_device_op(ev: dict, device: str = "cuda") -> bool:
    """True for a complete span that is an operation of `device`: on the
    card a kernel, copy or memset; on the CPU an operator (`cpu_op`)."""
    if ev.get("ph") != "X":
        return False
    if device == "cpu":
        return ev.get("cat") == "cpu_op"
    return ev.get("cat") in DEVICE_CATEGORIES


def outermost(events: Iterable[dict]) -> List[dict]:
    """The spans not inside another of the list on their thread (the CPU's
    operators nest: an outer one's time holds its inner ones')."""
    out, ends = [], {}
    for ev in sorted(events, key=lambda e: (e.get("tid"), e["ts"], -e.get("dur", 0))):
        tid = ev.get("tid")
        if ev["ts"] >= ends.get(tid, float("-inf")):
            out.append(ev)
            ends[tid] = ev["ts"] + ev.get("dur", 0)
    return out


class DeviceTable(NamedTuple):
    rows: List[Tuple[float, float, str]]  # (ms a step, calls a step, name), longest first
    busy_ms: float  # device ms a step
    idle_share: Optional[float]  # 1 - busy / step wall, where a wall was given


def device_table(events: Iterable[dict], steps: int, step_ms: Optional[float] = None,
                 device: str = "cuda") -> DeviceTable:
    """Device operations (events with `name` and `dur` in microseconds, as
    `load_trace` reads them) grouped by name: each name's ms and calls
    a step over `steps` steps, longest first, the busy ms a step and, given
    the wall `step_ms` of a step, the idle share 1 - busy / wall. On the
    card (`device` "cuda") a trace without any device operation raises: the
    profiler saw nothing, which is not an idle card."""
    per_op: Dict[str, List[float]] = {}
    for ev in events:
        acc = per_op.setdefault(ev["name"], [0.0, 0.0])
        acc[0] += ev.get("dur", 0) / 1e3
        acc[1] += 1
    if device != "cpu" and not per_op:
        raise RuntimeError("the trace holds no device operation: the profiler saw no kernel")
    rows = sorted(((ms / steps, calls / steps, name) for name, (ms, calls) in per_op.items()),
                  reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    idle = None if step_ms is None else 1 - busy / step_ms
    return DeviceTable(rows, busy, idle)


def time_ms(fn: Callable[[], object], reps: int, device="cuda", warmup: bool = True) -> float:
    """Mean ms of `fn` over `reps` calls in a row, after one warm-up call
    unless `warmup` is False (a call of seconds has nothing left to warm):
    by CUDA events on the card, by the host clock on the CPU (whose time is
    then a CPU time, never a device's)."""
    if warmup:
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def card_name(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def record_calls(module, names: Sequence[str], run: Callable[[], object]
                 ) -> Dict[str, List[tuple]]:
    """The positional arguments of every call of `module`'s functions
    `names` (the kernels' wrappers of `ops/cuda_kernels`) while `run` runs;
    the calls go through as usual. Only calls through the module's
    attribute (`cuda_kernels.fps(...)`, as the port's layers make them) are
    seen."""
    calls: Dict[str, List[tuple]] = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name):
        def record(*args):
            calls[name].append(args)
            return originals[name](*args)
        return record

    for name in names:
        setattr(module, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
    return calls
