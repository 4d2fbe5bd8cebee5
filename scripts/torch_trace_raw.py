"""Ungrouped per-operation view of a trace that `scripts/torch_trace_step.py`
wrote, on the PyTorch port (counterpart of `scripts/trace_raw.py`).

Where `torch_trace_step.py` groups the device operations by name, this
prints each name's total ms a step with its shapes: a kernel's launch
configuration (grid and block) and, where the trace links it (its
"External id") to the operator that launched it, that operator's name and
input shapes (`record_shapes`; an eager trace, `torch_trace_step.py
--eager`, links every PyTorch operator's kernels; a graph's replay and the
port's own kernels launch outside any operator). The trace loader and the
device-operation predicate are the ones `torch_trace_step.py` uses
(`utils/profiling.load_trace`, `is_device_op`).

`--device` says which trace it is: "cuda" (the default) a trace of the
card, which must hold device operations (it raises without one); "cpu" a
trace taken with `--device cpu`, whose outermost CPU operators are printed
with their input shapes, as CPU times.

Usage:
  python3 scripts/torch_trace_raw.py [--logdir <torch_trace_step's>] [--top 40] [--steps 3]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "trace_step"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--filter", default="", help="regex on op name")
    ap.add_argument("--device", default="cuda", help="the trace's device: cuda (default) or cpu")
    return ap.parse_args(argv)


def shapes_of(ev: dict, operators: dict) -> str:
    """A device operation's shapes: its grid and block, and the input dims
    of the operator the trace links it to; an operator's own input dims."""
    args = ev.get("args", {}) or {}
    parts = []
    if "grid" in args:
        parts.append(f"grid={args['grid']} block={args.get('block')}")
    op = operators.get(args.get("External id")) if ev.get("cat") != "cpu_op" else ev
    if op is not None:
        dims = [d for d in (op.get("args", {}) or {}).get("Input Dims", []) if d]
        parts.append(f"{op['name']}{dims}" if op is not ev else f"{dims}")
    return " ".join(parts)


def raw_rows(events: list, device: str, steps: int, pattern: str = ""):
    """[(ms a step, name, shapes)] of the trace's device operations (on the
    CPU its outermost operators), longest first; on the card it raises
    without a device operation."""
    from stratanet2_tpu_torch.utils.profiling import is_device_op, outermost

    operators = {ev["args"]["External id"]: ev for ev in events
                 if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"
                 and "External id" in (ev.get("args") or {})}
    ops = [ev for ev in events if is_device_op(ev, device)]
    if device == "cpu":
        ops = outermost(ops)
    elif not ops:
        raise RuntimeError("the trace holds no device operation: the profiler saw no kernel")
    per_op, detail = defaultdict(float), {}
    for ev in ops:
        name = ev.get("name", "")
        if pattern and not re.search(pattern, name):
            continue
        per_op[name] += ev.get("dur", 0) / 1e3
        detail.setdefault(name, shapes_of(ev, operators))
    return sorted(((ms / steps, name, detail[name]) for name, ms in per_op.items()),
                  reverse=True)


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.utils.profiling import load_trace

    device = "cpu" if ns.device == "cpu" else "cuda"
    rows = raw_rows(load_trace(ns.logdir), device, ns.steps, ns.filter)
    tail = "" if device == "cuda" else "  [CPU times]"
    print(f"{'ms/step':>8s}  {'op':48s} shapes{tail}")
    for ms, name, shapes in rows[:ns.top]:
        print(f"{ms:8.3f}  {name[:48]:48s} {shapes[:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
