"""Experiment plumbing: run folders, logging, pluggable metric sink (a copy
of `stratanet2_tpu/utils/experiment.py` without `enable_compilation_cache`,
which configures JAX's compile cache; the port's kernels keep their own
build cache, `ops/_build.py`).

Mirrors the reference's artifact tree — timestamped
experiments/{task}/{mode}/{timestamp}/ with stats.txt (utils/utils.py:49-62)
— and replaces Comet.ml with a local JSONL metric sink (SURVEY.md §5
'pluggable metric sink'). Every metric the reference sent to Comet lands in
metrics.jsonl with its context/epoch/step, so offline analysis scripts can
re-aggregate.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional


def setup_experiment_folder(experiments_path: str, task: str, mode: str) -> str:
    """experiments/{task}/{mode}/{timestamp}/ (utils/utils.py:49-62).

    Timestamps have second resolution; two workers of a concurrent fleet
    (the worklist design supports them) starting in the same second must
    not share a folder — uniquify with a suffix instead of exist_ok."""
    run_name = time.strftime("%Y-%m-%d_%Hh%Mm%Ss")
    for attempt in range(100):
        suffix = "" if attempt == 0 else f"_{attempt + 1}"
        stats_path = os.path.join(experiments_path, task, mode, run_name + suffix)
        try:
            os.makedirs(stats_path, exist_ok=False)
            return stats_path
        except FileExistsError:
            continue
    raise FileExistsError(f"cannot create a unique run folder at {stats_path}")


def create_logger(stats_path: Optional[str]) -> logging.Logger:
    """stdout + stats.txt logger (utils/utils.py:12-22); stdout alone when
    `stats_path` is None (a rank that writes no file)."""
    logger = logging.getLogger("stratanet2_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s:%(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    handlers = [logging.StreamHandler(sys.stdout)]
    if stats_path is not None:
        handlers.insert(0, logging.FileHandler(os.path.join(stats_path, "stats.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


@dataclass
class MetricSink:
    """JSONL metric sink with Comet-like contexts.

    Usage:
      sink = MetricSink(stats_path)
      with sink.context("fold_1_train"):
          sink.log_metrics({"total_loss": 0.3}, epoch=3, step=120)
    """

    stats_path: str
    _context: str = ""
    _fh: Any = None
    epoch: int = 0
    _tb: Any = None

    def __post_init__(self):
        self._fh = open(os.path.join(self.stats_path, "metrics.jsonl"), "a")
        # TensorBoard mirror (viewer-consumable sink, VERDICT r2 missing
        # #4): scalar metrics land in <stats_path>/tb as tfevents records.
        # Disable with STRATANET2_NO_TENSORBOARD=1.
        if not os.environ.get("STRATANET2_NO_TENSORBOARD"):
            from stratanet2_tpu_torch.utils.tboard import EventFileWriter

            self._tb = EventFileWriter(os.path.join(self.stats_path, "tb"))

    @contextmanager
    def context(self, name: str):
        prev, self._context = self._context, name
        try:
            yield self
        finally:
            self._context = prev

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def log_metric(self, name: str, value, epoch: Optional[int] = None, step: Optional[int] = None):
        self.log_metrics({name: value}, epoch=epoch, step=step)

    def log_metrics(self, metrics: Dict[str, Any], epoch: Optional[int] = None, step: Optional[int] = None):
        rec = {
            "t": time.time(),
            "context": self._context,
            "epoch": self.epoch if epoch is None else epoch,
            "step": step,
            "metrics": {k: _jsonable(v) for k, v in metrics.items()},
        }
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            pre = (self._context + "/") if self._context else ""
            step_v = rec["step"] if rec["step"] is not None else rec["epoch"]
            for k, v in rec["metrics"].items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(pre + k, v, step_v or 0)

    def log_histogram(
        self, name: str, values, epoch: Optional[int] = None,
        step: Optional[int] = None, bins=20,
    ):
        """Histogram: JSONL record of binned counts + a TensorBoard
        histogram summary (reference Comet log_histogram_3d). Pass explicit
        bin edges via `bins` when records must be comparable across
        folds/runs — the default int form bins over the per-call data range."""
        import numpy as np

        v = np.asarray(values, dtype=float).ravel()
        v = v[np.isfinite(v)]
        counts, edges = np.histogram(v, bins=bins)
        self.log_metrics(
            {
                f"{name}_hist_counts": counts.tolist(),
                f"{name}_hist_bins": edges.tolist(),
            },
            epoch=epoch,
            step=step,
        )
        if self._tb is not None and v.size:
            pre = (self._context + "/") if self._context else ""
            sv = step if step is not None else (epoch or 0)
            # same binning as the JSONL record (single computation)
            self._tb.add_histogram(
                pre + name, v, sv or 0, counts=counts, edges=edges
            )

    def log_parameters(self, params: Dict[str, Any]):
        with open(os.path.join(self.stats_path, "params.json"), "w") as f:
            json.dump({k: _jsonable(v) for k, v in params.items()}, f, indent=2, default=str)

    def log_image(self, path: str, **_kw):
        self.log_metrics({"image": path})

    def log_table(self, path: str, **_kw):
        self.log_metrics({"table": path})

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class NullSink:
    """A MetricSink that writes nothing: the sink of a rank other than 0,
    which computes with the group but leaves every file to rank 0."""

    epoch: int = 0

    @contextmanager
    def context(self, name: str):
        yield self

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def log_metric(self, *args, **kwargs):
        pass

    log_metrics = log_histogram = log_parameters = log_image = log_table = log_metric

    def close(self):
        pass


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except Exception:
            return str(v)
