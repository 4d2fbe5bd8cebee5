"""The port's training loop on its parallel paths, on 2 gloo ranks on the
CPU: `train_full` data-parallel (the device-resident epoch, and the host
loader's), point-sharded, and point-sharded on a geometry it cannot shard
(the fallback of JAX's `test_train_full_ineligible_falls_back_to_standard`,
with a data-parallel mesh passed).

JAX's point-sharded `train_full` shards over every visible device (8 in
this process), so the 2-rank runs are held to the port's single-process
`train_full`, which tests/test_torch_port_loop.py holds to JAX's: every
epoch's train and eval loss parts within LOOP_RTOL = 3e-3 (JAX's own
sharded-against-plain bound, test_point_sharded.py: Adam's first update
takes the sign of each gradient, and a gradient within rounding of 0 may
take another sign on another summation order). The single-process run of
the point-sharded comparison uses `fps_parts` = 2, the geometry at which
the sharded forward equals the unsharded one.

Each run's ranks return the same losses, BN state and params bit for bit,
and one set of files is written, by rank 0: the checkpoint, the resume
checkpoint and the metrics, with as many metric records as the
single-process run writes. Both sides run without matplotlib (the ranks
through `no_figures`): the figures are not what is tested here.
"""

import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
from stratanet2_tpu_torch.learning.train import train_full
from stratanet2_tpu_torch.parallel.launch import run_ranks
from stratanet2_tpu_torch.utils.experiment import MetricSink
from synthetic import make_plot_dataset
from test_torch_port_parallel import RANKS_TIMEOUT, no_figures

torch.set_num_threads(1)

LOOP_RTOL = 3e-3
LOSS_KEYS = ("total_loss", "MAE_loss", "log_loss")


def loop_config(n=256, device_resident="true", fps_parts=2):
    """DEV at N=n, k 8/16, batch 4, 2 epochs; confusion matrices at the
    last eval only (the figures are rank 0's and not what is tested)."""
    cfg = Config().as_dev()
    return replace(
        cfg, log_confusion_matrix_frequency=0,
        model=replace(cfg.model, subsample_size=n, k1=8, k2=16, fps_parts=fps_parts,
                      fps_min_part_samples=1),
        train=replace(cfg.train, batch_size=4, n_epoch=2, n_epoch_test=1),
        data=replace(cfg.data, device_resident=device_resident),
    )


RUNS = {  # name: (config, data-parallel mesh, point_sharded)
    "dp_device": (loop_config(), True, False),
    "dp_host": (loop_config(device_resident="false"), True, False),
    "point_sharded": (loop_config(device_resident="false"), False, True),
    "ineligible": (loop_config(n=255), True, True),
}


@pytest.fixture(scope="module")
def setup():
    ds = make_plot_dataset(np.random.default_rng(31), n_plots=10, n_points=300)
    ids = sorted(ds)
    kde = fit_kde_mixture_from_dataset(ds)
    return dict(ds=ds, train=ids[:8], val=ids[8:], kde=kde)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    cases = [(name, "train_full", dict(
        dataset=setup["ds"], train_ids=setup["train"], val_ids=setup["val"], cfg=cfg,
        kde_grid=setup["kde"].grid, kde_pdfs=setup["kde"].pdfs, stats_path=str(root / name),
        data_parallel=dp, point_sharded=ps)) for name, (cfg, dp, ps) in RUNS.items()]
    with pytest.MonkeyPatch.context() as mp:
        no_figures(mp, root)
        out = run_ranks(2, "stratanet2_tpu_torch.parallel.dryrun:run_cases", cases,
                        backend="gloo", device="cpu", timeout=RANKS_TIMEOUT,
                        workdir=str(root / "ranks"))
    return dict(root=root, out=out)


@pytest.fixture(scope="module")
def single(setup, tmp_path_factory):
    """The port's single-process runs of the same configs."""
    root = tmp_path_factory.mktemp("single")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        for name, (cfg, _dp, _ps) in RUNS.items():
            stats = root / name
            stats.mkdir()
            sink = MetricSink(str(stats))
            _, tr, te, _ = train_full(setup["ds"], np.asarray(setup["train"]),
                                      np.asarray(setup["val"]), cfg, setup["kde"], str(stats),
                                      sink, fold_id=1, device="cpu")
            sink.close()
            out[name] = dict(train=tr, test=te, root=stats)
    return out


def _records(stats):
    with open(os.path.join(stats, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", list(RUNS))
def test_train_full_on_two_ranks(ranks, single, name):
    """Loss parts of every epoch against the single-process run within
    LOOP_RTOL; the same lists, BN state and params on both ranks; one set
    of files, rank 0's."""
    r0, r1 = (o[name] for o in ranks["out"])
    ref = single[name]
    assert len(r0["train"]) == len(ref["train"]) and len(r0["test"]) == len(ref["test"])
    for got, want in zip(r0["train"] + r0["test"], ref["train"] + ref["test"]):
        for k in LOSS_KEYS:
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], want[k], rtol=LOOP_RTOL, err_msg=k)
    timing = ("points_per_sec", "epoch_seconds")
    for a, b in zip(r0["train"] + r0["test"], r1["train"] + r1["test"]):
        assert {k: v for k, v in a.items() if k not in timing} == \
            {k: v for k, v in b.items() if k not in timing}
    for tree in ("params", "state"):
        for layer in r0[tree]:
            a, b = r0[tree][layer], r1[tree][layer]
            assert json.dumps(a, default=lambda v: v.tobytes().hex()) == \
                json.dumps(b, default=lambda v: v.tobytes().hex()), (tree, layer)
    stats = ranks["root"] / name
    assert {"PCC_model_fold_n=1.pt", "PCC_model_fold_n=1.pt.resume", "metrics.jsonl"} <= \
        set(os.listdir(stats))
    assert len(_records(stats)) == len(_records(ref["root"]))


def test_paths_and_fallback_are_logged(ranks):
    """The point-sharded run shards (no warning); the ineligible request
    falls back to the standard path with JAX's warning, naming the
    divisibility and the data-parallel mesh, on both ranks. (Rank 0's
    warnings that a figure was skipped, matplotlib being hidden, are not
    counted.)"""
    for out in ranks["out"]:
        paths = {name: [w for w in out[name]["warnings"] if "matplotlib" not in w]
                 for name in ("point_sharded", "ineligible")}
        assert paths["point_sharded"] == []
        (msg,) = paths["ineligible"]
        assert msg.startswith("point-sharded training unavailable")
        assert "divisible by 2 devices" in msg and "data-parallel over 2 devices" in msg
        assert len(out["ineligible"]["train"]) == 2
