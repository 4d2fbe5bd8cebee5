"""The SSL cycle's pieces on the CPU against the JAX package's.

- `cross_validate` in PROD at 2 folds (so the second fold runs in the same
  process as the first), at `tests/synthetic.tiny_config()` sizes and 2
  epochs, both packages from the same plots and pretrained checkpoint:
  every fold's loss parts in the metric sink, the `train_mean` / `val_mean`
  records across folds and both summary CSVs, within the bounds of
  `test_torch_port_loop.py::test_cross_validate_dev_matches_jax`; and the
  port's fold 2 equal to `train_full` on fold 2's split alone, bit for bit.
- `scripts/torch_ssl_cycle.py`: `build_data` writes the JAX script's files
  byte for byte; the cycle runs on the CPU at `tests/test_ssl_cycle.py`'s
  sizes in PROD at 2 folds and 2 epochs; `cli.main_ssl` refuses an empty
  set of pseudo-labels.
- `scripts/torch_learnability_sweep.py` at one seed and tiny sizes.

matplotlib is hidden from every run here (the figures are skipped with a
warning; `test_torch_port_loop.py` holds the figures' files)."""

import importlib.util
import json
import os
import pickle
import sys
from dataclasses import replace
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU before the JAX package's modules)
import numpy as np
import pandas as pd
import pytest
import torch

from stratanet2_tpu.learning import crossval as jcrossval
from stratanet2_tpu.utils.experiment import MetricSink as JaxSink
from stratanet2_tpu_torch.data.dataset import get_index_sorted_plot_ids
from stratanet2_tpu_torch.learning import crossval, train
from stratanet2_tpu_torch.learning.evaluate import LOSS_KEYS
from stratanet2_tpu_torch.utils.experiment import MetricSink
from test_torch_port_loop import LOSS_ATOL, PRED_ATOL, port_config, setup  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
FOLDS = 2
# tests/test_ssl_cycle.py's sizes, in PROD at 2 folds and 2 epochs
CYCLE = ["--mode", "PROD", "--n_plots", "10", "--n_parcels", "1", "--points", "1200",
         "--subsample_size", "512", "--batch_size", "4", "--folds", "2", "--epochs", "2",
         "--ssl_epochs", "2", "--device", "cpu"]
STAGES = ("data", "cold_crossval", "cold_result", "prepare", "pseudo_label", "ssl_pretrain",
          "warm_crossval", "summary")


def load_script(name):
    """`scripts/<name>.py` loaded by path as a module."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cycle = load_script("torch_ssl_cycle")
sched = load_script("torch_prod_schedule_run")
sweep = load_script("torch_learnability_sweep")


@pytest.fixture
def two_threads():
    """Two torch threads for this test (the tests run several workers)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def no_figures(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def records(stats_dir):
    """The metric sink's records of a run folder, by context: [(epoch,
    step, metrics)]."""
    out = {}
    with open(os.path.join(stats_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["context"], []).append((rec["epoch"], rec["step"],
                                                       rec["metrics"]))
    return out


# ---------------------------------------------------------------------------
# cross_validate at 2 folds against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cv_runs(setup, tmp_path_factory):
    """Both packages' `cross_validate` in PROD at 2 folds (2 epochs, an eval
    each, early stopping on), from the same plots and pretrained
    checkpoint, and the port's fold 2 trained alone."""
    jcfg = replace(setup["jcfg"], mode="PROD",
                   train=replace(setup["jcfg"].train, folds=FOLDS, use_early_stopping=True))
    pcfg = port_config(jcfg)
    pcfg = replace(pcfg, mode="PROD",
                   train=replace(pcfg.train, folds=FOLDS),
                   data=replace(pcfg.data, gt_file_path=jcfg.data.gt_file_path))
    root = tmp_path_factory.mktemp("cv2")
    out = {"jdir": root / "jax", "pdir": root / "port", "alone": root / "alone"}
    for d in out.values():
        d.mkdir()
    out["folds"] = []  # the port's folds, with their loss dicts (the cycle's fold hook)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        jsink, psink = JaxSink(str(out["jdir"])), MetricSink(str(out["pdir"]))
        try:
            out["want"] = jcrossval.cross_validate(
                setup["ds"], jcfg, setup["jkde"], str(out["jdir"]), jsink,
                pretrained_path=setup["pretrained"])
            with cycle.fold_lines("cv", cycle.Card(torch.device("cpu")), out["folds"]):
                out["got"] = crossval.cross_validate(
                    setup["ds"], pcfg, setup["kde"], str(out["pdir"]), psink,
                    pretrained_path=setup["pretrained"], device="cpu")
        finally:
            jsink.close()
            psink.close()
        ids = get_index_sorted_plot_ids(setup["ds"])
        train_idx, val_idx = crossval.kfold_split(len(ids), FOLDS)[1]
        sink = MetricSink(str(out["alone"]))
        try:
            _, out["alone_train"], out["alone_test"], _ = train.train_full(
                setup["ds"], ids[train_idx], ids[val_idx], pcfg, setup["kde"],
                str(out["alone"]), sink, fold_id=2, pretrained_path=setup["pretrained"],
                seed=pcfg.train.seed, device="cpu")
        finally:
            sink.close()
    return out


def test_cross_validate_two_folds_loss_records_match_jax(cv_runs):
    """Each fold's train and eval loss parts, epochs and steps in the metric
    sink, and the per-step means across folds (`train_mean`, `val_mean`),
    within the loop tests' LOSS_ATOL."""
    want, got = records(cv_runs["jdir"]), records(cv_runs["pdir"])
    contexts = [f"fold_{f}_{part}" for f in range(1, FOLDS + 1) for part in ("train", "val")]
    contexts += ["train_mean", "val_mean"]
    assert set(contexts) <= set(want)
    for context in contexts:
        w, g = want[context], got[context]
        assert [(e, s) for e, s, _ in g] == [(e, s) for e, s, _ in w], context
        keys = train.TRAIN_LOSS_KEYS if context.endswith("train") else LOSS_KEYS
        for (_, _, gm), (_, _, wm) in zip(g, w):
            for k in keys:
                if k in wm:
                    assert np.isfinite(gm[k]), (context, k)
                    np.testing.assert_allclose(gm[k], wm[k], rtol=0, atol=LOSS_ATOL,
                                               err_msg=f"{context} {k}")
    # both folds trained: 2 epochs each and an eval after each
    assert [e for e, _, _ in got["fold_2_train"]] == [1, 2]
    assert len([m for _, _, m in got["fold_2_val"] if "total_loss" in m]) == 2
    assert crossval.train_full is train.train_full  # the fold hook is gone
    assert [(f["of"], f["fold"], f["epochs_run"]) for f in cv_runs["folds"]] == [
        ("cv", 1, 2), ("cv", 2, 2)]


def test_cross_validate_two_folds_summaries_match_jax(cv_runs):
    """The relabelled summary frame over both folds' plots, and both summary
    CSVs, within PRED_ATOL, with the same columns."""
    want, got = cv_runs["want"], cv_runs["got"]
    assert list(got.columns) == list(want.columns) and len(got) == len(want) == 10
    assert sorted(set(got["fold_id"])) == [1, 2]
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=0, atol=PRED_ATOL, err_msg=col)
        else:
            assert list(got[col]) == list(want[col]), col
    jdir, pdir = cv_runs["jdir"], cv_runs["pdir"]
    csvs = sorted(f for f in os.listdir(jdir) if f.endswith(".csv"))
    assert csvs == sorted(f for f in os.listdir(pdir) if f.endswith(".csv")) == [
        "PCC_inference_all_placettes_relabeled_summary.csv",
        "PCC_inference_all_placettes_summary.csv"]
    for name in csvs:
        w, g = pd.read_csv(jdir / name), pd.read_csv(pdir / name)
        assert list(g.columns) == list(w.columns) and len(g) == len(w)
        for col in w.columns:
            if w[col].dtype.kind == "f":
                np.testing.assert_allclose(g[col], w[col], rtol=0, atol=PRED_ATOL,
                                           err_msg=f"{name} {col}")
            else:
                assert list(g[col]) == list(w[col]), f"{name} {col}"


def test_second_fold_equals_the_fold_trained_alone(cv_runs):
    """Fold 2 of the port's cross-validation, after fold 1 in the same
    process, against `train_full` on fold 2's split alone: both checkpoints
    (params, BN buffers, Adam state, metadata) and every epoch's and eval's
    loss parts, bit for bit."""
    cmp = sched.compare_checkpoints(str(cv_runs["pdir"]), str(cv_runs["alone"]), 2)
    assert cmp["tensors"] > 100 and cmp["differing_tensors"] == 0, cmp
    assert cmp["max_abs_diff"] == 0.0 and cmp["metadata_equal"]
    fold2 = cv_runs["folds"][1]
    assert len(fold2["test"]) == len(cv_runs["alone_test"]) == 3  # two evals, the final one
    assert [d["epoch"] for d in fold2["train"]] == [d["epoch"] for d in cv_runs["alone_train"]]
    diffs = sched.loss_differences(fold2["train"], cv_runs["alone_train"], fold2["test"],
                                   cv_runs["alone_test"])
    assert len(diffs) == 2 * 5 + 3 * (len(LOSS_KEYS) + 1)
    assert max(diffs) == 0.0


# ---------------------------------------------------------------------------
# scripts/torch_ssl_cycle.py
# ---------------------------------------------------------------------------


def test_build_data_writes_the_jax_scripts_files(tmp_path):
    """The plot LAS files, the GT CSV, the parcels' LAS and the shapefile
    (.shp, .shx, .dbf) byte for byte the JAX script's for one seed."""
    jax_cycle = load_script("ssl_cycle")
    want, got = tmp_path / "jax", tmp_path / "port"
    jax_cycle.build_data(str(want), 3, 600, 2, 5)
    cycle.build_data(str(got), 3, 600, 2, 5)

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    names = files(want)
    assert names == files(got)
    assert {Path(n).suffix for n in names} == {".las", ".csv", ".shp", ".shx", ".dbf"}
    assert len([n for n in names if n.endswith(".las")]) == 3 + 2
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_cycle_runs_on_the_cpu(tmp_path, capsys, no_figures, two_threads):
    """The five stages in PROD at 2 folds: a line each with its launches
    (all 0: the plain versions run) and graphs, a line a fold of both
    cross-validations, the run folders' artifacts, pseudo-labels, and the
    summary with the JAX script's keys and both MAEs in (0, 1)."""
    root = tmp_path / "cycle"
    result = cycle.main(["--root", str(root), *CYCLE])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    stages = {x["stage"]: x for x in lines if "stage" in x}
    assert set(STAGES) <= set(stages)
    for name in ("cold_crossval", "prepare", "pseudo_label", "ssl_pretrain", "warm_crossval"):
        line = stages[name]
        assert line == result["stages"][name] and line["wall_s"] > 0
        assert set(line["launches"].values()) == {0} and set(line["graphs"]) == {
            "captures", "replays"}
        assert line["peak_allocated_mb"] is None  # the CPU
    folds = [x for x in lines if x.get("stage") == "fold"]
    assert [(f["of"], f["fold"]) for f in folds] == [
        ("cold_crossval", 1), ("cold_crossval", 2), ("warm_crossval", 1), ("warm_crossval", 2)]
    for f in folds:
        assert f["epochs_run"] == 2 and f["seconds"] > 0 and f["allocated_mb"] is None
        assert 0 < f["baseline_MAE"] < 1 and 0 < f["val_MAE"] < 1

    s = stages["summary"]
    jax_keys = {"stage", "mode", "cold_val_MAE", "warm_val_MAE", "warm_minus_cold", "wall_s"}
    assert jax_keys <= set(s) and s["mode"] == "PROD"
    assert 0.0 < s["cold_val_MAE"] < 1.0 and 0.0 < s["warm_val_MAE"] < 1.0
    assert s["warm_minus_cold"] == pytest.approx(s["warm_val_MAE"] - s["cold_val_MAE"])
    assert s["pseudo_labels"] == stages["pseudo_label"]["pseudo_labels"] > 0

    model_id = stages["cold_result"]["model_id"]
    pl_dir = root / "parcelles_dataset_20m" / "pseudo_labelling" / model_id
    assert any(p.suffix == ".pkl" for p in pl_dir.iterdir())
    cold = Path(result["cold_path"])
    for name in ("PCC_model_fold_n=1.pt", "PCC_model_fold_n=2.pt",
                 "PCC_inference_all_placettes_summary.csv"):
        assert (cold / name).exists(), name
    assert list((root / "experiments" / "pretraining" / "PROD").glob("*/PCC_model_full.pt"))
    with open(Path(result["warm_path"]) / "stats.txt") as f:
        assert "Warm-starting from pretrained model" in f.read()


def test_main_ssl_refuses_an_empty_pseudo_label_set(tmp_path):
    """`main_ssl` on a model whose pseudo-labelling kept no plot exits with
    a message instead of training on nothing."""
    from stratanet2_tpu_torch.cli import main_ssl

    parcels = tmp_path / "parcels"
    folder = parcels / "pseudo_labelling" / "MODEL"
    folder.mkdir(parents=True)
    with open(folder / "PARCEL_000.pkl", "wb") as f:
        pickle.dump({}, f)
    with pytest.raises(SystemExit, match="No pseudo-labelled plots of model MODEL"):
        main_ssl.main(["--device", "cpu", "--inference_model_id", "MODEL",
                       "--las_parcels_folder_path", str(parcels),
                       "--experiments_path", str(tmp_path / "experiments")])


# ---------------------------------------------------------------------------
# scripts/torch_learnability_sweep.py
# ---------------------------------------------------------------------------


def test_sweep_variants_are_the_jax_scripts():
    assert sweep.variants(None) == ("policy", [({"ball_query_method": "grouped"}, "grouped"),
                                               ({"ball_query_method": "nearest"}, "nearest")])
    assert sweep.variants([2, 4]) == ("fps_parts", [({"fps_parts": 2}, 2),
                                                    ({"fps_parts": 4}, 4)])


def test_sweep_runs_on_the_cpu(tmp_path, capsys, no_figures, two_threads):
    """One seed at both policies at a tiny size: a summary a run (the
    check's keys, `passed`, launches all 0 on the CPU), appended to
    `--out`, and a `SWEEP_SUMMARY` a policy with the JAX script's keys."""
    out = tmp_path / "sweep.jsonl"
    runs, summaries = sweep.main(["--device", "cpu", "--seeds", "0", "--epochs", "2",
                                  "--n_plots", "10", "--subsample_size", "256",
                                  "--out", str(out)])
    assert [(r["seed"], r["policy"]) for r in runs] == [(0, "grouped"), (0, "nearest")]
    for r in runs:
        assert r["passed"] is (r["val_MAE"] < r["baseline_MAE"])
        assert set(r["launches"].values()) == {0} and r["device"] == "cpu"
        assert r["epochs"] == 2 and r["n_plots"] == 10
    assert [json.loads(x) for x in out.read_text().splitlines()] == runs
    printed = [json.loads(x.split(" ", 1)[1]) for x in capsys.readouterr().out.splitlines()
               if x.startswith("SWEEP_SUMMARY ")]
    assert printed == summaries and [s["policy"] for s in summaries] == ["grouped", "nearest"]
    jax_keys = {"policy", "n_runs", "val_MAE_mean", "val_MAE_std", "baseline_MAE_mean"}
    for s in summaries:
        assert jax_keys <= set(s) and s["n_runs"] == 1 and s["val_MAE_std"] == 0.0
