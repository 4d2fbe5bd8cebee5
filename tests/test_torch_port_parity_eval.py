"""`scripts/torch_parity_eval.py` on the CPU against `scripts/parity_eval.py`:
one synthetic LAS tree (6 plots of 700 points, class-centre ground truth,
written with the port's writers) and one seeded reference-layout checkpoint
saved as the reference saves it (`{"state_dict": ..., "best_metric_epoch":
...}`); the per-stratum MAEs, `MAE_loss`, `total_loss` and every indicator
column within 1e-5 of JAX's. matplotlib is hidden from both (their figures
are skipped with a warning). Also: a missing checkpoint key raises, the
indicator families are skipped with a reason where pandas does not import,
and continuous ground truth skips the class families with a log line."""

import contextlib
import importlib.util
import io
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils.reference_oracle import make_reference_state_dict

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
CLASSES = (0, 10, 25, 33, 50, 75, 90, 100)
MAE_KEYS = ("MAE_veg_b", "MAE_veg_moy", "MAE_veg_h", "MAE_loss", "total_loss")


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_tree(root: Path, sd, n_plots=6, n_points=700):
    """Plot LAS files, their GT csv and a checkpoint of `sd` under `root`;
    the parity flags over them (DEV, subsample 512, batch 4)."""
    from stratanet2_tpu_torch.data import las
    from stratanet2_tpu_torch.utils.synthetic import cloud_to_las_fields, make_plot_cloud

    rng = np.random.default_rng(5)
    las_dir = root / "las"
    las_dir.mkdir(parents=True)
    lines = ["nom,COUV_BASSE,COUV_INTER,COUV_HAUTE"]
    for i in range(n_plots):
        c = make_plot_cloud(rng, n=n_points, center=(1000 + 40 * i, 2000))
        las.write_las(str(las_dir / f"Plot_{i:02d}.las"), cloud_to_las_fields(c))
        lines.append(",".join([f"Plot_{i:02d}"] + [str(int(v)) for v in rng.choice(CLASSES, 3)]))
    gt = root / "gt.csv"
    gt.write_text("\n".join(lines) + "\n")
    ckpt = root / "PCC_model_fold_n=1.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()},
                "best_metric_epoch": 3, "best_metric_value": 0.1}, ckpt)
    return ["--checkpoint", str(ckpt), "--mode", "DEV", "--subsample_size", "512",
            "--batch_size", "4", "--las_plots_folder_path", str(las_dir), "--gt_file_path",
            str(gt), "--corrected_gt_file_path", str(gt), "--plots_pickled_dataset_path",
            str(root / "plots.pkl")]


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """JAX's `main` and the port's (`--device cpu`) on one tree and
    checkpoint, each into its own experiments folder; JAX's means taken
    from its `evaluate`, its indicators from its CSV."""
    import pandas as pd

    import stratanet2_tpu.learning.evaluate as jeval

    root = tmp_path_factory.mktemp("parity")
    args = write_tree(root, make_reference_state_dict(seed=11))
    jax_script, port = load_script("parity_eval"), load_script("torch_parity_eval")
    means = []
    evaluate = jeval.evaluate

    def recording(*a, **k):
        out = evaluate(*a, **k)
        means.append(out[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setattr(jeval, "evaluate", recording)
        with contextlib.redirect_stdout(io.StringIO()):
            jax_script.main([*args, "--experiments_path", str(root / "jax")])
        ck.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = port.main([*args, "--experiments_path", str(root / "port"), "--device", "cpu"])
    jax_csv, = (root / "jax").rglob("parity_eval.csv")
    return dict(want_means=means[0], want_df=pd.read_csv(jax_csv), got=got,
                got_df=pd.read_csv(got["csv"]), printed=out.getvalue(),
                launches=ck.launch_counts(), args=args, root=root)


def test_parity_eval_maes_match_jax(parity_runs):
    """The five means within 1e-5 of JAX's, over the same 6 plots, on the
    CPU (no launch), printed as JAX prints them."""
    got, want = parity_runs["got"], parity_runs["want_means"]
    assert got["plots"] == 6 and got["device"] == "cpu" and got["skipped"] is None
    for key in MAE_KEYS:
        assert np.isfinite(got["means"][key])
        assert abs(got["means"][key] - want[key]) <= 1e-5, key
        assert f"{key:14s} {got['means'][key]:.4f}" in parity_runs["printed"]
    assert not any(parity_runs["launches"].values())
    assert not any(got["launches"].values())


def test_parity_eval_indicators_match_jax(parity_runs):
    """The per-plot CSV: JAX's columns and plots in JAX's order, every
    numeric column within 1e-5 (the class families included: the ground
    truth is class centres); the printed indicator means are its columns'."""
    got, want = parity_runs["got_df"], parity_runs["want_df"]
    assert list(got.columns) == list(want.columns)
    assert list(got["pl_id"]) == list(want["pl_id"])
    assert {"error_all", "acc_all", "error2_all", "acc2_all", "acc3_all"} <= set(got.columns)
    for col in want.columns:
        if col != "pl_id":
            np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float),
                                       rtol=0, atol=1e-5, err_msg=col)
    ind = parity_runs["got"]["indicators"]
    assert set(ind) == {"error_all", "acc_all", "error2_all", "acc2_all"}
    for col, value in ind.items():
        assert value == pytest.approx(float(got[col].mean()), abs=1e-12)
        assert abs(value - float(want[col].mean())) <= 1e-5


def test_parity_eval_refuses_a_checkpoint_without_a_key(parity_runs, tmp_path):
    """A state_dict missing one of the reference's keys raises KeyError, as
    JAX's converter does."""
    port = load_script("torch_parity_eval")
    sd = make_reference_state_dict(seed=11)
    del sd["fp2_module.nn.0.2.running_var"]
    ckpt = tmp_path / "PCC_model_broken.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}}, ckpt)
    args = list(parity_runs["args"])
    args[1] = str(ckpt)
    with pytest.raises(KeyError, match="fp2_module.nn"):
        port.main([*args, "--experiments_path", str(tmp_path / "exp"), "--device", "cpu"])


def test_indicators_skipped_without_pandas_and_for_continuous_gt(parity_runs, monkeypatch,
                                                                   caplog):
    """Continuous ground truth keeps the v1 family and logs the class
    families' skip; without pandas the table is None with the reason."""
    port = load_script("torch_parity_eval")
    summary = [c for c in parity_runs["got_df"].columns if c.startswith(("pl_", "pred_", "vt_"))]
    rows = parity_runs["got_df"][summary].to_dict("records")
    assert len(summary) == 10
    for row in rows:
        row["vt_veg_b"] = 0.123
    logger = logging.getLogger("parity_test")
    with caplog.at_level(logging.INFO, logger="parity_test"):
        df, skipped = port.indicator_table(rows, logger)
    assert skipped is None and "error_all" in df and "error2_all" not in df
    assert "continuous GT: class indicators skipped" in caplog.text
    monkeypatch.setitem(sys.modules, "pandas", None)
    df, skipped = port.indicator_table(rows, logger)
    assert df is None and "pandas" in skipped
