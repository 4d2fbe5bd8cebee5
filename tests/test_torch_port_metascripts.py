"""The port's metascripts (`stratanet2_tpu_torch/metascripts/`) against the
JAX package's on the same seeded result CSVs: the benchmark CSV and frame,
`format_cols`, the predictions analysis (its returned dict and the files
it writes) and the quantification-error study (its per-class errors and
both tables). The port reads its own `learning/metrics.py`; the outputs
must be equal (frames with `pandas.testing.assert_frame_equal`'s exact
comparison, floats bit for bit).

Without matplotlib (the card's machine has none), the quantification study
skips its figure with a warning and the predictions analysis skips its
confusion matrices with a warning; JAX's stop with an ImportError."""

import logging
import os
import sys

import numpy as np
import pandas as pd
import pytest

from stratanet2_tpu.learning import metrics as JM
from stratanet2_tpu.metascripts import benchmark_all_models as jbench
from stratanet2_tpu.metascripts import predictions_analysis as janalysis
from stratanet2_tpu.metascripts import quantification_errors as jquant
from stratanet2_tpu_torch.metascripts import benchmark_all_models as bench
from stratanet2_tpu_torch.metascripts import predictions_analysis as analysis
from stratanet2_tpu_torch.learning import metrics as PM
from stratanet2_tpu_torch.metascripts import quantification_errors as quant


def _results(seed: int, n: int = 60, continuous: bool = False) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    gt = {f"vt_{s}": (rng.uniform(0, 1, n) if continuous
                      else JM.closest_class_center(rng.uniform(0, 1, n))) for s in JM.STRATA}
    return pd.DataFrame({"pl_id": [f"p{i}" for i in range(n)],
                         **{f"pred_{s}": rng.uniform(0, 1, n) for s in JM.STRATA}, **gt})


@pytest.fixture
def matrices_as_text(monkeypatch):
    """Both packages write each confusion matrix as text where they would
    draw its PNG (the drawing is matplotlib's, and 36 of them a run take
    seconds), so that the files compare the matrices themselves."""
    def write(cm, out_path, title=""):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        np.savetxt(out_path, cm, header=title)

    for mod in (JM, PM):
        monkeypatch.setattr(mod, "save_confusion_matrix_png", write)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_benchmark_matches_jax(tmp_path):
    """Two runs' CSVs and a DEV one (skipped by both): equal frames and
    equal benchmark files."""
    for i, mode in enumerate(("PROD", "PROD", "DEV")):
        d = tmp_path / "experiments" / mode / f"run{i}"
        d.mkdir(parents=True)
        _results(i).to_csv(d / "PCC_inference_all_placettes_summary.csv", index=False)
    pattern = str(tmp_path / "experiments/**/*placettes*.csv")
    got = bench.main(["--results_files_lookup_expression", pattern,
                      "--benchmark_file_path", str(tmp_path / "port.csv")])
    want = jbench.benchmark(pattern, str(tmp_path / "jax.csv"))
    assert len(got) == 2
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


@pytest.mark.parametrize("kind", ["percent", "ratio", "mixed"])
def test_format_cols_matches_jax(kind):
    df = pd.DataFrame({
        "nom": ["a", "b", "c"],
        "COUV BASSE": [50, 75, 0] if kind == "percent" else [0.5, 0.75, 0.0],
        "COUV INTER": [10, 0, 25] if kind == "percent" else [0.1, 0.0, 0.25],
        "COUV HAUTE": [90, 100, 33] if kind == "percent" else [0.9, 1.0, 0.33],
        "couverture basse calibree": ["50%", "75%", "1%"] if kind != "ratio" else [0.5, 0.75, 0.01],
        "couverture inter calibree": ["10%", "0%", "20%"] if kind == "percent" else [0.1, 0.0, 0.2],
        "Taux de couverture haute lidar": ["90%", "100%", "30%"] if kind == "percent"
        else [0.9, 1.0, 0.3],
    })
    pd.testing.assert_frame_equal(bench.format_cols(df), jbench.format_cols(df), check_exact=True)


@pytest.mark.parametrize("gt", ["classes", "continuous"])
def test_predictions_analysis_matches_jax(tmp_path, gt, matrices_as_text):
    """Class-centre ground truths (indicators, pearson r, the margin study
    and the forest subsets) and continuous ones (confusion matrices only):
    the same dict and the same files, each confusion matrix equal."""
    df = _results(7, continuous=gt == "continuous")
    path = str(tmp_path / "results.csv")
    df.to_csv(path, index=False)
    got = analysis.main(["--results_file", path, "--out_dir", str(tmp_path / "port")])
    want = janalysis.analyse(path, str(tmp_path / "jax"))
    assert got == want and got["n"] == 60
    assert ("pearson_r" in got) == (gt == "classes")
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax") and len(names) == (36 if gt == "classes" else 9)
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_predictions_analysis_without_figures(tmp_path, monkeypatch, caplog):
    """With sklearn and matplotlib blocked the confusion matrices are
    skipped with a warning and the analysis returns JAX's dict."""
    path = str(tmp_path / "results.csv")
    _results(8).to_csv(path, index=False)
    monkeypatch.setattr(JM, "log_confusion_matrices", lambda *args, **kw: None)
    want = janalysis.analyse(path, str(tmp_path / "jax"))
    for mod in ("matplotlib", "sklearn"):
        monkeypatch.setitem(sys.modules, mod, None)
    with caplog.at_level(logging.WARNING, logger="stratanet2_tpu_torch"):
        got = analysis.analyse(path, str(tmp_path / "port"))
    assert got == want
    assert _files(tmp_path / "port") == []
    assert sum("confusion matrices" in r.message for r in caplog.records) == 4


def test_quantification_study_matches_jax(tmp_path):
    """Per-class errors under the uniform hypothesis (with a result file's
    class-centre ground truths), the P(|e| > t) table and the expected
    errors under Gaussian measurement noise: equal."""
    df = _results(9)
    assert quant.study_quantification_error_1(df) == jquant.study_quantification_error_1(df)
    pd.testing.assert_frame_equal(quant.describe_possible_measurement_error_distribution(),
                                  jquant.describe_possible_measurement_error_distribution(),
                                  check_exact=True)
    pd.testing.assert_frame_equal(quant.all_expected_errors(stdev_list=(1e-7, 10)),
                                  jquant.all_expected_errors(stdev_list=(1e-7, 10)),
                                  check_exact=True)


def test_quantification_main_without_matplotlib(tmp_path, monkeypatch, caplog):
    """`main` asks for the figure; with matplotlib blocked it is skipped
    with a warning and both tables are written, equal to JAX's `main`'s
    (run with matplotlib, which also writes the figure)."""
    path = str(tmp_path / "results.csv")
    _results(10).to_csv(path, index=False)
    jquant.main(["--results_file", path, "--out_dir", str(tmp_path / "jax")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING, logger="stratanet2_tpu_torch"):
        quant.main(["--results_file", path, "--out_dir", str(tmp_path / "port")])
    assert any("quantification figure" in r.message for r in caplog.records)
    tables = ["expected_errors_under_gaussian_msrt_error.csv", "msrt_error_description.csv"]
    assert _files(tmp_path / "port") == tables
    assert _files(tmp_path / "jax") == tables[:1] + ["msrt_error_description.csv",
                                                     "quantification_error_1.png"]
    for name in tables:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
