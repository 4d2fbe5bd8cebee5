"""The port's four CLIs (`stratanet2_tpu_torch/cli/`) on the CPU
(`--device cpu`), on the synthetic tree of `tests/test_cli.py::data_tree`
at its sizes (10 plots of 500 points, N=256, batch 4, DEV):

- `config.parse_config` gives JAX's Config on every field both packages'
  configs have, for a set of command lines that sets every flag;
- the pipeline of `tests/test_cli.py::TestPipeline` with the port's CLIs:
  train -> prepare -> predict inference -> predict pseudo_labelling -> SSL
  pretraining -> a warm-started cross-validation, with the same artifacts;
  its training asks for `--point_sharded` in one process and gets JAX's
  warning and the standard path;
- the training CLI with `--point_sharded` on two gloo ranks;
- on copies of the parcel folder: both packages' prepare CLIs write equal
  pickles bit for bit, and both packages' predict CLIs, from one checkpoint
  written by the port's training CLI, write parcel tifs and PRED_* fields
  within PREDICT_ATOL;
- the probes of the verify recipe (a missing model id, a second predict, an
  empty LAS folder, a parcel with no output) and the card as the default.

Tiling takes scipy's disk query and the numpy min z on both sides: this
file builds no native library.

PREDICT_ATOL = 1e-5: the serve steps of the two packages agree within 2e-5
on a batch's rasters (tests/test_torch_port_predict.py); the merged tif
and the band means of the shapefile are averages of them.
"""

import logging
import os
import pickle
import shutil
from dataclasses import fields, is_dataclass

import numpy as np
import pytest
import torch

from stratanet2_tpu import config as jconfig
from stratanet2_tpu.data import native as jnative
from stratanet2_tpu_torch import config
from stratanet2_tpu_torch.cli import main as cli_main
from stratanet2_tpu_torch.cli import main_ssl as cli_ssl
from stratanet2_tpu_torch.cli import predict as cli_predict
from stratanet2_tpu_torch.cli import prepare as cli_prepare
from stratanet2_tpu_torch.data import native
from stratanet2_tpu_torch.inference.geotiff import read_geotiff
from stratanet2_tpu_torch.inference.shapefile_io import read_shapefile
from stratanet2_tpu_torch.parallel.launch import run_ranks
from test_cli import _common_args, data_tree  # noqa: F401 (the JAX CLI test's tree)
from test_torch_port_parallel import no_figures

torch.set_num_threads(1)

PREDICT_ATOL = 1e-5
PARCEL = "parcelles_dataset_20m"


@pytest.fixture(scope="module", autouse=True)
def numpy_paths():
    """scipy's disk query and numpy's min z on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(jnative, "available", lambda: False)
        yield


def args_for(root, exp_dir, parcels=None):
    """`tests/test_cli.py`'s command line on the CPU, with the parcel
    folder `parcels` (a copy under `root`) where given."""
    args = _common_args(root, exp_dir) + ["--device", "cpu"]
    if parcels is not None:
        args[args.index("--las_parcels_folder_path") + 1] = str(root / parcels)
        args[args.index("--parcel_shapefile_path") + 1] = str(
            root / parcels / "input" / "parcels.shp")
    return args


def jax_args(args):
    """A command line for the JAX package's CLIs, which have no --device
    (their parser would read it as an abbreviation of --device_resident)."""
    i = args.index("--device")
    return args[:i] + args[i + 2:]


# ---------------------------------------------------------------------------
# the flag parser
# ---------------------------------------------------------------------------

ARGVS = {
    "prod_defaults": [],
    "dev": ["--mode", "DEV"],
    "train_flags": ["--mode", "DEV", "--n_epoch", "5", "--n_epoch_test", "2",
                    "--epoch_to_start_early_stop", "3", "--patience_in_epochs", "4",
                    "--use_early_stopping", "--lr", "0.01", "--lr_decay", "0.9",
                    "--step_size", "2", "--wd", "0.1", "--batch_size", "8", "--folds", "3",
                    "--m", "0.2", "--e", "0.3"],
    "paths": ["--data_path", "d", "--las_plots_folder_path", "d/las",
              "--gt_file_path", "d/gt.csv", "--corrected_gt_file_path", "d/gt2.csv",
              "--las_parcels_folder_path", "d/parcels", "--parcel_shapefile_path", "d/p.shp",
              "--plots_pickled_dataset_path", "d/plots.pkl", "--experiments_path", "exp"],
    "model_and_outputs": ["--subsample_size", "2048", "--diam_pix", "32", "--diam_meters",
                          "16", "--plot_geotiff_file", "--log_embeddings", "--use_pallas",
                          "false"],
    "data_flags": ["--mode", "PROD", "--device_resident", "false", "--predict_chain", "1",
                   "--keep_plot_tiffs", "--min_points_for_pseudo_labelling", "500",
                   "--transfer_dtype", "float16"],
    "device_resident_true": ["--device_resident", "true"],
    "namespace_only": ["--mode", "DEV", "--point_sharded",
                       "--PT_model_id", "pt", "--inference_model_id", "inf", "--device", "cpu",
                       "--task", "inference"],
}


def _shared_fields(got, want, path="cfg"):
    """[(path, port value, JAX value)] over the fields both dataclasses have."""
    out = []
    names = {f.name for f in fields(want)}
    for f in fields(got):
        if f.name not in names:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if is_dataclass(g):
            out += _shared_fields(g, w, f"{path}.{f.name}")
        else:
            out.append((f"{path}.{f.name}", g, w))
    return out


@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_config_equals_jax(name):
    argv = ARGVS[name]
    cfg, ns = config.parse_config(argv)
    jcfg, jns = jconfig.parse_config(jax_args(argv) if "--device" in argv else argv)
    shared = _shared_fields(cfg, jcfg)
    assert len(shared) > 50
    for path, g, w in shared:
        assert g == w, path
    for key in vars(jns):  # every JAX flag is accepted, with JAX's value
        assert getattr(ns, key) == getattr(jns, key), key
    assert ns.device == ("cpu" if "--device" in argv else "cuda")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def experiments(data_tree, tmp_path_factory):  # noqa: F811
    return tmp_path_factory.mktemp("experiments")


@pytest.fixture(scope="module")
def trained(data_tree, experiments):  # noqa: F811
    return cli_main.main(args_for(data_tree, experiments) + ["--point_sharded"])


@pytest.fixture(scope="module")
def pipeline(data_tree, experiments, trained):  # noqa: F811
    """prepare -> predict inference -> predict pseudo_labelling (the
    prepared plots' counts raised above its threshold, as test_cli.py does)
    -> SSL -> a warm-started cross-validation, on a copy of the parcel
    folder, which keeps the original for the parity tests."""
    shutil.copytree(data_tree / PARCEL, data_tree / "pipeline")
    args = args_for(data_tree, experiments, "pipeline")
    cli_prepare.main(args)
    prepared = data_tree / "pipeline" / "prepared" / "PARCELA.pkl"
    with open(prepared, "rb") as f:
        plots = pickle.load(f)
    model_id = os.path.basename(trained.rstrip("/"))
    cli_predict.main(args + ["--task", "inference", "--inference_model_id", model_id])
    for v in plots.values():
        v["N_points_in_cloud"] = 3000
    with open(prepared, "wb") as f:
        pickle.dump(plots, f)
    cli_predict.main(args + ["--task", "pseudo_labelling", "--inference_model_id", model_id])
    ssl_path = cli_ssl.main(args + ["--inference_model_id", model_id])
    warm = cli_main.main(args + ["--PT_model_id", os.path.basename(ssl_path.rstrip("/"))])
    return dict(args=args, plots=plots, model_id=model_id, ssl=ssl_path, warm=warm,
                root=data_tree / "pipeline")


def test_training_artifacts(trained):
    import pandas as pd

    assert os.path.exists(os.path.join(trained, "PCC_model_fold_n=1.pt"))
    assert os.path.exists(os.path.join(trained, "PCC_model_fold_n=1.pt.resume"))
    assert os.path.exists(os.path.join(trained, "metrics.jsonl"))
    csvs = [f for f in os.listdir(trained) if f.endswith(".csv")]
    assert any("relabeled_summary" in f for f in csvs)
    assert any(f.endswith("_summary.csv") for f in csvs)
    df = pd.read_csv(os.path.join(trained, "PCC_inference_all_placettes_relabeled_summary.csv"))
    assert {"pred_veg_b", "vt_veg_b", "error_all", "acc2_all"} <= set(df.columns)
    assert len(df) == 2  # fold 1's val plots
    assert os.path.exists(os.path.join(trained, "img/kde_mixture/kde_mixture_x_lim=25.png"))
    with open(os.path.join(trained, "stats.txt")) as f:
        log = f.read()
    assert "Device-resident dataset: 8 plots" in log  # JAX's "auto" choice at this size
    # --use_pallas false takes the unfused SA route, as JAX's flag does
    assert ("SA route: unfused (ball_query_method=grouped, use_pallas=False, "
            "compute_dtype=float32)") in log
    # one process: JAX's refusal of --point_sharded, then the standard path
    assert ("--point_sharded unavailable (needs more than one device); falling back to "
            "data-parallel") in log
    assert "Point-sharded" not in log and "data-parallel mesh" not in log


def test_main_point_sharded_on_two_ranks(data_tree, tmp_path, monkeypatch):  # noqa: F811
    """`main --point_sharded --dist_backend gloo` on two ranks: one run
    folder, made and written by rank 0 (its stats.txt, checkpoints and
    summary CSVs), the point-sharded path taken, and each rank's launches
    logged (all 0 on the CPU). The ranks run without matplotlib
    (`no_figures`): the figures are `test_training_artifacts`' to check."""
    exp = tmp_path / "experiments"
    args = args_for(data_tree, exp) + ["--point_sharded", "--dist_backend", "gloo"]
    no_figures(monkeypatch, tmp_path)
    out = run_ranks(2, "stratanet2_tpu_torch.parallel.dryrun:run_cases",
                    [("cli", "cli", dict(module="main", argv=args))], backend="gloo",
                    device="cpu", timeout=240, workdir=str(tmp_path / "ranks"))
    assert out[0]["cli"] == out[1]["cli"]
    (run,) = os.listdir(exp / "learning" / "DEV")
    stats = exp / "learning" / "DEV" / run
    assert str(stats) == out[0]["cli"].rstrip("/")
    for name in ("PCC_model_fold_n=1.pt", "PCC_model_fold_n=1.pt.resume", "metrics.jsonl",
                 "PCC_inference_all_placettes_relabeled_summary.csv"):
        assert os.path.exists(stats / name), name
    log = (stats / "stats.txt").read_text()
    assert "Point-sharded training over 2 devices" in log and "unavailable" not in log
    assert 'Kernel launches by rank: [{"fps": 0' in log
    assert log.count("Kernel launches: ") == 1


def test_prepare_predict_ssl_artifacts(pipeline):
    root, model_id = pipeline["root"], pipeline["model_id"]
    assert len(pipeline["plots"]) >= 4
    tif = read_geotiff(str(root / "inference" / model_id / "PARCELA.tif"))
    assert tif.bands.shape[0] == 6
    shp = read_shapefile(str(root / "inference" / model_id / "parcels.shp"))
    record = shp.shape_records[0].record
    preds = {k: v for k, v in record.items() if k.startswith("PRED_")}
    assert len(preds) == 4 and all(0 <= float(v) <= 1 for v in preds.values())
    with open(root / "pseudo_labelling" / model_id / "PARCELA.pkl", "rb") as f:
        labelled = pickle.load(f)
    assert labelled and all(np.asarray(v["coverages"]).shape == (4,)
                            for v in labelled.values())
    assert os.path.exists(os.path.join(pipeline["ssl"], "PCC_model_full.pt"))
    assert os.path.exists(os.path.join(pipeline["ssl"],
                                       "PCC_inference_all_placettes_pretraining_summary.csv"))
    assert os.path.exists(os.path.join(pipeline["warm"], "PCC_model_fold_n=1.pt"))
    with open(os.path.join(pipeline["warm"], "stats.txt")) as f:
        assert "Warm-starting from pretrained model" in f.read()


# ---------------------------------------------------------------------------
# the two packages' prepare and predict CLIs on copies of the parcel folder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parcel_copies(data_tree, experiments):  # noqa: F811
    """Each package's prepare CLI on its own copy of the parcel folder."""
    from stratanet2_tpu.cli.prepare import main as jax_prepare

    for name in ("jax_parcels", "port_parcels"):
        shutil.copytree(data_tree / PARCEL, data_tree / name)
    jax_prepare(jax_args(args_for(data_tree, experiments, "jax_parcels")))
    cli_prepare.main(args_for(data_tree, experiments, "port_parcels"))
    return data_tree / "jax_parcels", data_tree / "port_parcels"


def test_prepare_pickles_equal_jax_bit_for_bit(parcel_copies):
    jax_dir, port_dir = parcel_copies
    want = (jax_dir / "prepared" / "PARCELA.pkl").read_bytes()
    got = (port_dir / "prepared" / "PARCELA.pkl").read_bytes()
    assert got == want
    assert not any(p.name.endswith(".tmp") for p in (port_dir / "prepared").iterdir())


def test_predict_from_one_checkpoint_matches_jax(parcel_copies, data_tree, experiments,  # noqa: F811
                                                 trained):
    """Both predict CLIs on their own prepared copy, from the checkpoint the
    port's training CLI wrote: the merged tif's bands and the shapefile's
    PRED_* fields within PREDICT_ATOL, NaN in the same places."""
    from stratanet2_tpu.cli.predict import main as jax_predict

    model_id = os.path.basename(trained.rstrip("/"))
    outs = []
    for run, name in ((lambda a: jax_predict(jax_args(a)), "jax_parcels"),
                      (cli_predict.main, "port_parcels")):
        run(args_for(data_tree, experiments, name)
            + ["--task", "inference", "--inference_model_id", model_id])
        outs.append(data_tree / name / "inference" / model_id)
    (jdir, pdir) = outs
    want, got = read_geotiff(str(jdir / "PARCELA.tif")), read_geotiff(str(pdir / "PARCELA.tif"))
    assert got.bands.shape == want.bands.shape and got.geotransform == want.geotransform
    assert np.array_equal(np.isnan(got.bands), np.isnan(want.bands))
    assert np.isfinite(got.bands).any()
    np.testing.assert_allclose(got.bands, want.bands, rtol=0, atol=PREDICT_ATOL)
    wrec = read_shapefile(str(jdir / "parcels.shp")).shape_records[0].record
    grec = read_shapefile(str(pdir / "parcels.shp")).shape_records[0].record
    fields_pred = [k for k in wrec if k.startswith("PRED_")]
    assert len(fields_pred) == 4 and [k for k in grec if k.startswith("PRED_")] == fields_pred
    for k in fields_pred:
        assert abs(float(grec[k]) - float(wrec[k])) <= PREDICT_ATOL, k


# ---------------------------------------------------------------------------
# the verify recipe's probes, and the card as the default
# ---------------------------------------------------------------------------


def test_predict_without_model_id_asserts(data_tree, experiments):  # noqa: F811
    with pytest.raises(AssertionError, match="inference_model_id"):
        cli_predict.main(args_for(data_tree, experiments) + ["--task", "inference"])


def test_predict_rerun_reports_empty_worklist(pipeline, caplog):
    args = pipeline["args"] + ["--task", "inference", "--inference_model_id",
                               pipeline["model_id"]]
    with caplog.at_level(logging.INFO, logger="stratanet2_tpu_torch"):
        cli_predict.main(args)  # the pipeline predicted its one parcel
    assert any("No more prepared parcel" in r.message for r in caplog.records)


def test_train_with_empty_las_folder_exits(data_tree, experiments, tmp_path):  # noqa: F811
    empty = tmp_path / "empty_las"
    empty.mkdir()
    args = args_for(data_tree, experiments)
    args[args.index("--las_plots_folder_path") + 1] = str(empty)
    # don't clobber the module-shared prepared pkl with an empty one
    args[args.index("--plots_pickled_dataset_path") + 1] = str(tmp_path / "plots.pkl")
    with pytest.raises(SystemExit, match="No plots found"):
        cli_main.main(args)


def test_predict_worklist_terminates_on_no_output_parcel(data_tree, experiments, trained,  # noqa: F811
                                                         monkeypatch):
    """PROD: a parcel whose prediction writes no output is not offered
    again by the worklist."""
    shutil.copytree(data_tree / PARCEL, data_tree / "no_output")
    args = args_for(data_tree, experiments, "no_output")
    cli_prepare.main(args)
    calls = []

    def stub_predict_parcel(*a, **kw):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("worklist re-offered a no-output parcel")
        return None  # nothing written

    monkeypatch.setattr(cli_predict, "predict_parcel", stub_predict_parcel)
    monkeypatch.setattr(cli_predict, "update_shapefile_with_predictions", lambda *a, **kw: "")
    args = [a if a != "DEV" else "PROD" for a in args]
    cli_predict.main(args + ["--task", "inference", "--inference_model_id",
                             os.path.basename(trained.rstrip("/"))])
    assert len(calls) == 1


@pytest.mark.parametrize("cli", [cli_main, cli_predict, cli_ssl])
def test_clis_default_to_the_card(cli, data_tree, experiments, monkeypatch):  # noqa: F811
    """Without --device the CLIs ask for CUDA, and say so where there is
    none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in args_for(data_tree, experiments) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--inference_model_id", "unused"])
