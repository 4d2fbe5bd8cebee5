"""The port's host data layer, metrics and config against the JAX package's
(`stratanet2_tpu/{config,data/*,learning/metrics,utils/synthetic}.py`) on
the CPU: the same numpy inputs give equal results bit for bit. Small sizes:
6-8 plots of 300-400 points.

The JAX transforms take their numpy min-z path here (`jax_numpy_minz`): the
JAX package's own tests hold its native path equal to it bit for bit, and
building native/libgridindex.so from this file too would race their build.
The port's native library builds under build/native/.
"""

import dataclasses
import os
import pickle
from dataclasses import replace

import numpy as np
import pandas as pd
import pytest
import torch

from stratanet2_tpu import config as jconfig
from stratanet2_tpu.data import dataset as jdataset
from stratanet2_tpu.data import las as jlas
from stratanet2_tpu.data import loader as jloader
from stratanet2_tpu.data import native as jnative
from stratanet2_tpu.data import transforms as jtransforms
from stratanet2_tpu.learning import metrics as jmetrics
from stratanet2_tpu.utils import synthetic as jsynthetic
from stratanet2_tpu_torch import config
from stratanet2_tpu_torch.data import dataset, las, loader, native, transforms
from stratanet2_tpu_torch.learning import metrics
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
from stratanet2_tpu_torch.inference.predict import make_predict_step
from stratanet2_tpu_torch.models.pointnet2 import init_pointnet2
from stratanet2_tpu_torch.utils import synthetic

N_SUB = 256  # the loader's subsample (PROD: 10000)


@pytest.fixture
def jax_numpy_minz(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _configs(mode="DEV", **data):
    """The port's and JAX's configs of `mode` with N_SUB points a cloud and
    the given DataConfig fields."""
    out = []
    for mod in (config, jconfig):
        cfg = mod.default_config(mode)
        out.append(replace(cfg, model=replace(cfg.model, subsample_size=N_SUB),
                           data=replace(cfg.data, **data)))
    return out


def _assert_equal_trees(got, want):
    """Equal structure, and every array and value equal bit for bit."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _assert_equal_trees(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal_trees(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def _dataset(rng, n_plots=7, coverages=True):
    """{plot_id: cloud_data} as `prepare_and_save_plots_dataset` makes it,
    300-400 points a plot, prepared by the port."""
    out = {}
    for i in range(n_plots):
        c = synthetic.make_plot_cloud(rng, n=int(rng.integers(300, 401)),
                                      center=(1000 + 40 * i, 2000))
        cloud = transforms.pre_transform(c.astype(np.float64), 1.5)
        pid = f"Plot_{i:03d}"
        out[pid] = {"cloud": cloud, "plot_center": dataset.get_plot_center(cloud),
                    "plot_id": pid, "N_points_in_cloud": cloud.shape[1], "index": i}
        if coverages:
            out[pid]["coverages"] = rng.uniform(0, 1, 4)
    return out


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            yield from _fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


@pytest.mark.parametrize("mode", ["PROD", "DEV", "dev"])
def test_default_config_fields_match_jax(mode):
    """Every field the port's config has equals the JAX config's."""
    port, jax_cfg = config.default_config(mode), jconfig.default_config(mode)
    names = []
    for name, value in _fields(port):
        want = jax_cfg
        for part in name.split("."):
            want = getattr(want, part)
        assert value == want, name
        names.append(name)
    assert {"mode", "train.folds", "train.seed", "data.transfer_dtype",
            "data.loader_workers", "data.znorm_radius_in_meters"} <= set(names)
    assert port.mode == mode.upper()
    assert config.default_config() == config.Config()


# ---------------------------------------------------------------------------
# LAS files
# ---------------------------------------------------------------------------


def _las_fields(rng, n=357, center=(652_000.0, 6_862_000.0)):
    return synthetic.cloud_to_las_fields(synthetic.make_plot_cloud(rng, n=n, center=center))


def test_las_round_trip_matches_jax(rng, tmp_path):
    fields = _las_fields(rng)
    mine, theirs = tmp_path / "port.las", tmp_path / "jax.las"
    las.write_las(str(mine), fields)
    jlas.write_las(str(theirs), fields)
    assert mine.read_bytes() == theirs.read_bytes()
    got, want = las.read_las(str(mine)), jlas.read_las(str(mine))
    _assert_equal_trees(dataclasses.asdict(got), dataclasses.asdict(want))
    np.testing.assert_allclose(got.x, fields["x"], atol=0.005 + 1e-6)
    np.testing.assert_array_equal(got.return_num, fields["return_num"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_las_written_by_one_side_reads_on_the_other(rng, tmp_path, writer):
    fields = _las_fields(rng, n=301, center=(1000.0, 2000.0))
    path = str(tmp_path / "plot.las")
    (las if writer == "port" else jlas).write_las(path, fields, scale=0.001)
    reader = jlas if writer == "port" else las
    got, want = reader.read_las(path), (las if writer == "port" else jlas).read_las(path)
    _assert_equal_trees(dataclasses.asdict(got), dataclasses.asdict(want))


@pytest.mark.parametrize("blob", [b"NOTALAS" + bytes(400), "laz"])
def test_las_rejects_what_jax_rejects(rng, tmp_path, blob):
    path = tmp_path / "bad.las"
    if blob == "laz":  # a LAZ point-format byte (bit 7 set)
        las.write_las(str(path), _las_fields(rng, n=5))
        raw = bytearray(path.read_bytes())
        raw[104] |= 0x80
        blob = bytes(raw)
    path.write_bytes(blob)
    for reader in (las, jlas):
        with pytest.raises(ValueError):
            reader.read_las(str(path))


# ---------------------------------------------------------------------------
# min z in a radius, disk query
# ---------------------------------------------------------------------------


def test_native_library_builds_and_min_z_takes_it():
    assert native.available()
    assert transforms.min_z_path() == "native"


@pytest.mark.parametrize("n,span,radius", [(400, 20.0, 1.5), (3000, 50.0, 1.5), (50, 100.0, 2.0)])
def test_min_z_in_radius_native_and_numpy_match_jax(rng, n, span, radius):
    xy = rng.uniform(0, span, (n, 2))
    z = rng.uniform(0, 25, n)
    want = jtransforms.min_z_in_radius_numpy(xy, z, radius)
    np.testing.assert_array_equal(transforms.min_z_in_radius_numpy(xy, z, radius), want)
    np.testing.assert_array_equal(native.min_z_in_radius(xy, z, radius), want)
    np.testing.assert_array_equal(transforms.min_z_in_radius(xy, z, radius), want)


def test_min_z_takes_numpy_without_the_library(rng, monkeypatch):
    xy, z = rng.uniform(0, 20, (300, 2)), rng.uniform(0, 25, 300)
    monkeypatch.setattr(native, "available", lambda: False)
    assert transforms.min_z_path() == "numpy"
    np.testing.assert_array_equal(transforms.min_z_in_radius(xy, z, 1.5),
                                  jtransforms.min_z_in_radius_numpy(xy, z, 1.5))


def test_native_build_falls_back_to_a_serial_build(tmp_path, monkeypatch):
    """When `make` fails (no OpenMP runtime or spec file), `_build` runs it
    once more with native/Makefile's CXXFLAGS less -fopenmp and keeps that
    library."""
    import subprocess

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if len(calls) == 1:
            raise subprocess.CalledProcessError(2, cmd, "", "g++: fatal error: libgomp.spec")
        (tmp_path / f"src.{os.getpid()}" / "libgridindex.so").write_bytes(b"serial")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    out = tmp_path / "libgridindex-test.so"
    assert native._build(out)
    first, second = calls
    assert first[:2] == ["make", "-C"] and len(first) == 3
    assert second[:3] == first
    assert second[3] == "CXXFLAGS=-O3 -march=native -fPIC -shared -std=c++17"
    makefile = (native._NATIVE_DIR / "Makefile").read_text()
    omp_flags = makefile.split("CXXFLAGS ?=")[1].splitlines()[0].split()
    assert second[3].split("=", 1)[1].split() == [f for f in omp_flags if f != "-fopenmp"]
    assert out.read_bytes() == b"serial"
    assert not (tmp_path / f"src.{os.getpid()}").exists()
    calls.clear()

    def always_fails(cmd, **kw):
        calls.append(cmd)
        raise subprocess.CalledProcessError(2, cmd)

    monkeypatch.setattr(native.subprocess, "run", always_fails)
    assert not native._build(tmp_path / "none.so") and len(calls) == 2


def test_serial_native_build_loads_and_matches_numpy(rng, tmp_path):
    """The serial build of native/gridindex.cpp loads, with no OpenMP
    symbol left undefined, and gives numpy's min z."""
    import ctypes
    import subprocess

    for name in native._SOURCES:
        (tmp_path / name).write_bytes((native._NATIVE_DIR / name).read_bytes())
    subprocess.run(["make", "-C", str(tmp_path), f"CXXFLAGS={native.SERIAL_CXXFLAGS}"],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(tmp_path / "libgridindex.so"))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.minz_in_radius.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_double, dp]
    xy, z = rng.uniform(0, 20, (500, 2)), rng.uniform(0, 25, 500)
    out = np.empty(500)
    lib.minz_in_radius(native._dptr(xy), native._dptr(z), 500, 1.5, native._dptr(out))
    np.testing.assert_array_equal(out, transforms.min_z_in_radius_numpy(xy, z, 1.5))


def test_disk_query_matches_kdtree(rng):
    """The scipy path of the JAX package's caller (inference/tiling.py)."""
    from scipy.spatial import cKDTree

    xy, centers = rng.uniform(0, 100, (3000, 2)), rng.uniform(0, 100, (25, 2))
    offsets, indices = native.disk_query(xy, centers, 10.0)
    assert offsets.dtype == np.int64 and indices.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == len(indices)
    tree = cKDTree(xy)
    for q in range(len(centers)):
        got = np.sort(indices[offsets[q]:offsets[q + 1]])
        np.testing.assert_array_equal(got, np.sort(tree.query_ball_point(centers[q], r=10.0)))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [20, 7])
def test_meshgrids_match_jax(width):
    _assert_equal_trees(list(transforms.get_x_y_meshgrid(width)),
                        list(jtransforms.get_x_y_meshgrid(width)))
    _assert_equal_trees(list(transforms.get_normalized_x_y_meshgrid(width)),
                        list(jtransforms.get_normalized_x_y_meshgrid(width)))


def test_cloud_transforms_match_jax(rng, jax_numpy_minz):
    cloud = synthetic.make_plot_cloud(rng, n=350)
    c64 = cloud.astype(np.float64)
    for fn, args in (
        ("normalize_z_with_minz_in_a_radius", (c64, 1.5)),
        ("pre_transform", (c64, 1.5)),
        ("add_fake_empty_ground_points", (cloud, 20, 10)),
        ("center_cloud", (c64, np.array([500.0, 6_500_000.0]))),
        ("rescale_cloud", (cloud, 24.24)),
        ("rotate_around_z", (cloud, 1.234)),
    ):
        got, want = getattr(transforms, fn)(*args), getattr(jtransforms, fn)(*args)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_match_jax(rng, seed):
    cloud = synthetic.make_plot_cloud(rng, n=333)
    xyz = cloud[:3].copy()
    got = transforms.augment(cloud.copy(), xyz.copy(), np.random.default_rng(seed))
    want = jtransforms.augment(cloud.copy(), xyz.copy(), np.random.default_rng(seed))
    _assert_equal_trees(list(got), list(want))
    for sub in (100, 1000):
        got = transforms.sample_cloud(cloud, sub, np.random.default_rng(seed))
        want = jtransforms.sample_cloud(cloud, sub, np.random.default_rng(seed))
        _assert_equal_trees(list(got), list(want))


@pytest.mark.parametrize("train", [False, True])
def test_load_cloud_item_matches_jax(rng, train):
    data = _dataset(rng, n_plots=1)["Plot_000"]
    port_cfg, jax_cfg = _configs()
    got = transforms.load_cloud_item(data, port_cfg.model, train, np.random.default_rng(5))
    want = jtransforms.load_cloud_item(data, jax_cfg.model, train, np.random.default_rng(5))
    _assert_equal_trees(got, want)
    assert got["cloud"].shape == (N_SUB, 10) and got["xyz"].shape == (N_SUB, 3)


def test_synthetic_cloud_matches_jax():
    got = synthetic.make_plot_cloud(np.random.default_rng(3), n=321, radius=9.0)
    want = jsynthetic.make_plot_cloud(np.random.default_rng(3), n=321, radius=9.0)
    np.testing.assert_array_equal(got, want)
    _assert_equal_trees(synthetic.cloud_to_las_fields(got), jsynthetic.cloud_to_las_fields(want))


# ---------------------------------------------------------------------------
# dataset preparation
# ---------------------------------------------------------------------------


def _write_plots(rng, root, n_plots=7, with_csv=True):
    """examples/make_synthetic_dataset.py's plot tree, written with the
    port's LAS writer: Plot_000.las ... and its ground-truth CSV (one row
    for a plot with no file, one plot with no row)."""
    las_dir = root / "placettes_dataset" / "las_classes"
    las_dir.mkdir(parents=True)
    bins_pct = [0, 10, 25, 33, 50, 75, 90, 100]
    rows = []
    for i in range(n_plots):
        c = synthetic.make_plot_cloud(rng, n=int(rng.integers(300, 401)),
                                      center=(1000 + 40 * i, 2000))
        las.write_las(str(las_dir / f"Plot_{i:03d}.las"), synthetic.cloud_to_las_fields(c))
        if i != 3:
            rows.append({"nom": f"Plot_{i:03d}", **{col: int(rng.choice(bins_pct)) for col in
                                                     ("COUV_BASSE", "COUV_INTER", "COUV_HAUTE")}})
    rows.insert(2, {"nom": "Plot_999", "COUV_BASSE": 10, "COUV_INTER": 0, "COUV_HAUTE": 0})
    csv = root / "placettes_dataset" / "placettes_metadata.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return las_dir, csv


@pytest.mark.parametrize("mode", ["PROD", "DEV"])
def test_prepare_and_save_plots_dataset_matches_jax(rng, tmp_path, jax_numpy_minz, mode):
    las_dir, csv = _write_plots(rng, tmp_path)
    sides = {}
    for side, mod, cfg_mod in (("port", dataset, config), ("jax", jdataset, jconfig)):
        cfg = cfg_mod.default_config(mode)
        out = tmp_path / side / "plots.pkl"
        cfg = replace(cfg, data=replace(cfg.data, las_plots_folder_path=str(las_dir),
                                        plots_pickled_dataset_path=str(out)))
        ds = mod.prepare_and_save_plots_dataset(cfg, gt_file_path=str(csv))
        with open(out, "rb") as f:
            _assert_equal_trees(pickle.load(f), ds)
        sides[side] = ds
    _assert_equal_trees(sides["port"], sides["jax"])
    assert len(sides["port"]) == 6 and "Plot_003" not in sides["port"]
    _assert_equal_trees(dataset.get_index_sorted_plot_ids(sides["port"]),
                        jdataset.get_index_sorted_plot_ids(sides["jax"]))
    gt = dataset.load_ground_truths_dataframe(str(csv))
    pd.testing.assert_frame_equal(gt, jdataset.load_ground_truths_dataframe(str(csv)))


def test_las_file_preparation_matches_jax(rng, tmp_path, jax_numpy_minz):
    las_dir, csv = _write_plots(rng, tmp_path, n_plots=2)
    name = str(las_dir / "Plot_001.las")
    cloud = dataset.load_las_file(name)
    np.testing.assert_array_equal(cloud, jdataset.load_las_file(name))
    for fname in (name, "x/Releve_Lidar_F70.las", "x/POINT_OBS8.las", "x/Releve_Lidar_F39.las"):
        np.testing.assert_array_equal(dataset.clean(cloud, fname), jdataset.clean(cloud, fname))
    gt = jdataset.load_ground_truths_dataframe(str(csv))
    port_cfg, jax_cfg = config.default_config(), jconfig.default_config()
    _assert_equal_trees(list(dataset.get_cloud_data(name, port_cfg, gt)),
                        list(jdataset.get_cloud_data(name, jax_cfg, gt)))


def test_dev_selection_matches_jax():
    names = [f"d/Plot_{i:03d}.las" for i in range(40)] + ["d/Releve_Lidar_F68.las"]
    got = dataset.sample_filenames_for_dev_crossvalidation(names, config.default_config("DEV"))
    want = jdataset.sample_filenames_for_dev_crossvalidation(names, jconfig.default_config("DEV"))
    assert got == want and len(got) == 30 and got[0] == "d/Releve_Lidar_F68.las"


# ---------------------------------------------------------------------------
# PlotLoader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("train", [True, False])
def test_plot_loader_batches_match_jax(rng, train, workers, dtype):
    """Two epochs of batches, equal bit for bit: train (shuffled, the last
    partial batch dropped) and eval (ordered, the last batch padded)."""
    ds = _dataset(rng)
    port_cfg, jax_cfg = _configs(transfer_dtype=dtype)
    port = loader.PlotLoader(ds, port_cfg, train=train, batch_size=3, seed=11, workers=workers)
    ref = jloader.PlotLoader(ds, jax_cfg, train=train, batch_size=3, seed=11, workers=workers)
    assert len(port) == len(ref) == (2 if train else 3)
    epochs = []
    for _ in range(2):
        got, want = list(port), list(ref)
        _assert_equal_trees(got, want)
        epochs.append(got)
    first = epochs[0][0]
    assert first["cloud"].dtype == np.dtype(dtype) and first["cloud"].shape == (3, N_SUB, 10)
    assert first["coverages"].shape == (3, 4)
    ids = [pid for b in epochs[0] for pid in b["plot_id"]]
    if train:  # shuffled per epoch
        assert ids != sorted(ids)
        assert [p for b in epochs[1] for p in b["plot_id"]] != ids
    else:
        assert ids == [f"Plot_{i:03d}" for i in range(7)] + ["Plot_006"] * 2
        assert epochs[0][-1]["valid"].tolist() == [True, False, False]


def test_plot_loader_threads_give_the_serial_batches(rng):
    ds = _dataset(rng)
    port_cfg, _ = _configs()
    runs = [list(loader.PlotLoader(ds, port_cfg, train=True, batch_size=2, seed=4, workers=w))
            for w in (0, 3)]
    _assert_equal_trees(runs[1], runs[0])


def test_plot_loader_fails_loudly_on_mixed_coverages(rng):
    ds = _dataset(rng)
    ds["Plot_002"]["coverages"] = np.empty(0)
    port_cfg, jax_cfg = _configs()
    for mod, cfg in ((loader, port_cfg), (jloader, jax_cfg)):
        with pytest.raises(ValueError, match="Plot_002"):
            list(mod.PlotLoader(ds, cfg, batch_size=7, workers=0))
    no_gt = _dataset(rng, coverages=False)  # no plot has coverages: no key, no error
    batch = next(iter(loader.PlotLoader(no_gt, port_cfg, batch_size=4, workers=0)))
    assert "coverages" not in batch


def test_train_and_serve_steps_run_on_loader_batches(rng):
    """One train step and one serve step of the port on the CPU, fed by
    PlotLoader batches as torch tensors."""
    ds = _dataset(rng, n_plots=6)
    cfg, _ = _configs()
    train_batch = next(iter(loader.PlotLoader(ds, cfg, train=True, batch_size=2, workers=2)))
    kde = fit_kde_mixture(train_batch["cloud"][..., 2] * cfg.model.z_max)
    model = init_pointnet2(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    opt, sched = make_optimizer(cfg, model, 3)
    comps = make_train_step(cfg, kde, device="cpu")(
        model, opt, sched, *(torch.from_numpy(train_batch[k]) for k in ("cloud", "xyz", "coverages")))
    assert comps and all(bool(torch.isfinite(v)) for v in comps.values())
    eval_batch = next(iter(loader.PlotLoader(ds, cfg, batch_size=4, workers=0)))
    rasters, pred_pl = make_predict_step(cfg, device="cpu")(
        model, torch.from_numpy(eval_batch["cloud"]), torch.from_numpy(eval_batch["xyz"]))
    p = cfg.model.diam_pix
    assert rasters.shape == (4, 3, p, p) and pred_pl.shape == (4, 4)
    assert bool(torch.isfinite(pred_pl).all())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _predictions(rng, n=40, centers=True):
    gt = rng.choice(metrics.bins_centers, (n, 3)) if centers else rng.uniform(0, 1, (n, 3))
    df = pd.DataFrame({"pl_id": [f"P{i}" for i in range(n)]})
    for j, s in enumerate(metrics.STRATA):
        df[f"vt_{s}"] = gt[:, j]
        df[f"pred_{s}"] = np.clip(gt[:, j] + rng.normal(0, 0.15, n), 0, 1)
    return df


def test_metric_arrays_match_jax(rng):
    y = rng.choice(metrics.bins_centers, 60)
    y_pred = rng.uniform(-0.1, 1.1, 60)
    for name in ("bins_centers", "bins_borders", "CLASS_LOWER", "CLASS_UPPER"):
        np.testing.assert_array_equal(getattr(metrics, name), getattr(jmetrics, name))
    for fn in ("mae", "mae2", "mae3", "accuracy", "accuracy2", "accuracy3"):
        np.testing.assert_array_equal(getattr(metrics, fn)(y_pred, y), getattr(jmetrics, fn)(y_pred, y))
    np.testing.assert_array_equal(metrics.closest_class_center(y_pred),
                                  jmetrics.closest_class_center(y_pred))


@pytest.mark.parametrize("centers", [True, False])
def test_performance_indicators_match_jax(rng, centers):
    df = _predictions(rng, centers=centers)
    got = metrics.calculate_performance_indicators_v1(df.copy())
    pd.testing.assert_frame_equal(got, jmetrics.calculate_performance_indicators_v1(df.copy()))
    if not centers:
        for mod in (metrics, jmetrics):
            with pytest.raises(KeyError):
                mod.calculate_performance_indicators_v2(df.copy())
        return
    v2 = metrics.calculate_performance_indicators_v2(got.copy())
    pd.testing.assert_frame_equal(v2, jmetrics.calculate_performance_indicators_v2(got.copy()))
    pd.testing.assert_frame_equal(metrics.calculate_performance_indicators_v3(v2.copy()),
                                  jmetrics.calculate_performance_indicators_v3(v2.copy()))
    pd.testing.assert_frame_equal(metrics.adjust_predictions_based_on_margin(v2),
                                  jmetrics.adjust_predictions_based_on_margin(v2))
    for s in metrics.STRATA:
        np.testing.assert_array_equal(metrics.compute_confusion_matrix(df, s),
                                      jmetrics.compute_confusion_matrix(df, s))


def test_confusion_matrix_pngs_are_written_as_jax_names_them(rng, tmp_path):
    df = _predictions(rng, n=12)
    for side, mod in (("port", metrics), ("jax", jmetrics)):
        mod.log_confusion_matrices(df, str(tmp_path / side), fold_id=2, epoch=5, qualified=True)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 3
