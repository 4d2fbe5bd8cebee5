"""The PyTorch port's training loop against the JAX package on the CPU, at
`tests/synthetic.tiny_config()` sizes (N=256, k 8/16, batch 4): `train_full`
with early stopping on and off, resume in both directions between the two
packages' checkpoints, and `cross_validate` in DEV.

Both sides start from the same checkpoint, written by JAX's
`save_checkpoint` from `init_pointnet2` with random BN scale and bias, and
passed as `pretrained_path`; JAX takes its host-loader path
(`DataConfig.device_resident="false"`), whose `PlotLoader` batches the port
repeats bit for bit. 10 plots of 400 points: 8 train (2 batches an epoch)
and 2 val (fold 1 of the KFold split), 2 epochs, eval every epoch.

Tolerances. A single step of each side agrees within 2e-6 on the loss parts
and 1e-5 on the params at N=256 (tests/test_torch_port_train.py). Over the
4 Adam steps of a run the float32 rounding differences of the two programs
grow: Adam divides each moment by the root of its second moment, so where a
gradient is within rounding of 0 (|g| ~ 1e-5..1e-7, nu ~ 1e-10..1e-14) the
two sides' updates take other signs or ratios, up to lr a step. Measured
here after 4 steps: loss parts within 1.8e-5 (epoch 2's log_loss; epoch 1's
within 4.8e-7), plot predictions within 1.6e-6, params within 4.2e-4 with
median 4.6e-6 (after 2 steps already 2.5e-4, at elements with nu < 1e-9),
BN running state within 2.9e-4, median 3.3e-6. The bounds below.
"""

import os
import pickle
import shutil
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from stratanet2_tpu.learning import crossval as jcrossval
from stratanet2_tpu.learning import train as jtrain
from stratanet2_tpu.learning.kde import fit_kde_mixture_from_dataset as jax_fit_kde
from stratanet2_tpu.models import init_pointnet2 as jax_init
from stratanet2_tpu.utils import checkpoint as jckpt
from stratanet2_tpu.utils.experiment import MetricSink as JaxSink
from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.learning import crossval, train
from stratanet2_tpu_torch.learning.evaluate import LOSS_KEYS
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.convert import to_jax_params
from stratanet2_tpu_torch.utils.experiment import MetricSink
from synthetic import make_plot_dataset, tiny_config

torch.set_num_threads(1)

LOSS_ATOL = 1e-4
PRED_ATOL = 1e-5
# params and BN state: every element within 2 * lr (two steps' worth of
# Adam updates taken with another sign), the median within PARAM_MEDIAN
PARAM_ATOL = 2e-3
PARAM_MEDIAN = 2e-5
N_PLOTS = 10


def port_config(jcfg):
    """The port's Config for the JAX tiny config `jcfg`."""
    m, t = jcfg.model, jcfg.train
    cfg = Config().as_dev()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=m.subsample_size, k1=m.k1, k2=m.k2,
                      drop=m.drop),
        train=replace(cfg.train, batch_size=t.batch_size, n_epoch=t.n_epoch,
                      n_epoch_test=t.n_epoch_test, use_early_stopping=t.use_early_stopping),
        data=replace(cfg.data, device_resident=jcfg.data.device_resident),
    )


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset, both KDE priors, the shared pretrained checkpoint and a
    ground-truth CSV of the plots (for cross_validate's second pass)."""
    rng = np.random.default_rng(10)
    ds = make_plot_dataset(rng, n_plots=N_PLOTS, n_points=400)
    jcfg = tiny_config()
    jcfg = replace(jcfg, data=replace(jcfg.data, device_resident="false"))
    root = tmp_path_factory.mktemp("loop")
    model = jax_init(jax.random.PRNGKey(3), jcfg.model)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    for name in params:
        for lp in params[name].get("layers", []):
            c = lp["bn"]["scale"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    pretrained = str(root / "pretrained.pt")
    jckpt.save_checkpoint(pretrained, params, model.state)
    gt_csv = root / "gt.csv"
    pd.DataFrame({
        "Name": list(ds),
        "COUV_BASSE": [100 * float(d["coverages"][0]) for d in ds.values()],
        "COUV_INTER": [100 * float(d["coverages"][2]) for d in ds.values()],
        "COUV_HAUTE": [100 * float(d["coverages"][3]) for d in ds.values()],
    }).to_csv(gt_csv, index=False)
    jcfg = replace(jcfg, data=replace(jcfg.data, gt_file_path=str(gt_csv)))
    ids = np.array(sorted(ds))
    train_idx, val_idx = crossval.kfold_split(N_PLOTS, jcfg.train.folds)[0]
    return dict(ds=ds, jcfg=jcfg, root=root, pretrained=pretrained,
                jkde=jax_fit_kde(ds), kde=fit_kde_mixture_from_dataset(ds),
                train_ids=ids[train_idx], val_ids=ids[val_idx])


def _snapshot_epoch_1(module, snap_dir):
    """`module.save_checkpoint` that also copies the run's checkpoints into
    `snap_dir` once the epoch-1 `.resume` file is written."""
    save = module.save_checkpoint

    def hooked(path, *args, metadata=None, **kw):
        save(path, *args, metadata=metadata, **kw)
        if path.endswith(".resume") and (metadata or {}).get("epoch") == 1:
            os.makedirs(snap_dir, exist_ok=True)
            src = os.path.dirname(path)
            for name in os.listdir(src):
                if name.endswith((".pt", ".resume")):
                    shutil.copy(os.path.join(src, name), snap_dir)

    return hooked


def run_jax(setup, cfg, stats_path, resume=False, snap=None):
    os.makedirs(stats_path, exist_ok=True)
    sink = JaxSink(str(stats_path))
    with pytest.MonkeyPatch.context() as mp:
        if snap:
            mp.setattr(jckpt, "save_checkpoint", _snapshot_epoch_1(jckpt, snap))
        ts, tr, te, infos = jtrain.train_full(
            setup["ds"], setup["train_ids"], setup["val_ids"], cfg, setup["jkde"],
            str(stats_path), sink, fold_id=1, pretrained_path=setup["pretrained"],
            resume=resume,
        )
    sink.close()
    return dict(params=jax.tree_util.tree_map(np.asarray, ts.params),
                state=jax.tree_util.tree_map(np.asarray, ts.model_state),
                step=int(ts.step), train=tr, test=te, infos=infos)


def run_port(setup, cfg, stats_path, resume=False, snap=None):
    os.makedirs(stats_path, exist_ok=True)
    sink = MetricSink(str(stats_path))
    with pytest.MonkeyPatch.context() as mp:
        if snap:
            mp.setattr(ckpt, "save_checkpoint", _snapshot_epoch_1(ckpt, snap))
        ck.reset_launches()
        ts, tr, te, infos = train.train_full(
            setup["ds"], setup["train_ids"], setup["val_ids"], cfg, setup["kde"],
            str(stats_path), sink, fold_id=1, pretrained_path=setup["pretrained"],
            resume=resume, device="cpu",
        )
        assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)  # CPU: plain versions
    sink.close()
    params, state = to_jax_params(ts.model)
    return dict(params=params, state=state, step=ts.step, train=tr, test=te, infos=infos, ts=ts)


def _runs(setup, es):
    """Both packages' 2-epoch runs, with the checkpoints each had after
    epoch 1."""
    jcfg = replace(setup["jcfg"], train=replace(setup["jcfg"].train, use_early_stopping=es))
    root = setup["root"] / f"es_{es}"
    out = dict(es=es, jcfg=jcfg, pcfg=port_config(jcfg), root=root)
    out["jax"] = run_jax(setup, jcfg, root / "jax", snap=str(root / "jax_epoch1"))
    out["port"] = run_port(setup, out["pcfg"], root / "port", snap=str(root / "port_epoch1"))
    return out


@pytest.fixture(scope="module")
def runs_early_stop(setup):
    return _runs(setup, True)


@pytest.fixture(scope="module")
def runs_no_early_stop(setup):
    return _runs(setup, False)


@pytest.fixture(scope="module", params=["no_early_stop", "early_stop"])
def runs(request):
    return request.getfixturevalue(f"runs_{request.param}")


def assert_losses_match(got, want, keys, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        for k in keys:
            assert np.isfinite(g[k]), k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


def assert_infos_match(got, want):
    assert [g["pl_id"] for g in got] == [w["pl_id"] for w in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k.startswith("pred_"):
                np.testing.assert_allclose(g[k], v, rtol=0, atol=PRED_ATOL, err_msg=k)
            else:
                assert g[k] == v, k


def assert_params_match(got, want):
    for tree in ("params", "state"):
        w, g = _leaves(want[tree]), _leaves(got[tree])
        assert [k for k, _ in w] == [k for k, _ in g]
        for (name, a), (_, b) in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL, err_msg=name)
        diff = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(w, g)])
        assert np.median(diff) <= PARAM_MEDIAN, (tree, np.median(diff))


def test_train_full_losses_match_jax(runs):
    """Every epoch's train and eval loss parts, the epochs and steps, and the
    schema of each dict."""
    j, p = runs["jax"], runs["port"]
    assert [d["epoch"] for d in p["train"]] == [1, 2]
    assert [d["epoch"] for d in p["test"]] == [1, 2, 2]  # two evals and the final one
    assert_losses_match(p["train"], j["train"], train.TRAIN_LOSS_KEYS, LOSS_ATOL)
    assert_losses_match(p["test"], j["test"], LOSS_KEYS, LOSS_ATOL)
    assert p["step"] == j["step"] == 4


def test_train_full_predictions_and_weights_match_jax(runs):
    """The final eval's per-plot rows and the final params and BN state."""
    assert_infos_match(runs["port"]["infos"], runs["jax"]["infos"])
    assert_params_match(runs["port"], runs["jax"])


def test_train_full_writes_jax_files(runs):
    """The same checkpoints and artifacts in the run folder, each
    checkpoint with JAX's payload keys and metadata."""
    jdir, pdir = runs["root"] / "jax", runs["root"] / "port"

    def tree(root):  # every file, the event file by its folder alone
        return sorted(os.path.relpath(os.path.join(d, f), root) if d != str(root / "tb")
                      else "tb/" for d, _, files in os.walk(root) for f in files)

    assert tree(pdir) == tree(jdir)
    assert f"img/plots/crossval/{runs['jax']['infos'][0]['pl_id']}.png" in tree(jdir)
    for name in os.listdir(jdir):
        if ".pt" in name:
            want, got = jckpt.load_checkpoint(jdir / name), ckpt.load_checkpoint(pdir / name)
            assert set(got) == set(want) == {"params", "model_state", "opt_state", "metadata"}
            assert set(got["metadata"]) == set(want["metadata"]), name
    assert os.path.exists(pdir / "PCC_model_fold_n=1.pt.resume")


def test_jax_resume_continues_on_the_port(runs_early_stop, setup):
    """JAX's checkpoints after epoch 1 continue on the port: its epoch 2
    (train, eval), final eval, predictions and weights match JAX's
    unbroken run."""
    runs = runs_early_stop
    j = runs["jax"]
    stats = runs["root"] / "port_from_jax"
    shutil.copytree(runs["root"] / "jax_epoch1", stats)
    got = run_port(setup, runs["pcfg"], stats, resume=True)
    assert [d["epoch"] for d in got["train"]] == [2]
    assert_losses_match(got["train"], j["train"][1:], train.TRAIN_LOSS_KEYS, LOSS_ATOL)
    assert_losses_match(got["test"], j["test"][1:], LOSS_KEYS, LOSS_ATOL)
    assert_infos_match(got["infos"], j["infos"])
    assert_params_match(got, j)


def test_port_resume_continues_in_jax(runs_early_stop, setup):
    """The port's checkpoints after epoch 1 continue in JAX, its plain-tuple
    optimizer state put back into optax's classes with `tree_unflatten`:
    JAX's epoch 2 matches the port's unbroken run."""
    runs = runs_early_stop
    p = runs["port"]
    stats = runs["root"] / "jax_from_port"
    shutil.copytree(runs["root"] / "port_epoch1", stats)
    resume = stats / "PCC_model_fold_n=1.pt.resume"
    payload = ckpt.load_checkpoint(resume)
    steps = len(setup["train_ids"]) // runs["jcfg"].train.batch_size
    template = jtrain.make_optimizer(runs["jcfg"], steps).init(
        jax.tree_util.tree_map(jnp.asarray, payload["params"]))
    leaves = jax.tree_util.tree_leaves(payload["opt_state"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(template))
    opt_state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), leaves)
    jckpt.save_checkpoint(str(resume), payload["params"], payload["model_state"], opt_state,
                          payload["metadata"])
    got = run_jax(setup, runs["jcfg"], stats, resume=True)
    assert [d["epoch"] for d in got["train"]] == [2]
    assert_losses_match(p["train"][1:], got["train"], train.TRAIN_LOSS_KEYS, LOSS_ATOL)
    assert_losses_match(p["test"][1:], got["test"], LOSS_KEYS, LOSS_ATOL)
    assert_infos_match(p["infos"], got["infos"])
    assert_params_match(p, got)


def test_jax_optimizer_state_reads_as_plain_tuples(runs):
    """JAX's pickled optax chain state loads without optax as ((), (count,
    mu, nu), (count,)), leaf for leaf JAX's own, and the port writes the
    same leaves in the same order."""
    name = "PCC_model_fold_n=1.pt.resume"
    want = jckpt.load_checkpoint(runs["root"] / "jax" / name)["opt_state"]
    got = ckpt.load_checkpoint(runs["root"] / "jax" / name)["opt_state"]
    assert type(got) is tuple and [type(x) for x in got] == [tuple, tuple, tuple]
    assert got[0] == () and len(got[1]) == 3 and len(got[2]) == 1
    wl, gl = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl) == 2 + 2 * 32
    for a, b in zip(wl, gl):
        np.testing.assert_array_equal(b, a)
    mine = ckpt.load_checkpoint(runs["root"] / "port" / name)["opt_state"]
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(got)
    assert int(mine[1][0]) == int(got[1][0]) == 4 and int(mine[2][0]) == 4
    for (k, a), (_, b) in zip(_leaves(got), _leaves(mine)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_cross_validate_dev_matches_jax(runs_early_stop, setup, tmp_path, monkeypatch):
    """`cross_validate` in DEV (one fold, early stopping on, as the resume
    tests run it: JAX's compiled programs are reused): the relabelled
    summary frame within the run's bounds, and the same CSVs with the same
    columns. matplotlib is blocked on both sides, so neither draws (the
    train_full runs above draw the same figures)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    jcfg = runs_early_stop["jcfg"]
    pcfg = replace(runs_early_stop["pcfg"], data=replace(
        runs_early_stop["pcfg"].data, gt_file_path=jcfg.data.gt_file_path))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jsink, psink = JaxSink(str(jdir)), MetricSink(str(pdir))
    want = jcrossval.cross_validate(setup["ds"], jcfg, setup["jkde"], str(jdir), jsink,
                                    pretrained_path=setup["pretrained"])
    got = crossval.cross_validate(setup["ds"], pcfg, setup["kde"], str(pdir), psink,
                                  pretrained_path=setup["pretrained"], device="cpu")
    jsink.close()
    psink.close()
    assert list(got.columns) == list(want.columns) and len(got) == len(want) == 2
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=0, atol=PRED_ATOL, err_msg=col)
        else:
            assert list(got[col]) == list(want[col]), col
    csvs = sorted(f for f in os.listdir(jdir) if f.endswith(".csv"))
    assert csvs == sorted(f for f in os.listdir(pdir) if f.endswith(".csv"))
    assert csvs == ["PCC_inference_all_placettes_relabeled_summary.csv",
                    "PCC_inference_all_placettes_summary.csv"]
    for name in csvs:
        assert list(pd.read_csv(pdir / name).columns) == list(pd.read_csv(jdir / name).columns)


@pytest.mark.parametrize("n,folds", [(5, 2), (7, 5), (10, 5), (12, 5), (60, 5), (113, 2),
                                     (113, 5)])
def test_kfold_split_equals_sklearn(n, folds):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=folds, random_state=42, shuffle=True).split(np.arange(n)))
    got = crossval.kfold_split(n, folds)
    assert len(got) == len(want) == folds
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def test_mean_by_step_equals_pandas_groupby():
    """The fold statistics' group-by-step mean, on rows of two schemas; then
    with NaN values, as from a fold whose loss went NaN: pandas skips them,
    a step whose values are all NaN gives NaN, and so does a column absent
    from a step's rows, in the same places on both sides."""
    rng = np.random.default_rng(4)
    rows = [{"total_loss": float(rng.uniform()), "step": s, "epoch": e,
             **({"MAE_veg_b": float(rng.uniform())} if s > 2 else {})}
            for s, e in [(4, 2), (2, 1), (4, 2), (6, 3), (2, 1), (4, 2)]]
    nan = float("nan")
    with_nan = rows + [{"total_loss": nan, "step": 2, "epoch": 1},
                       {"total_loss": nan, "step": 8, "epoch": 4, "MAE_veg_b": nan},
                       {"total_loss": nan, "step": 8, "epoch": 4, "MAE_veg_b": 0.5},
                       {"total_loss": 1.0, "step": 10, "epoch": 5},
                       {"total_loss": nan, "step": 10, "epoch": 5}]
    for case in (rows, with_nan):
        want = pd.DataFrame(case).groupby("step").mean().to_dict("index")
        got = crossval.mean_by_step(case)
        assert list(got) == list(want)
        for step in want:
            assert list(got[step]) == list(want[step])
            np.testing.assert_allclose(list(got[step].values()), list(want[step].values()),
                                       rtol=1e-15)  # NaN where pandas has NaN
    assert np.isnan(got[8]["total_loss"]) and got[8]["MAE_veg_b"] == 0.5
    assert got[10]["total_loss"] == 1.0 and np.isnan(got[10]["MAE_veg_b"])
    with pytest.raises(ValueError):
        crossval.kfold_split(3, 5)


def test_pickled_payload_is_the_jax_format(tmp_path):
    """A port checkpoint is a plain pickle of numpy trees: JAX's loader and
    the stock unpickler read it."""
    path = tmp_path / "x.pt"
    ckpt.save_checkpoint(str(path), {"w": torch.ones(2)}, {"mean": np.zeros(3)},
                         ((), (np.int32(0), {"w": np.zeros(2)}, {"w": np.ones(2)}),
                          (np.int32(0),)), {"epoch": 1})
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert isinstance(payload["params"]["w"], np.ndarray)
    assert jckpt.load_checkpoint(str(path))["metadata"] == {"epoch": 1}
    assert not os.path.exists(str(path) + ".tmp")
