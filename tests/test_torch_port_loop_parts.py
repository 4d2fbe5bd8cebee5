"""The pieces of the PyTorch port's training loop against the JAX package on
the CPU: the eval step, checkpoints (round trip, names, lookup), the early
stopper, the empty epoch, the metric sink and TensorBoard files, dropout,
evaluation without pandas and matplotlib and with its embedding and
GeoTIFF exports, and the copied host modules
(KDE from a dataset, GeoTIFF, profiling). Sizes are
`tests/synthetic.tiny_config()`'s (N=256, k 8/16); inputs come from numpy
seeds.
"""

import copy
import json
import logging
import os
import shutil
import sys
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.inference import geotiff as jgeotiff
from stratanet2_tpu.learning import train as jtrain
from stratanet2_tpu.learning.kde import fit_kde_mixture_from_dataset as jax_fit_kde
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init
from stratanet2_tpu.utils import checkpoint as jckpt
from stratanet2_tpu.utils import tboard as jtboard
from stratanet2_tpu.utils.experiment import MetricSink as JaxSink
from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.inference import geotiff
from stratanet2_tpu_torch.learning import evaluate as pevaluate
from stratanet2_tpu_torch.learning import train
from stratanet2_tpu_torch.learning.kde import KdeMixture, fit_kde_mixture_from_dataset
from stratanet2_tpu_torch.models.pointnet2 import dropout
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils import profiling, tboard
from stratanet2_tpu_torch.utils.convert import from_jax_params, to_jax_params
from stratanet2_tpu_torch.utils.experiment import MetricSink
from stratanet2_tpu_torch.utils.synthetic import train_batch
from synthetic import make_plot_dataset, tiny_config

torch.set_num_threads(1)

ATOL = 2e-5  # the serve step's tolerance (tests/test_torch_port_model.py)


def port_config(**train_kw):
    cfg = Config().as_dev()
    return replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                   train=replace(cfg.train, batch_size=4, **train_kw))


@pytest.fixture(scope="module")
def plots():
    return make_plot_dataset(np.random.default_rng(20), n_plots=6, n_points=400)


# ---------------------------------------------------------------------------
# the eval step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_case():
    """JAX's jitted eval step on a model with random BN state and a batch of
    3 clouds, and the port's model from the same weights."""
    rng = np.random.default_rng(30)
    jcfg = tiny_config()
    model = jax_init(jax.random.PRNGKey(30), jcfg.model)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b, n = 3, 256
    xy = rng.uniform(-10, 10, (b, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (b, n, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    cloud = np.concatenate([xy / 10, z / 24.24, rng.uniform(0, 1, (b, n, 7))], -1)
    cloud = cloud.astype(np.float32)
    low = rng.uniform(0, 1, b)
    gt = np.stack([low, 1 - low, rng.uniform(0, 1, b), rng.uniform(0, 1, b)], 1)
    gt = gt.astype(np.float32)
    from stratanet2_tpu.learning.kde import fit_kde_mixture as jfit

    jkde = jfit(z.reshape(-1))
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, state))
    want = jtrain.make_eval_step(jcfg, jkde)(
        jmodel, jnp.asarray(cloud), jnp.asarray(xyz), jnp.asarray(gt))
    cfg = port_config()
    port = from_jax_params(params, state, cfg.model, device="cpu")
    return dict(cfg=cfg, port=port, cloud=cloud, xyz=xyz, gt=gt,
                kde=KdeMixture(jkde.grid, jkde.pdfs),
                want=jax.tree_util.tree_map(np.asarray, want))


def test_eval_step_matches_jax(eval_case):
    """pred_pl, cov, proba, every per-plot loss part, (p_all, pdf_all) and
    the SA3 global feature within the serve step's 2e-5."""
    step = train.make_eval_step(eval_case["cfg"], eval_case["kde"], device="cpu")
    got = step(eval_case["port"], eval_case["cloud"], eval_case["xyz"], eval_case["gt"])
    pred_pl, cov, proba, comps, aux, g = got
    w_pred, w_cov, w_proba, w_comps, w_aux, w_g = eval_case["want"]
    assert tuple(g.shape) == (3, 64) and set(comps) == set(w_comps) == set(pevaluate.LOSS_KEYS)
    pairs = [(pred_pl, w_pred), (cov, w_cov), (proba, w_proba), (aux[0], w_aux[0]),
             (aux[1], w_aux[1]), (g, w_g)]
    pairs += [(comps[k], w_comps[k]) for k in w_comps]
    for a, b in pairs:
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def test_eval_step_keeps_a_train_mode_model_in_train_mode(eval_case):
    """On a model in train mode the eval step runs eval mode: its outputs
    equal an eval copy's bit for bit, no BN buffer moves, and the model is
    in train mode afterwards."""
    step = train.make_eval_step(eval_case["cfg"], eval_case["kde"], device="cpu")
    model = copy.deepcopy(eval_case["port"]).train()
    state = {k: v.clone() for k, v in model.named_buffers()}
    args = (eval_case["cloud"], eval_case["xyz"], eval_case["gt"])
    got = step(model, *args)
    want = step(copy.deepcopy(eval_case["port"]).eval(), *args)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    assert model.training
    for name, value in model.named_buffers():
        assert torch.equal(value, state[name]), name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _stepped_state(cfg, steps):
    ts = train.init_train_state(cfg, steps_per_epoch=2, seed=0, device="cpu")
    step = train.make_train_step(cfg, KdeMixture(np.linspace(-1, 10, 64, dtype=np.float32),
                                                 np.ones((3, 64), np.float32)), device="cpu")
    gen = torch.Generator().manual_seed(5)
    batches = [train_batch(2, 256, gen, torch.device("cpu")) for _ in range(steps + 1)]
    for batch in batches[:steps]:
        step(ts.model, ts.optimizer, ts.scheduler, *batch)
    return ts._replace(step=steps), step, batches[steps]


def test_checkpoint_round_trip_keeps_the_optimizer(tmp_path):
    """A port checkpoint after 3 steps (across a decay boundary) restores
    params, BN state, Adam's moments and steps and the schedule exactly, and
    the next step of the restored state equals the next step of the
    original bit for bit."""
    cfg = port_config()
    ts, step, batch = _stepped_state(cfg, 3)
    path = str(tmp_path / ckpt.checkpoint_name(1))
    train.save_train_state(path, ts, {"epoch": 2, "step": ts.step})
    payload = ckpt.load_checkpoint(path)
    assert payload["metadata"] == {"epoch": 2, "step": 3}
    count = payload["opt_state"][1][0]
    assert count.dtype == np.int32 and int(count) == 3 and int(payload["opt_state"][2][0]) == 3
    fresh = train.init_train_state(cfg, steps_per_epoch=2, seed=1, device="cpu")
    train.load_jax_params(fresh.model, payload["params"], payload["model_state"])
    ckpt.load_adam_state(fresh.model, fresh.optimizer, fresh.scheduler, payload["opt_state"])
    for (name, a), (_, b) in zip(ts.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), name
    for pa, pb in zip(ts.model.parameters(), fresh.model.parameters()):
        sa, sb = ts.optimizer.state[pa], fresh.optimizer.state[pb]
        assert float(sa["step"]) == float(sb["step"]) == 3
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert fresh.scheduler.last_epoch == ts.scheduler.last_epoch == 3
    assert fresh.optimizer.param_groups[0]["lr"] == ts.optimizer.param_groups[0]["lr"]
    assert fresh.scheduler.get_last_lr() == ts.scheduler.get_last_lr()
    step(ts.model, ts.optimizer, ts.scheduler, *batch)
    step(fresh.model, fresh.optimizer, fresh.scheduler, *batch)
    for a, b in zip(ts.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.985 ** 2)


def test_adam_state_before_a_step_is_optax_init(tmp_path):
    """Before any step the port writes optax's init state: zero moments and
    counts; restoring it leaves Adam to start as a fresh optimizer does."""
    cfg = port_config()
    ts = train.init_train_state(cfg, steps_per_epoch=2, device="cpu")
    opt = ckpt.adam_state(ts.model, ts.optimizer, ts.scheduler)
    params, _ = to_jax_params(ts.model)
    want = jtrain.make_optimizer(tiny_config(), 2).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(want),
                                     jax.tree_util.tree_leaves(opt))) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(opt)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("fold_id", [0, -1, 1, 2, 10])
def test_checkpoint_name_is_jax_s(fold_id):
    assert ckpt.checkpoint_name(fold_id) == jckpt.checkpoint_name(fold_id)


@pytest.mark.parametrize("files,experiment", [
    (["a/2024_x/PCC_model_fold_n=10.pt", "a/2024_x/PCC_model_fold_n=1.pt",
      "a/2024_x/PCC_model_fold_n=2.pt"], "2024_x"),
    (["a/2024_x/PCC_model_fold_n=10.pt", "a/2024_x/PCC_model_full.pt"], "2024_x"),
    (["b/run/PCC_model_fold_n=12.pt", "b/run/PCC_model_fold_n=10.pt"], "run"),
    (["b/run/sub/PCC_model_fold_n=3.pt", "b/other/PCC_model_full.pt"], "run"),
])
def test_find_checkpoint_by_experiment_gives_jax_s_answer(tmp_path, files, experiment):
    for f in files:
        (tmp_path / f).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f).write_bytes(b"")
    want = jckpt.find_checkpoint_by_experiment(str(tmp_path), experiment)
    assert ckpt.find_checkpoint_by_experiment(str(tmp_path), experiment) == want
    with pytest.raises(FileNotFoundError):
        ckpt.find_checkpoint_by_experiment(str(tmp_path), "missing")


# ---------------------------------------------------------------------------
# the early stopper and the empty epoch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("losses", [
    [0.9, 0.8, 0.7, 0.6],  # always improving
    [0.9, 0.95, 0.97, 0.99, 1.0],  # never again
    [0.9, 0.95, 0.85, 0.86, 0.87, 0.88],  # improves once late
    [0.5, 0.5, 0.5],  # ties do not improve
    [2e6, 2e6, 1.0],  # worse than the initial best
])
@pytest.mark.parametrize("patience,start", [(1, 1), (2, 3), (30, 250)])
def test_early_stopper_makes_jax_s_decisions(losses, patience, start):
    """Decisions and state after every epoch, and a stopper restored from
    the state of any epoch continuing with the same decisions."""
    cfg = port_config(patience_in_epochs=patience, epoch_to_start_early_stop=start)
    jcfg = replace(tiny_config(), train=replace(tiny_config().train,
                                                patience_in_epochs=patience,
                                                epoch_to_start_early_stop=start))
    mine, theirs = train.EarlyStopper(cfg), jtrain.EarlyStopper(jcfg)
    states = []
    for epoch, loss in enumerate(losses, start=1):
        assert mine.should_stop(loss, epoch) == theirs.should_stop(loss, epoch)
        assert mine.state_dict() == theirs.state_dict()
        states.append(mine.state_dict())
    for cut, state in enumerate(states[:-1], start=1):
        restored = train.EarlyStopper(cfg)
        restored.load_state_dict(json.loads(json.dumps(state)))
        again = jtrain.EarlyStopper(jcfg)
        again.load_state_dict(state)
        for epoch, loss in enumerate(losses[cut:], start=cut + 1):
            assert restored.should_stop(loss, epoch) == again.should_stop(loss, epoch)
            assert restored.state_dict() == again.state_dict()


def test_empty_epoch_gives_the_train_schema():
    """Fewer train plots than a batch: no step, the train schema zeroed."""
    ts = train.init_train_state(port_config(), steps_per_epoch=1, device="cpu")
    ts2, got = train.train_one_epoch(None, ts, [])
    jts = jtrain.TrainState(None, None, None, jnp.zeros((), jnp.int32))
    _, want = jtrain.train_one_epoch(None, jts, [], jax.random.PRNGKey(0))
    assert list(got) == list(want)
    assert set(got) == set(train.TRAIN_LOSS_KEYS) | {"step", "points_per_sec"}
    for k in train.TRAIN_LOSS_KEYS + ("step",):
        assert got[k] == want[k] == 0
    assert ts2.step == 0


# ---------------------------------------------------------------------------
# the metric sink and TensorBoard files
# ---------------------------------------------------------------------------


def _drive_sink(sink):
    sink.log_metric("Fold_ID", 1)
    sink.set_epoch(3)
    with sink.context("fold_1_train"):
        sink.log_metrics({"total_loss": np.float32(0.25), "step": 8, "name": "x"},
                         epoch=3, step=8)
        with sink.context("nested"):
            sink.log_metrics({"a": 1.5})
    sink.log_histogram("val_MAE_veg_b", np.array([0.1, 0.2, 0.35, np.nan]), epoch=3,
                       step=1, bins=np.linspace(0, 1, 21))
    sink.log_histogram("h", [0.5, 0.7, 0.9], step=-1)
    sink.log_image("img/x.png")
    sink.log_table("t.csv")
    sink.log_parameters({"lr": 1e-3, "shape": (2, 3)})
    sink.close()


def test_metric_sink_and_event_files_are_jax_s(tmp_path, monkeypatch):
    """The JSONL records (but for their time), params.json, and the
    tfevents file byte for byte with the wall time fixed."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    _drive_sink(JaxSink(str(tmp_path / "jax")))
    _drive_sink(MetricSink(str(tmp_path / "port")))

    def records(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    assert records("port") == records("jax") and len(records("jax")) == 7
    assert (tmp_path / "port" / "params.json").read_text() == \
        (tmp_path / "jax" / "params.json").read_text()
    jfiles, pfiles = os.listdir(tmp_path / "jax" / "tb"), os.listdir(tmp_path / "port" / "tb")
    assert jfiles == pfiles and len(jfiles) == 1
    jbytes = (tmp_path / "jax" / "tb" / jfiles[0]).read_bytes()
    assert (tmp_path / "port" / "tb" / pfiles[0]).read_bytes() == jbytes
    events = tboard.read_events(str(tmp_path / "port" / "tb" / pfiles[0]))
    assert events == jtboard.read_events(str(tmp_path / "jax" / "tb" / jfiles[0]))
    assert ("fold_1_train/total_loss", 0.25, 8) in events


def test_projector_files_are_jax_s(tmp_path):
    rng = np.random.default_rng(2)
    vec = rng.normal(size=(5, 64)).astype(np.float32)
    names = [f"PLOT_{i}" for i in range(5)]
    for mod, d in ((jtboard, "jax"), (tboard, "port")):
        mod.write_projector_embedding(str(tmp_path / d), "sa3_global_fold_1", vec, names)
        mod.write_projector_embedding(str(tmp_path / d), "sa3_global_fold_2", vec[:2], names[:2])
        mod.write_projector_embedding(str(tmp_path / d), "sa3_global_fold_1", vec, names)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 5
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_keeps_and_scales_at_its_rate():
    """In train mode the share of zeros is the rate (within 5 sigma of a
    binomial over 2e5 draws) and the survivors are x / (1 - rate); the same
    generator seed gives the same mask, another seed another."""
    x = torch.ones(200_000)
    for rate in (0.1, 0.3, 0.5):
        out = dropout(x, rate, True, torch.Generator().manual_seed(7))
        zero = (out == 0).float().mean().item()
        assert abs(zero - rate) < 5 * np.sqrt(rate * (1 - rate) / x.numel())
        assert torch.equal(out[out != 0], torch.full_like(out[out != 0], 1.0) / (1 - rate))
        again = dropout(x, rate, True, torch.Generator().manual_seed(7))
        other = dropout(x, rate, True, torch.Generator().manual_seed(8))
        assert torch.equal(out, again) and not torch.equal(out, other)
    assert dropout(x, 0.3, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="needs a generator"):
        dropout(x, 0.3, True, None)


def test_model_dropout_only_in_train_mode(eval_case):
    """With drop=0.5 the eval-mode forward equals the drop=0 model's bit for
    bit; the train-mode forward raises without a generator, differs with
    one, and repeats itself from the same seed."""
    params, state = to_jax_params(eval_case["port"])
    cfg = eval_case["cfg"].model
    plain = from_jax_params(params, state, cfg, device="cpu")
    dropped = from_jax_params(params, state, replace(cfg, drop=0.5), device="cpu")
    x, pos = torch.from_numpy(eval_case["cloud"][..., 2:]), torch.from_numpy(eval_case["xyz"])
    with torch.no_grad():
        for a, b in zip(plain(x, pos), dropped(x, pos)):
            assert torch.equal(a, b)

        def train_forward(model, **kw):  # on a copy: train mode moves BN state
            return copy.deepcopy(model).train()(x, pos, **kw)[0]

        with pytest.raises(ValueError, match="needs a generator"):
            train_forward(dropped)
        ref = train_forward(plain)
        first = train_forward(dropped, generator=torch.Generator().manual_seed(3))
        second = train_forward(dropped, generator=torch.Generator().manual_seed(3))
    assert torch.equal(first, second) and not torch.equal(first, ref)


def test_resumed_epoch_redraws_the_masks(plots, tmp_path, monkeypatch):
    """With drop=0.3, 2 epochs unbroken equal 1 epoch and a resume to 2 bit
    for bit (losses, params and BN state): epoch 2's generator depends on
    (seed + 1, 2) alone. Figures are off (matplotlib blocked)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = port_config(n_epoch=2)
    cfg = replace(cfg, model=replace(cfg.model, drop=0.3))
    ids = np.array(sorted(plots))
    kde = fit_kde_mixture_from_dataset(plots)

    def run(stats, n_epoch, resume=False):
        stats.mkdir(exist_ok=True)
        sink = MetricSink(str(stats))
        out = train.train_full(plots, ids[:4], ids[4:], replace(cfg, train=replace(
            cfg.train, n_epoch=n_epoch)), kde, str(stats), sink, fold_id=1, seed=3,
            resume=resume, device="cpu")
        sink.close()
        return out

    ts, tr, te, _ = run(tmp_path / "unbroken", 2)
    run(tmp_path / "resumed", 1)
    ts2, tr2, te2, _ = run(tmp_path / "resumed", 2, resume=True)
    assert [d["epoch"] for d in tr2] == [2]
    for k in train.TRAIN_LOSS_KEYS:
        assert tr2[0][k] == tr[1][k], k
    assert te2[-1]["total_loss"] == te[-1]["total_loss"]
    for a, b in zip(ts.model.state_dict().values(), ts2.model.state_dict().values()):
        assert torch.equal(a, b)
    g1 = torch.rand(8, generator=train.epoch_generator(3, 1, torch.device("cpu")))
    g2 = torch.rand(8, generator=train.epoch_generator(3, 2, torch.device("cpu")))
    assert not torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# evaluation without the figure modules
# ---------------------------------------------------------------------------


def test_evaluate_without_pandas_and_matplotlib(plots, tmp_path, monkeypatch, caplog):
    """The last-epoch evaluation with pandas and matplotlib blocked logs a
    warning for each figure it skips and gives the same means and rows as
    with them."""
    cfg = port_config()
    kde = fit_kde_mixture_from_dataset(plots)
    ts = train.init_train_state(cfg, steps_per_epoch=1, seed=4, device="cpu")
    step = train.make_eval_step(cfg, kde, device="cpu")
    ids = np.array(sorted(plots))[:3]

    def run(d):
        d.mkdir()
        sink = MetricSink(str(d))
        out = pevaluate.evaluate(ts.model, plots, ids, cfg, kde, step, str(d), sink,
                                 fold_id=1, epoch=2, last_epoch=True, device="cpu")
        sink.close()
        return out

    want = run(tmp_path / "with")
    assert os.path.exists(tmp_path / "with" / "img" / "mae_histograms_fold_1.png")
    for name in ("pandas", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)
    with caplog.at_level(logging.WARNING, logger="stratanet2_tpu_torch"):
        got = run(tmp_path / "without")
    assert got == want
    warned = " ".join(r.getMessage() for r in caplog.records)
    for what in ("confusion matrix logging failed", "MAE histogram figure failed",
                 "interpretation figure failed"):
        assert what in warned, what
    assert not os.path.exists(tmp_path / "without" / "img")


def test_evaluate_exports_embeddings_and_geotiffs_as_jax_does(plots, tmp_path):
    """The last-epoch evaluation with `log_embeddings` and
    `plot_geotiff_file` on, against JAX's from the same weights: the means,
    the embeddings file (plot ids equal, SA3 features within 2e-5), the
    projector TSVs (labels and config equal, vectors within 2e-5) and each
    plot's GeoTIFF (geotransform and band names equal, rasters within
    2e-5)."""
    from stratanet2_tpu.learning import evaluate as jevaluate

    on = dict(log_embeddings=True, plot_geotiff_file=True)
    jcfg = replace(tiny_config(), **on)
    cfg = replace(port_config(), **on)
    jmodel = jax_init(jax.random.PRNGKey(5), jcfg.model)
    params, state = (jax.tree_util.tree_map(np.asarray, t) for t in jmodel)
    ids = np.array(sorted(plots))
    kde = fit_kde_mixture_from_dataset(plots)

    def run(name, evaluate, model, step, sink_cls):
        d = tmp_path / name
        d.mkdir()
        sink = sink_cls(str(d))
        means, rows = evaluate(model, plots, ids, cfg if name == "port" else jcfg, kde, step,
                               str(d), sink, fold_id=1, epoch=2, last_epoch=True,
                               **({"device": "cpu"} if name == "port" else {}))
        sink.close()
        return d, means

    jd, jmeans = run("jax", jevaluate.evaluate, jmodel,
                     jtrain.make_eval_step(jcfg, jax_fit_kde(plots)), JaxSink)
    pd_, means = run("port", pevaluate.evaluate,
                     from_jax_params(params, state, cfg.model, device="cpu"),
                     train.make_eval_step(cfg, kde, device="cpu"), MetricSink)
    for k in pevaluate.LOSS_KEYS:
        np.testing.assert_allclose(means[k], jmeans[k], rtol=0, atol=ATOL, err_msg=k)

    want, got = np.load(jd / "embeddings_fold_1.npz"), np.load(pd_ / "embeddings_fold_1.npz")
    np.testing.assert_array_equal(got["plot_ids"], want["plot_ids"])
    assert want["embeddings"].shape == (len(ids), 64)
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], rtol=0, atol=ATOL)
    def projector_files(d):  # the event file beside them is named by wall time
        return sorted(f for f in os.listdir(d / "tb") if f.endswith((".tsv", ".pbtxt")))

    files = projector_files(jd)
    assert projector_files(pd_) == files and len(files) == 3
    for f in files:
        if f.endswith("_vectors.tsv"):
            np.testing.assert_allclose(np.loadtxt(pd_ / "tb" / f), np.loadtxt(jd / "tb" / f),
                                       rtol=0, atol=ATOL)
        else:
            assert (pd_ / "tb" / f).read_bytes() == (jd / "tb" / f).read_bytes(), f

    tifs = sorted(f for f in os.listdir(jd / "img" / "plots" / "crossval") if f.endswith(".tif"))
    assert tifs == [f"{pid}.tif" for pid in ids]
    for f in tifs:
        w = geotiff.read_geotiff(str(jd / "img" / "plots" / "crossval" / f))
        g = geotiff.read_geotiff(str(pd_ / "img" / "plots" / "crossval" / f))
        assert (g.geotransform, g.epsg, g.band_names) == (w.geotransform, w.epsg, w.band_names)
        np.testing.assert_allclose(g.bands, w.bands, rtol=0, atol=ATOL, equal_nan=True)


# ---------------------------------------------------------------------------
# copied host modules
# ---------------------------------------------------------------------------


def test_kde_from_a_dataset_is_jax_s(plots):
    want, got = jax_fit_kde(plots), fit_kde_mixture_from_dataset(plots)
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(got.pdfs, want.pdfs)


def test_geotiff_bytes_are_jax_s(tmp_path):
    rng = np.random.default_rng(3)
    bands = rng.uniform(0, 1, (3, 20, 20)).astype(np.float32)
    bands[0, :3] = np.nan
    gt = jgeotiff.get_geotransform(np.array([650000.0, 6860000.0]), 20, 20)
    assert geotiff.get_geotransform(np.array([650000.0, 6860000.0]), 20, 20) == gt
    jgeotiff.write_geotiff(str(tmp_path / "j.tif"), bands, gt)
    geotiff.write_geotiff(str(tmp_path / "p.tif"), bands, gt)
    assert (tmp_path / "p.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    np.testing.assert_array_equal(geotiff.read_geotiff(str(tmp_path / "j.tif")).bands, bands)


def test_profiling_phases_trace_and_sync(tmp_path):
    prof = profiling.Phase("train")
    with prof.phase("epoch"):
        with prof.phase("step", points=100):
            pass
    summary = prof.summary()
    assert set(summary) == {"epoch", "epoch/step"} and summary["epoch/step"]["calls"] == 1
    with profiling.trace(str(tmp_path / "trace")):
        assert profiling.device_sync(torch.ones(3)) == 3.0
    assert os.listdir(tmp_path / "trace")
    shutil.rmtree(tmp_path / "trace")
