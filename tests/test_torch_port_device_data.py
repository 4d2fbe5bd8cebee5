"""The port's device-resident dataset, epoch and eval
(`stratanet2_tpu_torch/data/device_dataset.py`, `learning/train.py`'s
`make_eval_core`, `train_one_epoch_device_resident`, `use_device_resident`
and `train_full`'s device path) against the JAX package on the CPU, at
`tests/synthetic.tiny_config()` sizes (N=256, k 8/16, batch 4).

torch cannot draw JAX's random streams, so the parity tests hand the port
the draws JAX makes, computed from one key in JAX's order (`jax_draws`):
`split(key, B)`, each plot's `split(k, 5)`, then the whole-degree angle,
the two flips, the (M, 2) noise and the (M,) keys. JAX's `lax.sort` is not
stable and the port's sort is, so every comparison first asserts that no
two selection keys of a plot are tied. The port's own generator is held to
the invariants of the sample instead.

Tolerances. The sample: 1e-6 (a cos, a sin and a product per value; the
positions reach 10 m, where a float32 ulp is 9.5e-7, and agree within one).
The eval: 1e-5 on pred_pl and the per-plot loss parts (the serve step's
path, one forward). The epoch, two train steps from one checkpoint on the
same batches: the bounds of one step (tests/test_torch_port_train.py) for
each of them: each summed loss part within 2 x 2e-6, BN state within 1e-5,
params within 2 * lr + 1e-7 (Adam's first update may take another sign
where a gradient is within rounding of 0) and their median within 2e-5.
Measured: loss parts 3.6e-7, params 2.1e-6 (median 1.5e-8), BN 2.4e-7.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.data import device_dataset as jdd
from stratanet2_tpu.learning import train as jtrain
from stratanet2_tpu.learning.kde import fit_kde_mixture_from_dataset as jax_fit_kde
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init
from stratanet2_tpu.utils import checkpoint as jckpt
from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data import device_dataset as D
from stratanet2_tpu_torch.learning import train
from stratanet2_tpu_torch.learning.evaluate import LOSS_KEYS
from stratanet2_tpu_torch.learning.kde import KdeMixture
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.convert import to_jax_params
from stratanet2_tpu_torch.utils.experiment import MetricSink
from synthetic import make_plot_dataset, tiny_config

torch.set_num_threads(1)

SAMPLE_ATOL = 1e-6
EVAL_ATOL = 1e-5
LOSS_ATOL = 2 * 2e-6
BN_ATOL = 1e-5
PARAM_ATOL = 2 * 1e-3 + 1e-7
PARAM_MEDIAN = 2e-5
N_PLOTS = 10


def port_config(jcfg):
    """The port's Config for the JAX tiny config `jcfg`."""
    m, t, d = jcfg.model, jcfg.train, jcfg.data
    cfg = Config().as_dev()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=m.subsample_size, k1=m.k1, k2=m.k2,
                      diam_meters=m.diam_meters),
        train=replace(cfg.train, batch_size=t.batch_size, n_epoch=t.n_epoch,
                      n_epoch_test=t.n_epoch_test),
        data=replace(cfg.data, device_resident=d.device_resident,
                     device_resident_max_bytes=d.device_resident_max_bytes),
    )


def ragged_dataset(seed, n_plots=N_PLOTS, sizes=(400, 120, 260, 400, 75)):
    """Plots of unlike point counts (so that the cycle padding differs)."""
    ds = make_plot_dataset(np.random.default_rng(seed), n_plots=n_plots, n_points=400)
    for i, item in enumerate(ds.values()):
        n = sizes[i % len(sizes)]
        item["cloud"] = item["cloud"][:, :n]
        item["N_points_in_cloud"] = n
    return ds


def jax_draws(key, b, m, train_mode):
    """The draws of JAX's `_sample_batch(.., key, train)`, as the port's Draws."""

    def one(k):
        k_rot, k_fx, k_fy, k_noise, k_sel = jax.random.split(k, 5)
        return (jax.random.randint(k_rot, (), 0, 360), jax.random.uniform(k_fx) > 0.5,
                jax.random.uniform(k_fy) > 0.5, jax.random.normal(k_noise, (m, 2)),
                jax.random.uniform(k_sel, (m,)))

    out = [torch.from_numpy(np.array(v)) for v in jax.vmap(one)(jax.random.split(key, b))]
    return D.Draws(*out) if train_mode else D.Draws(None, None, None, None, out[-1])


def assert_no_tied_keys(dd, plot_idx, draws):
    n = dd.n[plot_idx].numpy()
    u = draws.u.numpy()
    order = np.where(np.arange(u.shape[1]) < n[:, None], u - 1.0, u)
    for row in order:
        assert np.unique(row).size == row.size, "tied selection keys: the comparison is undefined"


def _bits(t):
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The ragged dataset, both device datasets over all plots, the shared
    pretrained checkpoint (random BN scale and bias) and JAX's KDE prior,
    which the port takes too (the same constants on both sides)."""
    ds = ragged_dataset(30)
    jcfg = tiny_config()
    jcfg = replace(jcfg, data=replace(jcfg.data, device_resident="true"))
    cfg = port_config(jcfg)
    ids = sorted(ds)
    rng = np.random.default_rng(31)
    model = jax_init(jax.random.PRNGKey(5), jcfg.model)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    for name in params:
        for lp in params[name].get("layers", []):
            c = lp["bn"]["scale"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    root = tmp_path_factory.mktemp("device_data")
    pretrained = str(root / "pretrained.pt")
    jckpt.save_checkpoint(pretrained, params, model.state)
    jkde = jax_fit_kde(ds)
    return dict(ds=ds, ids=ids, jcfg=jcfg, cfg=cfg, root=root, pretrained=pretrained,
                jkde=jkde, kde=KdeMixture(jkde.grid, jkde.pdfs),
                jdd=jdd.build_device_dataset(ds, ids, jcfg.model),
                dd=D.build_device_dataset(ds, ids, cfg.model, "cpu"))


# ---------------------------------------------------------------------------
# the table and the index tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels", ["gt", "ssl"])
def test_build_device_dataset_equals_jax_bit_for_bit(setup, labels):
    ds = setup["ds"]
    if labels == "ssl":
        ds = {k: {f: v for f, v in item.items() if f != "coverages"} for k, item in ds.items()}
    want = jdd.build_device_dataset(ds, setup["ids"], setup["jcfg"].model)
    got = D.build_device_dataset(ds, setup["ids"], setup["cfg"].model, "cpu")
    assert got.plot_ids == want.plot_ids
    for name in ("feats", "xyz", "n", "coverages"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(_bits(g), _bits(w)), name
    assert got.coverages.shape == ((len(ds), 4) if labels == "gt" else (len(ds), 0))
    assert len(set(got.n.tolist())) > 1  # ragged: the padding differs between plots


@pytest.mark.parametrize("case", ["bad_size", "mixed"])
def test_malformed_coverages_raise_as_in_jax(setup, case):
    ds = {k: dict(item) for k, item in setup["ds"].items()}
    first = setup["ids"][0]
    if case == "bad_size":
        ds[first]["coverages"] = np.zeros(3, np.float32)
    else:
        del ds[first]["coverages"]
    with pytest.raises(ValueError, match="malformed or missing coverages"):
        jdd.build_device_dataset(ds, setup["ids"], setup["jcfg"].model)
    with pytest.raises(ValueError, match="malformed or missing coverages"):
        D.build_device_dataset(ds, setup["ids"], setup["cfg"].model, "cpu")


@pytest.mark.parametrize("n_plots,batch,seed,epoch", [(10, 4, 0, 1), (23, 4, 3, 7),
                                                      (3, 4, 1, 2), (40, 20, 42, 300)])
def test_index_tables_equal_jax_bit_for_bit(n_plots, batch, seed, epoch):
    want = jdd.epoch_index_table(n_plots, batch, seed, epoch)
    got = D.epoch_index_table(n_plots, batch, seed, epoch)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    (wi, wv), (gi, gv) = jdd.eval_index_table(n_plots, batch), D.eval_index_table(n_plots, batch)
    assert gi.dtype == wi.dtype and np.array_equal(gi, wi) and np.array_equal(gv, wv)


# ---------------------------------------------------------------------------
# the per-plot sample
# ---------------------------------------------------------------------------


def _regime_tables(setup, regime):
    """(JAX table, port table, ModelConfig) where every plot has n >= N, or
    every plot n < N (N = 512 above plots of at most 400 + the fake ground
    points of a 10 m disk)."""
    if regime == "n>=N":
        return setup["jdd"], setup["dd"], setup["jcfg"].model, setup["cfg"].model
    jm = replace(setup["jcfg"].model, subsample_size=512, diam_meters=10)
    pm = replace(setup["cfg"].model, subsample_size=512, diam_meters=10)
    want = jdd.build_device_dataset(setup["ds"], setup["ids"], jm)
    got = D.build_device_dataset(setup["ds"], setup["ids"], pm, "cpu")
    assert int(got.n.max()) < pm.subsample_size
    return want, got, jm, pm


@pytest.mark.parametrize("regime", ["n>=N", "n<N"])
@pytest.mark.parametrize("train_mode", [True, False], ids=["train", "eval"])
def test_sample_with_jax_draws_matches_jax(setup, regime, train_mode):
    jtable, table, jm, pm = _regime_tables(setup, regime)
    plot_idx = np.array([3, 0, 7, 1], np.int32)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, plot_idx.size, table.feats.shape[1], train_mode)
    assert_no_tied_keys(table, torch.from_numpy(plot_idx), draws)
    wf, wx = jax.jit(jdd._sample_batch, static_argnums=(0, 6))(
        jm, jtable.feats, jtable.xyz, jtable.n, jnp.asarray(plot_idx), key, train_mode)
    gf, gx = D.augment_subsample(table.feats, table.xyz, table.n, torch.from_numpy(plot_idx),
                                 draws, pm.subsample_size, train_mode)
    assert gf.shape == wf.shape and gx.shape == wx.shape
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=SAMPLE_ATOL)
    if not train_mode:  # no arithmetic: the rows themselves
        assert np.array_equal(_bits(gf.numpy()), _bits(np.asarray(wf)))


@pytest.mark.parametrize("regime", ["n>=N", "n<N"])
def test_sample_with_the_port_generator_keeps_the_invariants(setup, regime):
    _, table, _, pm = _regime_tables(setup, regime)
    big_n = pm.subsample_size
    plot_idx = torch.arange(len(table.plot_ids))
    draws = D.generator_draws(torch.Generator().manual_seed(7))(0, plot_idx.numel(),
                                                                table.feats.shape[1], True)
    rows = D.select_rows(table.n[plot_idx], draws.u, big_n)
    feats, xyz = D.augment_subsample(table.feats, table.xyz, table.n, plot_idx, draws,
                                     big_n, True)
    for p in range(plot_idx.numel()):
        n, r = int(table.n[p]), rows[p].numpy()
        if n >= big_n:
            assert np.unique(r).size == big_n and r.max() < n  # N distinct originals
        else:
            assert np.array_equal(np.sort(r[r < n]), np.arange(n))  # every original once
            copies = r[r >= n]
            assert copies.size == big_n - n and np.unique(copies).size == copies.size
        src_f, src_x = table.feats[p, r].double(), table.xyz[p, r].double()
        rad = float(draws.angle[p]) * np.pi / 180
        c, s = np.cos(rad), np.sin(rad)
        sx = -1.0 if bool(draws.flip_x[p]) else 1.0
        sy = -1.0 if bool(draws.flip_y[p]) else 1.0

        def rot(xy):
            return torch.stack([(xy[:, 0] * c + xy[:, 1] * s) * sx,
                                (-xy[:, 0] * s + xy[:, 1] * c) * sy], 1)

        # the positions rotated and flipped (their xy norm kept), z as it was
        np.testing.assert_allclose(xyz[p, :, :2].double(), rot(src_x[:, :2]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(xyz[p, :, :2].double().norm(dim=1),
                                   src_x[:, :2].norm(dim=1), rtol=0, atol=1e-5)
        assert torch.equal(xyz[p, :, 2], table.xyz[p, r, 2])
        # the features' xy: the same rotation plus noise within the clip;
        # the other features as they were
        noise = feats[p, :, :2].double() - rot(src_f[:, :2])
        assert float(noise.abs().max()) <= D.NOISE_CLIP + 1e-6
        assert float(noise.abs().max()) > 0
        assert torch.equal(feats[p, :, 2:], table.feats[p, r, 2:])
    assert bool((draws.angle >= 0).all() and (draws.angle < 360).all())


# ---------------------------------------------------------------------------
# one epoch and one eval, fed JAX's draws
# ---------------------------------------------------------------------------


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def test_epoch_with_jax_draws_matches_jax(setup, monkeypatch):
    """One device-resident epoch (8 train plots, 2 batches), both sides from
    the pretrained checkpoint, the port's fed JAX's draws (`fold_in(key,
    i)`, then `fold_in(kb, 1)`), against JAX's `make_device_epoch`: the
    summed loss parts, params and BN state.

    JAX's epoch is given the port's sampled batches (its `_sample_batch`
    replaced, each batch found by its key): the samples agree within
    SAMPLE_ATOL (test_sample_with_jax_draws_matches_jax, and here), but not
    bit for bit (cos, sin and the contraction of x*c + y*s round apart),
    and a position one ulp away can flip a pick of FPS or the ball query:
    JAX's own jitted and op-by-op samples of this epoch's first batch
    differ by one ulp and move its total_loss by 1.2e-3. With one input,
    the epochs are held to the step's bounds."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    train_ids = setup["ids"][:8]
    seed, epoch = 0, 1
    idx = jdd.epoch_index_table(len(train_ids), jcfg.train.batch_size, seed, epoch)
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), epoch)
    keys = [jax.random.fold_in(jax.random.fold_in(key, i), 1) for i in range(idx.shape[0])]

    table = D.build_device_dataset(setup["ds"], train_ids, cfg.model, "cpu")
    jtable = jdd.build_device_dataset(setup["ds"], train_ids, jcfg.model)
    feed = [jax_draws(k, idx.shape[1], table.feats.shape[1], True) for k in keys]
    sample = D.make_device_sampler(cfg.model, train=True)
    batches = []
    for i, draws in enumerate(feed):
        assert_no_tied_keys(table, torch.from_numpy(idx[i]), draws)
        batches.append(sample(table, torch.from_numpy(idx[i]), draws))
        wf, wx = jax.jit(jdd._sample_batch, static_argnums=(0, 6))(
            jcfg.model, jtable.feats, jtable.xyz, jtable.n, jnp.asarray(idx[i]), keys[i], True)
        np.testing.assert_allclose(batches[i]["cloud"].numpy(), np.asarray(wf), rtol=0,
                                   atol=SAMPLE_ATOL)
        np.testing.assert_allclose(batches[i]["xyz"].numpy(), np.asarray(wx), rtol=0,
                                   atol=SAMPLE_ATOL)
    port_cloud = jnp.asarray(np.stack([b["cloud"].numpy() for b in batches]))
    port_xyz = jnp.asarray(np.stack([b["xyz"].numpy() for b in batches]))
    key_table = jnp.stack(keys)

    def port_batch(mcfg, feats, xyz, n, plot_idx, k, train_mode):
        i = jnp.argmax(jnp.all(key_table == k, axis=1))
        return port_cloud[i], port_xyz[i]

    monkeypatch.setattr(jdd, "_sample_batch", port_batch)
    jopt = jtrain.make_optimizer(jcfg, idx.shape[0])
    jts = jtrain.init_train_state(jcfg, jopt, pretrained_path=setup["pretrained"])
    epoch_fn = jdd.make_device_epoch(jcfg, jtrain.make_train_step(jcfg, jopt, setup["jkde"],
                                                                 jit=False))
    jts, jsums = epoch_fn(jts, jtable.feats, jtable.xyz, jtable.n, jtable.coverages,
                          jnp.asarray(idx), key)

    ts = train.init_train_state(cfg, idx.shape[0], pretrained_path=setup["pretrained"],
                                device="cpu")
    run = D.make_device_epoch(cfg, train.make_train_step(cfg, setup["kde"], device="cpu"))
    sums = run(ts.model, ts.optimizer, ts.scheduler, table, torch.from_numpy(idx),
               torch.Generator().manual_seed(0), lambda i, b, m, t: feed[i])

    assert set(sums) == set(jsums) == set(train.TRAIN_LOSS_KEYS)
    for k in sums:
        np.testing.assert_allclose(float(sums[k]), float(jsums[k]), rtol=0, atol=LOSS_ATOL,
                                   err_msg=k)
    params, state = to_jax_params(ts.model)
    for got, want, atol in ((params, jts.params, PARAM_ATOL), (state, jts.model_state, BN_ATOL)):
        g, w = _leaves(got), _leaves(want)
        assert [k for k, _ in g] == [k for k, _ in w]
        diff = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(g, w)])
        assert diff.max() <= atol and np.median(diff) <= PARAM_MEDIAN, diff.max()


def test_eval_with_jax_draws_matches_jax(setup):
    """The device eval over all 10 plots (3 batches, the last padded with
    plot 0), fed JAX's draws of PRNGKey(fold_id): pred_pl and the per-plot
    loss parts within EVAL_ATOL."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    payload = jckpt.load_checkpoint(setup["pretrained"])
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, payload["params"]),
                             jax.tree_util.tree_map(jnp.asarray, payload["model_state"]))
    idx, _ = jdd.eval_index_table(len(setup["ids"]), jcfg.train.batch_size)
    fold_id = 2
    key = jax.random.PRNGKey(fold_id)
    jt = setup["jdd"]
    want_pred, want = jdd.make_device_eval(jcfg, jtrain.make_eval_core(jcfg, setup["jkde"]))(
        jmodel, jt.feats, jt.xyz, jt.n, jt.coverages, jnp.asarray(idx), key)

    ts = train.init_train_state(cfg, 1, pretrained_path=setup["pretrained"], device="cpu")
    table = setup["dd"]
    feed = [jax_draws(jax.random.fold_in(key, i), idx.shape[1], table.feats.shape[1], False)
            for i in range(idx.shape[0])]
    for i, draws in enumerate(feed):
        assert_no_tied_keys(table, torch.from_numpy(idx[i]), draws)
    run = D.make_device_eval(cfg, train.make_eval_core(cfg, setup["kde"], device="cpu"))
    ts.model.train()
    pred, comps = run(ts.model, table, torch.from_numpy(idx), torch.Generator(),
                      lambda i, b, m, t: feed[i])
    assert ts.model.training  # the caller's mode is restored
    assert tuple(pred.shape) == idx.shape + (4,)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=0, atol=EVAL_ATOL)
    assert set(comps) == set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert tuple(comps[k].shape) == idx.shape
        np.testing.assert_allclose(comps[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=EVAL_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# train_full's choice of path, and its resume on the device path
# ---------------------------------------------------------------------------


class _Chosen(Exception):
    pass


def _jax_kind(setup, jcfg, train_ids, val_ids, monkeypatch, tmp_path):
    """The path JAX's train_full takes: its program cache is asked for it
    before anything is compiled."""

    def chosen(cfg, steps_per_epoch, kde, mesh, kind):
        raise _Chosen(kind)

    monkeypatch.setattr(jtrain, "_cached_programs", chosen)
    with pytest.raises(_Chosen) as caught:
        jtrain.train_full(setup["ds"], train_ids, val_ids, jcfg, setup["jkde"],
                          str(tmp_path), None, fold_id=1)
    return caught.value.args[0]


@pytest.mark.parametrize("mode,above", [("auto", 0), ("auto", 1), ("auto", -1),
                                        ("true", 0), ("false", 1)])
def test_path_choice_matches_jax(setup, mode, above, monkeypatch, tmp_path):
    """"auto" on both sides of the estimate (the limit at the estimate, one
    byte above and one below: strictly under it takes the device path), and
    "true" / "false" as given, whatever the limit."""
    train_ids, val_ids = setup["ids"][:8], setup["ids"][8:]
    est = train.device_resident_bytes(setup["ds"], train_ids, val_ids, setup["cfg"])
    m_est = max(256, 400 + int(np.pi / 4 * 20 ** 2) + 16)  # the largest plot + fake points
    assert est == N_PLOTS * m_est * 16 * 4
    jcfg = replace(setup["jcfg"], data=replace(setup["jcfg"].data, device_resident=mode,
                                               device_resident_max_bytes=est + above))
    cfg = port_config(jcfg)
    got = train.use_device_resident(setup["ds"], train_ids, val_ids, cfg)
    kind = _jax_kind(setup, jcfg, train_ids, val_ids, monkeypatch, tmp_path)
    assert got == (kind == "device")
    assert got == {"auto": above > 0, "true": True, "false": False}[mode]


def test_device_path_resume_is_the_unbroken_run_bit_for_bit(setup, tmp_path, monkeypatch):
    """`train_full(device="cpu")` on the device path: 3 epochs unbroken
    against 2 epochs and a resume to 3 from their `.resume` file: epoch 3's
    train and eval losses, the final eval and its rows, params and BN state
    equal bit for bit (the epoch's draws come from (seed + 1, epoch), the
    eval's from the fold). Both runs build their train and val tables
    (`build_device_dataset`, twice a run) and the periodic evals read the
    val table."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # no figures: quicker
    built, evals = [], []
    build, make_eval = D.build_device_dataset, D.make_device_eval
    monkeypatch.setattr(D, "build_device_dataset",
                        lambda *a, **kw: built.append(len(a[1])) or build(*a, **kw))

    def counting_eval(*a, **kw):
        run = make_eval(*a, **kw)
        return lambda *ra, **rkw: evals.append(1) or run(*ra, **rkw)

    monkeypatch.setattr(D, "make_device_eval", counting_eval)
    cfg = replace(setup["cfg"], train=replace(setup["cfg"].train, n_epoch=3))
    train_ids, val_ids = setup["ids"][:8], setup["ids"][8:]

    def run(stats, n_epoch, resume=False):
        os.makedirs(stats, exist_ok=True)
        sink = MetricSink(str(stats))
        try:
            return train.train_full(setup["ds"], train_ids, val_ids,
                                    replace(cfg, train=replace(cfg.train, n_epoch=n_epoch)),
                                    setup["kde"], str(stats), sink, fold_id=1, seed=4,
                                    resume=resume, device="cpu")
        finally:
            sink.close()

    ts, tr, te, rows = run(tmp_path / "unbroken", 3)
    assert built == [8, 2] and len(evals) == 3
    run(tmp_path / "resumed", 2)
    ts2, tr2, te2, rows2 = run(tmp_path / "resumed", 3, resume=True)
    assert [d["epoch"] for d in tr2] == [3] and ts2.step == ts.step == 6
    for k in train.TRAIN_LOSS_KEYS:
        assert tr2[0][k] == tr[2][k], k
    for got, want in zip(te2, te[2:]):
        assert all(got[k] == want[k] for k in LOSS_KEYS)
    assert rows2 == rows
    for (name, a), (_, b) in zip(ts.model.state_dict().items(),
                                 ts2.model.state_dict().items()):
        assert torch.equal(a, b), name
    # the resumed run reloads its .resume file (not a fresh start)
    assert ckpt.load_checkpoint(str(tmp_path / "resumed" / "PCC_model_fold_n=1.pt.resume")
                                )["metadata"]["epoch"] == 3
