"""The port's parallel train steps on gloo ranks on the CPU against the
JAX package: the point-sharded train step at 1x2 and 2x2 against JAX's
`make_point_sharded_train_step` on the same mesh shapes, the data-parallel
step on 2 ranks against JAX's single-device `make_train_step` on the global
batch, and the data-parallel device-resident epoch against JAX's
`make_device_epoch(mesh)` on a 2-device mesh, on the same batches.

Every comparison starts from JAX's initial weights with random BN scale and
bias and the initial running statistics (tests/test_torch_port_train.py
says why). JAX's sharded step is run with SGD at lr 1, so that its update
is its gradient (params - new params; float32 rounding of the difference
is ~3e-8 against gradients of ~1e-3), and JAX's Adam (`make_optimizer`)
is then applied to those gradients for the params after one Adam step.

Tolerances, the step bounds of tests/test_torch_port_train.py at N=256 and
their sums taken in another order (each rank sums its share, then the
ranks' sums are added):
- loss parts: atol 2e-6 plus rtol 2e-6 (a float32 mean over B*N points
  of values up to ~2, where an ulp is 2.4e-7, from forwards that agree
  within ~1e-6 relative, summed in another order);
- gradients, leaf by leaf: GRAD_RTOL = 1e-3 of the leaf's max |g| (at
  N=512 in the point-sharded cases, where no ReLU input sits within
  rounding of 0 either);
- BN running state: atol 1e-5;
- params after one Adam step: where |g + wd p| exceeds the gradient bound
  the update's sign is sure and the params agree within 1e-7 plus one
  float32 ulp; elsewhere within 2 lr + 1e-7.
Not scaled by the world size: a gradient counted D times would miss the
gradient bound by a factor of D.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stratanet2_tpu.data import device_dataset as jdd
from stratanet2_tpu.learning import losses as jlosses
from stratanet2_tpu.learning import train as jtrain
from stratanet2_tpu.learning.kde import fit_kde_mixture as jax_fit_kde
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init, pointnet2_forward
from stratanet2_tpu.ops import plotwise_coverages as jax_plotwise
from stratanet2_tpu.parallel import make_mesh as jax_make_mesh
from stratanet2_tpu.parallel import point_sharded as jps
from stratanet2_tpu_torch.data import device_dataset as D
from stratanet2_tpu_torch.parallel.launch import run_ranks
from synthetic import tiny_config
from test_torch_port_device_data import assert_no_tied_keys, jax_draws, ragged_dataset
from test_torch_port_parallel import RANKS_TIMEOUT, port_config

torch.set_num_threads(1)

LOSS_ATOL = 2e-6
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-3
BN_ATOL = 1e-5
EPOCH_LOSS_ATOL = 2 * 2e-6  # two steps' sums
EPOCH_PARAM_ATOL = 2 * 1e-3 + 1e-7
EPOCH_PARAM_MEDIAN = 2e-5
MESH_BN_ATOL = 1e-4  # see the epoch test


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step_inputs(n, batch, dp, seed):
    """JAX's tiny config at N=n (fps_parts = dp), weights with random BN
    affine, a batch and a KDE prior of its heights."""
    jcfg = tiny_config()
    jcfg = replace(jcfg, model=replace(jcfg.model, subsample_size=n, fps_parts=dp,
                                       fps_min_part_samples=1),
                   train=replace(jcfg.train, batch_size=batch))
    rng = np.random.default_rng(seed)
    params = _np_tree(jax_init(jax.random.PRNGKey(seed), jcfg.model).params)
    state = _np_tree(jax_init(jax.random.PRNGKey(seed), jcfg.model).state)
    for name in params:
        for lp in params[name].get("layers", []):
            c = lp["bn"]["scale"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    xy = rng.uniform(-10, 10, (batch, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (batch, n, 1)).astype(np.float32)
    cloud = np.concatenate([xy / 10, z / jcfg.model.z_max, rng.uniform(0, 1, (batch, n, 7))],
                           -1).astype(np.float32)
    low = rng.uniform(0, 1, batch)
    gt = np.stack([low, 1 - low, rng.uniform(0, 1, batch), rng.uniform(0, 1, batch)],
                  1).astype(np.float32)
    kde = jax_fit_kde(z.reshape(-1) * jcfg.model.z_max)
    return dict(jcfg=jcfg, cfg=port_config(jcfg), params=params, state=state, cloud=cloud,
                xyz=np.concatenate([xy, z], -1), gt=gt, kde=kde)


def _port_kwargs(s):
    return dict(cfg=s["cfg"], kde_grid=s["kde"].grid, kde_pdfs=s["kde"].pdfs,
                params=s["params"], state=s["state"], cloud=s["cloud"], xyz=s["xyz"],
                gt=s["gt"])


SHARDED = {(1, 2): (512, 2, 21), (2, 2): (512, 4, 22)}  # (db, dp): N, batch, seed


def dropout_inputs(drop):
    s = step_inputs(256, 2, 2, 25)
    return dict(s, cfg=replace(s["cfg"], model=replace(s["cfg"].model, drop=drop)))
DP = (256, 4, 23)


def epoch_inputs():
    """Eight ragged plots (two batches of 4), JAX's draws of epoch 1 and
    the port's batches sampled from them (test_torch_port_device_data)."""
    s = step_inputs(DP[0], DP[1], 2, 24)
    ds = ragged_dataset(30)
    ids = sorted(ds)[:8]
    cfg, jcfg = s["cfg"], s["jcfg"]
    idx = jdd.epoch_index_table(len(ids), jcfg.train.batch_size, 0, 1)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    keys = [jax.random.fold_in(jax.random.fold_in(key, i), 1) for i in range(idx.shape[0])]
    table = D.build_device_dataset(ds, ids, cfg.model, "cpu")
    feed = [jax_draws(k, idx.shape[1], table.feats.shape[1], True) for k in keys]
    sample = D.make_device_sampler(cfg.model, train=True)
    batches = []
    for i, draws in enumerate(feed):
        assert_no_tied_keys(table, torch.from_numpy(idx[i]), draws)
        batches.append(sample(table, torch.from_numpy(idx[i]), draws))
    return dict(s, ds=ds, ids=ids, idx=idx, key=key, keys=keys, table=table, feed=feed,
                batches=batches)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    e = epoch_inputs()
    t = e["table"]
    cases = [
        ("sharded", "point_sharded_step", dict(_port_kwargs(step_inputs(*SHARDED[1, 2][:2], 2,
                                                                         SHARDED[1, 2][2])),
                                               db=1, dp=2)),
        ("dp", "data_parallel_step", _port_kwargs(step_inputs(DP[0], DP[1], 2, DP[2]))),
        *[(f"dropout_{drop}_{seed}", "point_sharded_step", dict(
            _port_kwargs(dropout_inputs(drop)), db=1, dp=2, seed=seed))
          for drop in (0.0, 0.5) for seed in (0, 1)],
        ("epoch", "device_epoch", dict(
            cfg=e["cfg"], kde_grid=e["kde"].grid, kde_pdfs=e["kde"].pdfs, params=e["params"],
            state=e["state"], feats=t.feats.numpy(), xyz=t.xyz.numpy(), n=t.n.numpy(),
            coverages=t.coverages.numpy(), idx=e["idx"],
            draws=[tuple(None if f is None else f.numpy() for f in d) for d in e["feed"]])),
    ]
    return run_ranks(2, "stratanet2_tpu_torch.parallel.dryrun:run_cases", cases,
                     backend="gloo", device="cpu", timeout=RANKS_TIMEOUT,
                     workdir=str(tmp_path_factory.mktemp("train2")))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    n, b, seed = SHARDED[2, 2]
    cases = [("sharded", "point_sharded_step",
              dict(_port_kwargs(step_inputs(n, b, 2, seed)), db=2, dp=2))]
    return run_ranks(4, "stratanet2_tpu_torch.parallel.dryrun:run_cases", cases,
                     backend="gloo", device="cpu", timeout=RANKS_TIMEOUT,
                     workdir=str(tmp_path_factory.mktemp("train4")))


def _adam_params(jcfg, params, grads):
    opt = jtrain.make_optimizer(jcfg, steps_per_epoch=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), opt.init(jp), jp)
    return _np_tree(optax.apply_updates(jp, updates))


def _check_step(got, want_comps, want_grads, want_state, want_params, old_params, lr, wd):
    """The four groups of bounds of the module doc, on one rank's result."""
    assert set(got["comps"]) == set(want_comps)
    for k, v in got["comps"].items():
        np.testing.assert_allclose(v, float(want_comps[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    want_g, got_g = _leaves(want_grads), _leaves(got["grads"])
    assert [k for k, _ in want_g] == [k for k, _ in got_g] and len(want_g) == 32
    for (name, w), (_, g) in zip(want_g, got_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)
    for (name, w), (_, g) in zip(_leaves(want_state), _leaves(got["state"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=BN_ATOL, err_msg=name)
    old, grads = dict(_leaves(old_params)), dict(want_g)
    got_p = dict(_leaves(got["params"]))
    for name, w in _leaves(want_params):
        eff = grads[name] + wd * old[name]
        sure = np.abs(eff) > GRAD_RTOL * np.abs(grads[name]).max()
        diff = np.abs(got_p[name] - w)
        assert sure.any(), name
        assert (diff[sure] <= 1e-7 + 1.2e-7 * np.abs(w[sure])).all(), name
        assert diff.max() <= 2 * lr + 1e-7, name


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_point_sharded_step_matches_jax(mesh_shape, request):
    """`make_point_sharded_train_step` on every rank against JAX's on the
    same mesh shape: loss parts, gradients, BN state and params after one
    Adam step (module doc), and equal on every rank bit for bit."""
    db, dp = mesh_shape
    n, b, seed = SHARDED[mesh_shape]
    s = step_inputs(n, b, dp, seed)
    jcfg = s["jcfg"]
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    sgd = optax.sgd(1.0)
    ts = jtrain.TrainState(jp, jax.tree_util.tree_map(jnp.asarray, s["state"]), sgd.init(jp),
                           jnp.zeros((), jnp.int32))
    mesh = jps.make_mesh_2d(db, dp)
    step = jps.make_point_sharded_train_step(jcfg, sgd, s["kde"], mesh)
    with mesh:
        ts1, comps = step(ts, jnp.asarray(s["cloud"]), jnp.asarray(s["xyz"]),
                          jnp.asarray(s["gt"]), jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, b_: np.asarray(a) - np.asarray(b_), s["params"],
                                   _np_tree(ts1.params))
    want_params = _adam_params(jcfg, s["params"], grads)
    results = [r["sharded"] for r in request.getfixturevalue(f"ranks{db * dp}")]
    for got in results:
        _check_step(got, _np_tree(comps), grads, _np_tree(ts1.model_state), want_params,
                    s["params"], jcfg.train.lr, jcfg.train.wd)
    for got in results[1:]:
        for (_, a), (_, b_) in zip(_leaves(got["params"]) + _leaves(got["state"]),
                                   _leaves(results[0]["params"]) + _leaves(results[0]["state"])):
            np.testing.assert_array_equal(a, b_)


def test_data_parallel_step_matches_jax_single_device(ranks2):
    """The data-parallel step on 2 ranks (2 plots each) against JAX's
    single-device step on the 4 plots: the global batch's loss parts, the
    gradients (JAX's `value_and_grad` of the step's loss), BN state and
    params after one Adam step; equal on both ranks bit for bit."""
    s = step_inputs(DP[0], DP[1], 2, DP[2])
    jcfg, jm = s["jcfg"], s["jcfg"].model
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    js = jax.tree_util.tree_map(jnp.asarray, s["state"])
    kde = s["kde"]

    def loss_fn(p):
        cov, proba, new_state = pointnet2_forward(
            PointNet2Params(p, js), jnp.asarray(s["cloud"][..., 2:]), jnp.asarray(s["xyz"]),
            jm, train=True)
        pred_pl = jax_plotwise(cov, jnp.asarray(s["cloud"][..., :2]), jm.diam_pix)
        z_m = jnp.asarray(s["cloud"][..., 2]) * jm.z_max
        loss, (comps, _) = jlosses.total_loss(pred_pl, jnp.asarray(s["gt"]), proba, z_m,
                                              jnp.asarray(kde.grid), jnp.asarray(kde.pdfs),
                                              jcfg.train.m, jcfg.train.e)
        return loss, (comps, new_state)

    (_, (comps, jstate)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    grads = _np_tree(grads)
    want_params = _adam_params(jcfg, s["params"], grads)
    results = [r["dp"] for r in ranks2]
    for got in results:
        _check_step(got, _np_tree(comps), grads, _np_tree(jstate), want_params, s["params"],
                    jcfg.train.lr, jcfg.train.wd)
    for (_, a), (_, b_) in zip(_leaves(results[1]["params"]), _leaves(results[0]["params"])):
        np.testing.assert_array_equal(a, b_)


def test_data_parallel_device_epoch_matches_jax_mesh_epoch(ranks2, monkeypatch):
    """One data-parallel device-resident epoch on 2 ranks (8 plots, 2
    batches of 4, 2 plots a rank), every rank given JAX's draws of the
    global batch, against JAX's `make_device_epoch` fed the port's samples
    of those draws (as test_torch_port_device_data does, since the samples
    agree within 1e-6 and not bit for bit): the summed loss parts, params
    and BN state.

    Against JAX's single-device epoch: the bounds of two steps (module
    doc). Against JAX's `make_device_epoch(mesh)` on a 2-device mesh: the
    same, but BN state within MESH_BN_ATOL: JAX's own mesh epoch differs
    from its single-device epoch by 4.4e-5 in fp3's running mean (an Adam
    sign flip of a near-zero fp3 gradient in the first step, 3.4e-4 on the
    params, moves the second step's statistics), and that is its distance
    from the port too."""
    e = epoch_inputs()
    jcfg = e["jcfg"]
    port_cloud = jnp.asarray(np.stack([b["cloud"].numpy() for b in e["batches"]]))
    port_xyz = jnp.asarray(np.stack([b["xyz"].numpy() for b in e["batches"]]))
    key_table = jnp.stack(e["keys"])

    def port_batch(mcfg, feats, xyz, n, plot_idx, k, train_mode):
        i = jnp.argmax(jnp.all(key_table == k, axis=1))
        return port_cloud[i], port_xyz[i]

    monkeypatch.setattr(jdd, "_sample_batch", port_batch)
    jtable = jdd.build_device_dataset(e["ds"], e["ids"], jcfg.model)
    for mesh, bn_atol in ((None, BN_ATOL), (jax_make_mesh(2), MESH_BN_ATOL)):
        jopt = jtrain.make_optimizer(jcfg, e["idx"].shape[0])
        jp = jax.tree_util.tree_map(jnp.asarray, e["params"])
        jts = jtrain.TrainState(jp, jax.tree_util.tree_map(jnp.asarray, e["state"]),
                                jopt.init(jp), jnp.zeros((), jnp.int32))
        epoch_fn = jdd.make_device_epoch(
            jcfg, jtrain.make_train_step(jcfg, jopt, e["kde"], jit=False), mesh=mesh)
        jts, jsums = epoch_fn(jts, jtable.feats, jtable.xyz, jtable.n, jtable.coverages,
                              jnp.asarray(e["idx"]), e["key"])
        for got in (r["epoch"] for r in ranks2):
            assert set(got["comps"]) == set(_np_tree(jsums))
            for k, v in got["comps"].items():
                np.testing.assert_allclose(v, float(jsums[k]), rtol=0, atol=EPOCH_LOSS_ATOL,
                                           err_msg=k)
            for tree, want, atol in ((got["params"], jts.params, EPOCH_PARAM_ATOL),
                                     (got["state"], jts.model_state, bn_atol)):
                g, w = _leaves(tree), _leaves(_np_tree(want))
                assert [k for k, _ in g] == [k for k, _ in w]
                diff = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(g, w)])
                assert diff.max() <= atol and np.median(diff) <= EPOCH_PARAM_MEDIAN, \
                    (mesh, diff.max())


def test_head_dropout_active_in_point_sharded_step(ranks2):
    """JAX's test_head_dropout_active_in_sharded_step: with drop 0.5 the
    head's dropout runs in the point-sharded step (another seed of the rank
    generators, another loss); with drop 0 the seed changes nothing."""
    r0 = ranks2[0]
    loss = {k: r0[k]["comps"]["total_loss"] for k in r0 if k.startswith("dropout_")}
    assert loss["dropout_0.5_0"] != loss["dropout_0.5_1"]
    assert loss["dropout_0.0_0"] == loss["dropout_0.0_1"]
