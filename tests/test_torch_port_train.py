"""The PyTorch port's train step against the JAX package on the CPU: the
losses, the KDE fit, the masked train-mode BatchNorm, the train-mode SA
stages, the optimizer, and the whole step at the two DEV geometries of
tests/test_torch_port_model.py (N=256 with k 8/16; N=2048 with k 32/64,
where partitioned FPS engages). The same numpy inputs and weights
(`from_jax_params`) go to both sides; each tolerance is stated where it is
used.

Two properties of the float32 reference shape the tolerances of the whole
step:
- XLA's CPU reductions sum in float32 in a fixed order, the port's in
  another; BatchNorm divides the difference by the batch std, so a channel
  whose std is small (a ReLU channel that is mostly off) amplifies it.
  The step comparisons therefore start from the init running statistics
  (mean 0, var 1: the shift of the one-pass variance is then 0, as in a
  first step), with random BN scale and bias.
- A ReLU input within rounding of zero can switch on one side and not on
  the other, which moves that row's share of every gradient upstream. At
  N=2048 (65536 inputs of the head's ReLU alone) that happens; at N=256 it
  does not. Gradients are compared leaf by leaf relative to the leaf's
  max |g|: 1e-3 at N=256, 5e-2 at N=2048.
"""

import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.config import Config as JaxConfig, ModelConfig as JaxModelConfig
from stratanet2_tpu.learning import losses as jlosses
from stratanet2_tpu.learning import train as jtrain
from stratanet2_tpu.learning.kde import fit_kde_mixture as jax_fit_kde
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init, pointnet2_forward
from stratanet2_tpu.models import nn as jnn
from stratanet2_tpu.models.pointnet2 import _sa_module
from stratanet2_tpu.ops import plotwise_coverages as jax_plotwise
from stratanet2_tpu_torch.config import Config, ModelConfig
from stratanet2_tpu_torch.learning import losses
from stratanet2_tpu_torch.learning.kde import KdeMixture, fit_kde_mixture
from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
from stratanet2_tpu_torch.models.nn import MLP, BatchNorm
from stratanet2_tpu_torch.models.pointnet2 import set_abstraction_unfused
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils.convert import from_jax_params, grads_to_jax, to_jax_params

torch.set_num_threads(1)

GEOMETRIES = {"N256": (256, 8, 16), "N2048": (2048, 32, 64)}
GRAD_RTOL = {"N256": 1e-3, "N2048": 5e-2}  # of each leaf's max |g|, see the module doc


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _random_bn_affine(rng, params):
    """Random BN scale/bias in every layer (running statistics stay at init)."""
    for name in params:
        for lp in params[name].get("layers", []):
            c = lp["bn"]["scale"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)


# ---------------------------------------------------------------------------
# losses and the KDE prior
# ---------------------------------------------------------------------------


class TestLosses:
    @staticmethod
    def _inputs(rng):
        b, n = 3, 200
        pred = rng.uniform(0, 1, (b, 4)).astype(np.float32)
        gt = rng.uniform(0, 1, (b, 4)).astype(np.float32)
        logits = rng.normal(size=(b, n, 4)).astype(np.float32)
        proba = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        z = rng.uniform(0, 9, (b, n)).astype(np.float32)
        z[0, :7] = [10.5, 12.0, 30.0, -1.0, 0.0, 9.9, 10.0]  # beyond and on the grid's ends
        grid = np.linspace(0.0, 10.0, 60, dtype=np.float32)
        pdfs = rng.uniform(0.05, 1, (3, 60)).astype(np.float32)
        return pred, gt, proba.astype(np.float32), z, grid, pdfs

    @pytest.mark.parametrize("which", ["absolute", "entropy", "nll", "total"])
    def test_value_and_grad_match_jax(self, rng, which):
        """Values within 1e-6 relative; gradients in every input within
        1e-5 of the largest (float32 rounding of sums over 600 points)."""
        pred, gt, proba, z, grid, pdfs = self._inputs(rng)

        def jax_fn(pred, proba):
            if which == "absolute":
                return jlosses.absolute_loss(pred, jnp.asarray(gt))
            if which == "entropy":
                return jlosses.entropy_loss(proba)
            if which == "nll":
                return jlosses.nll_loss(proba, jnp.asarray(z), jnp.asarray(grid),
                                        jnp.asarray(pdfs))[0]
            return jlosses.total_loss(pred, jnp.asarray(gt), proba, jnp.asarray(z),
                                      jnp.asarray(grid), jnp.asarray(pdfs), 0.1, 0.04)[0]

        want, want_g = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(pred),
                                                                   jnp.asarray(proba))
        pt, prt = T(pred).requires_grad_(), T(proba).requires_grad_()
        if which == "absolute":
            got = losses.absolute_loss(pt, T(gt))
        elif which == "entropy":
            got = losses.entropy_loss(prt)
        elif which == "nll":
            got = losses.nll_loss(prt, T(z), T(grid), T(pdfs))[0]
        else:
            got = losses.total_loss(pt, T(gt), prt, T(z), T(grid), T(pdfs), 0.1, 0.04)[0]
        got.backward()
        assert np.isfinite(float(got.detach())) and np.isfinite(float(want))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        for t, w in zip((pt, prt), want_g):
            w = np.asarray(w)
            g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30))

    def test_nll_floor(self, rng):
        """Where the prior's density is 0 (z beyond the grid's zero end) the
        likelihood is floored at 1e-38: -log gives 87.5, not inf, and those
        points get no gradient. p_all and pdf_all equal JAX's within 1e-6;
        the loss equals a float64 evaluation of the same floored mean within
        1e-6 relative. (JAX's CPU path flushes the float32 subnormal 1e-38
        to 0 and returns inf here, so the floored value is not compared with
        it.)"""
        _, _, proba, z, grid, pdfs = self._inputs(rng)
        pdfs[:, -3:] = 0.0  # zero density at the top: z >= 10 hits the floor
        prt = T(proba).requires_grad_()
        loss, (p_all, pdf_all) = losses.nll_loss(prt, T(z), T(grid), T(pdfs))
        loss.backward()
        _, (wp, wpdf) = jlosses.nll_loss(jnp.asarray(proba), jnp.asarray(z),
                                         jnp.asarray(grid), jnp.asarray(pdfs))
        np.testing.assert_allclose(p_all.detach().numpy(), np.asarray(wp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pdf_all.numpy(), np.asarray(wpdf), rtol=0, atol=1e-6)
        floored = (pdf_all.numpy() == 0).all(-1)
        assert floored[0, [0, 1, 2, 5, 6]].all() and floored.sum() == 5  # z >= 9.9
        lik = (np.asarray(wp, np.float64) * np.asarray(wpdf, np.float64)).sum(-1)
        want = -np.mean(np.log(np.maximum(lik, float(np.float32(1e-38)))))
        np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-6)
        assert (prt.grad.numpy()[floored] == 0).all() and (prt.grad.numpy()[~floored] != 0).any()


def test_kde_fit_matches_jax(rng):
    """The port's numpy copy of the fit repeats JAX's operations: equal."""
    z = np.concatenate([rng.uniform(0, 0.4, 3000), rng.uniform(0.6, 1.4, 800),
                        rng.gamma(4.0, 2.0, 1500)]).astype(np.float32)
    want = jax_fit_kde(z)
    got = fit_kde_mixture(z)
    assert got.grid.dtype == np.float32 and got.pdfs.shape == (3, 5000)
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(got.pdfs, want.pdfs)


# ---------------------------------------------------------------------------
# train-mode BatchNorm and SA stages
# ---------------------------------------------------------------------------


class TestTrainBatchNorm:
    @pytest.mark.parametrize("mask_kind", ["none", "mask", "broadcast"])
    def test_matches_jax_batchnorm(self, rng, mask_kind):
        """Output, new running state and gradients (in x, scale, bias)
        against `nn.batchnorm(train=True)` with a random running state (the
        shift): output within 1e-5, state within 1e-6, gradients within 1e-5
        of each one's largest. "broadcast" is a (B, 1, K) mask against
        (B, C, K, F) rows, counted after broadcasting."""
        f = 6
        x = rng.normal(0.3, 1.0, (2, 5, 16, f)).astype(np.float32)
        mask = {"none": None,
                "mask": rng.uniform(size=(2, 5, 16)) < 0.6,
                "broadcast": rng.uniform(size=(2, 1, 16)) < 0.6}[mask_kind]
        p = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
             "bias": rng.normal(0, 0.1, f).astype(np.float32)}
        s = {"mean": rng.normal(0, 0.1, f).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, f).astype(np.float32)}
        gy = rng.normal(size=x.shape).astype(np.float32)
        jm = None if mask is None else jnp.asarray(mask)

        def jax_fn(p, x):
            out, ns = jnn.batchnorm(p, s, x, jm, True)
            return jnp.sum(out * gy), (out, ns)

        (_, (want, want_s)), (gp, gx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
            p, jnp.asarray(x))
        bn = BatchNorm(f)
        with torch.no_grad():
            for name in ("scale", "bias"):
                getattr(bn, name).copy_(T(p[name]))
            bn.mean.copy_(T(s["mean"]))
            bn.var.copy_(T(s["var"]))
        bn.train()
        xt = T(x).requires_grad_()
        out = bn(xt, None if mask is None else T(mask))
        (out * T(gy)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(want_s[name]),
                                       rtol=0, atol=1e-6)
        for got, w in ((xt.grad, gx), (bn.scale.grad, gp["scale"]), (bn.bias.grad, gp["bias"])):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def _jax_mlp_with_port(rng, channels):
    p, s = jnn.init_mlp(jax.random.PRNGKey(int(rng.integers(1 << 30))), channels)
    p = jax.tree_util.tree_map(np.asarray, p)
    s = jax.tree_util.tree_map(np.asarray, s)
    _random_bn_affine(rng, {"mlp": p})
    mlp = MLP(channels)
    with torch.no_grad():
        for layer, lp in zip(mlp.layers, p["layers"]):
            layer.linear.w.copy_(T(lp["linear"]["w"]))
            layer.linear.b.copy_(T(lp["linear"]["b"]))
            layer.bn.scale.copy_(T(lp["bn"]["scale"]))
            layer.bn.bias.copy_(T(lp["bn"]["bias"]))
    return p, s, mlp.train()


class TestSetAbstractionTrain:
    @pytest.mark.parametrize(
        "channels,k,radius,preproject",
        [
            ([11, 16, 16], 8, 2 ** 0.5, False),  # SA1: gather [x, pos], two layers
            ([19, 32], 16, 8 ** 0.5, True),  # SA2: pre-projected q, gather VJP on x
        ],
    )
    def test_matches_jax_sa_module(self, rng, channels, k, radius, preproject):
        """Against `_sa_module(train=True)` on its XLA path (the unfused
        path the port takes): equal centroids, output within 2e-5, BN
        running state within 1e-6, and the gradients in every parameter (and
        in x for SA2, whose JAX VJP runs the hi/lo-bf16 Pallas scatter)
        within 1e-4 of each leaf's max."""
        n, c = 256, 64
        p, s, mlp = _jax_mlp_with_port(rng, channels)
        x = rng.uniform(0, 1, (2, n, channels[0] - 3)).astype(np.float32)
        pos = rng.uniform(-3, 3, (2, n, 3)).astype(np.float32)
        gy = rng.normal(size=(2, c, channels[-1])).astype(np.float32)

        def jax_fn(p, x):
            out, cent, ns = _sa_module(
                p, s, x, jnp.asarray(pos), c, radius, k, train=True,
                compute_dtype=jnp.float32, use_pallas=False, chunk=1024,
                bq_method="grouped", preproject=preproject,
            )
            return jnp.sum(out * gy), (out, cent, ns)

        (_, (want, want_cent, want_s)), (gp, gx) = jax.value_and_grad(
            jax_fn, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
        xt = T(x).requires_grad_(preproject)
        out, cent = set_abstraction_unfused(mlp, xt, T(pos), c, radius, k, fps_parts=1,
                                          fps_min_part_samples=256, preproject=preproject)
        (out * T(gy)).sum().backward()
        np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
        for layer, ls in zip(mlp.layers, want_s["layers"]):
            for name in ("mean", "var"):
                np.testing.assert_allclose(getattr(layer.bn, name).numpy(), np.asarray(ls[name]),
                                           rtol=0, atol=1e-6)
        pairs = []
        for layer, lp in zip(mlp.layers, gp["layers"]):
            pairs += [(layer.linear.w.grad, lp["linear"]["w"]), (layer.linear.b.grad, lp["linear"]["b"]),
                      (layer.bn.scale.grad, lp["bn"]["scale"]), (layer.bn.bias.grad, lp["bn"]["bias"])]
        if preproject:
            pairs.append((xt.grad, gx))
        for got, w in pairs:
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_optimizer_matches_optax_across_a_decay_boundary(rng):
    """Adam with coupled weight decay and the staircase schedule against
    `make_optimizer` (optax), on identical gradients, for two updates with
    steps_per_epoch=1: the second runs at lr * 0.985. Params within 1e-7
    plus one float32 ulp of their value (1.2e-7 at 1)."""
    jcfg, pcfg = JaxConfig(), Config()
    model = jax_init(jax.random.PRNGKey(5), jcfg.model)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(0, 0.01, a.shape).astype(np.float32),
                                    params) for _ in range(2)]
    opt = jtrain.make_optimizer(jcfg, steps_per_epoch=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ost = opt.init(jp)
    port = from_jax_params(params, state, pcfg.model, device="cpu")
    popt, sched = make_optimizer(pcfg, port, steps_per_epoch=1)
    for g in grads:
        updates, ost = opt.update(jax.tree_util.tree_map(jnp.asarray, g), ost, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)
        got_g = dict(_leaves(g))
        for name, prm in port.named_parameters():
            key = "".join(f"[{int(k)}]" if k.isdigit() else f"['{k}']" for k in name.split("."))
            prm.grad = T(got_g[key])
        popt.step()
        sched.step()
    assert popt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.985 ** 2)
    want = _leaves(jp)
    got = _leaves(to_jax_params(port)[0])
    assert [k for k, _ in want] == [k for k, _ in got]
    for (name, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1.2e-7, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def step_case(request):
    """One train step on each side from the same weights and batch: JAX's
    `make_train_step(jit=False)` (jitted here), `jax.value_and_grad` of the
    same loss as train.py:105-119 for the gradients, and the port's step."""
    n, k1, k2 = GEOMETRIES[request.param]
    rng = np.random.default_rng(n + 1)
    jm = JaxModelConfig(subsample_size=n, k1=k1, k2=k2, use_pallas=False)
    jcfg = replace(JaxConfig(), model=jm)
    pcfg = Config(model=ModelConfig(subsample_size=n, k1=k1, k2=k2))
    model = jax_init(jax.random.PRNGKey(n), jm)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    _random_bn_affine(rng, params)
    xy = rng.uniform(-10, 10, (2, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (2, n, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    cloud = np.concatenate([xy / 10, z / jm.z_max, rng.uniform(0, 1, (2, n, 7))], -1)
    cloud = cloud.astype(np.float32)
    low = rng.uniform(0, 1, 2)
    gt = np.stack([low, 1 - low, rng.uniform(0, 1, 2), rng.uniform(0, 1, 2)], 1).astype(np.float32)
    kde = jax_fit_kde(z.reshape(-1) * jm.z_max)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)

    def loss_fn(p):
        cov, proba, new_state = pointnet2_forward(
            PointNet2Params(p, js), jnp.asarray(cloud[..., 2:]), jnp.asarray(xyz), jm, train=True)
        pred_pl = jax_plotwise(cov, jnp.asarray(cloud[..., :2]), jm.diam_pix)
        z_m = jnp.asarray(cloud[..., 2]) * jm.z_max
        loss, (comps, _) = jlosses.total_loss(pred_pl, jnp.asarray(gt), proba, z_m,
                                              jnp.asarray(kde.grid), jnp.asarray(kde.pdfs),
                                              jcfg.train.m, jcfg.train.e)
        return loss, (comps, new_state)

    (_, (_, jstate)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    opt = jtrain.make_optimizer(jcfg, steps_per_epoch=1)
    ts = jtrain.TrainState(jp, js, opt.init(jp), jnp.zeros((), jnp.int32))
    ts1, jcomps = jax.jit(jtrain.make_train_step(jcfg, opt, kde, jit=False))(
        ts, jnp.asarray(cloud), jnp.asarray(xyz), jnp.asarray(gt), None)

    port = from_jax_params(params, state, pcfg.model, device="cpu")
    before = copy.deepcopy(port)
    popt, sched = make_optimizer(pcfg, port, steps_per_epoch=1)
    step = make_train_step(pcfg, KdeMixture(kde.grid, kde.pdfs), device="cpu")
    ck.reset_launches()
    comps = step(port, popt, sched, cloud, xyz, gt)
    launches = ck.launch_counts()
    new_params, new_state = to_jax_params(port)
    return dict(
        geometry=request.param, params=params, before=before, port=port,
        comps=comps, launches=launches,
        jcomps=jax.tree_util.tree_map(np.asarray, jcomps),
        jgrads=jax.tree_util.tree_map(np.asarray, jgrads),
        jstate=jax.tree_util.tree_map(np.asarray, jstate),
        jstate_step=jax.tree_util.tree_map(np.asarray, ts1.model_state),
        jparams=jax.tree_util.tree_map(np.asarray, ts1.params),
        grads=grads_to_jax(port), new_params=new_params, new_state=new_state,
    )


def test_step_loss_parts_match_jax(step_case):
    """The four loss parts within 2e-6 (float32 means over B*N points; the
    two JAX programs differ from each other by up to 6e-7)."""
    assert set(step_case["comps"]) == set(step_case["jcomps"])
    for name, value in step_case["comps"].items():
        assert value.shape == () and np.isfinite(float(value))
        np.testing.assert_allclose(float(value), step_case["jcomps"][name], rtol=0, atol=2e-6,
                                   err_msg=name)


def test_step_gradients_match_jax(step_case):
    """Every parameter's gradient, leaf by leaf, within GRAD_RTOL of the
    leaf's max |g| (see the module doc)."""
    rtol = GRAD_RTOL[step_case["geometry"]]
    want, got = _leaves(step_case["jgrads"]), _leaves(step_case["grads"])
    assert [k for k, _ in want] == [k for k, _ in got] and len(want) == 32
    for (name, w), (_, g) in zip(want, got):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max(), err_msg=name)


def test_step_bn_state_matches_jax(step_case):
    """The BN running statistics after the step within 1e-5 (the values
    are ~1; the running update keeps a tenth of the batch statistics), and
    JAX's two programs agree on them."""
    want, got = _leaves(step_case["jstate"]), _leaves(step_case["new_state"])
    assert [k for k, _ in want] == [k for k, _ in got]
    for (name, w), (_, g), (_, w2) in zip(want, got, _leaves(step_case["jstate_step"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(w2, w, rtol=0, atol=1e-5, err_msg=name)
    before = dict(_leaves(to_jax_params(step_case["before"])[1]))
    assert all(not np.array_equal(before[k], g) for k, g in got)  # every buffer moved


def test_step_params_match_jax(step_case):
    """Adam's first update is about -lr * sign(g + wd * p). Where |g + wd*p|
    exceeds the gradient tolerance the signs agree on both sides and the
    params after the step agree within 1e-7 plus one float32 ulp of their
    value; elsewhere a sign may differ, and they agree within 2 * lr +
    1e-7."""
    rtol = GRAD_RTOL[step_case["geometry"]]
    lr, wd = 1e-3, 1e-3
    old = dict(_leaves(step_case["params"]))
    want = _leaves(step_case["jparams"])
    got = dict(_leaves(step_case["new_params"]))
    grads = dict(_leaves(step_case["jgrads"]))
    for name, w in want:
        eff = grads[name] + wd * old[name]
        sure = np.abs(eff) > rtol * np.abs(grads[name]).max()
        diff = np.abs(got[name] - w)
        assert sure.any(), name
        assert (diff[sure] <= 1e-7 + 1.2e-7 * np.abs(w[sure])).all(), name
        assert diff.max() <= 2 * lr + 1e-7, name
        assert not np.array_equal(got[name], old[name]), name  # every param moved


def test_step_runs_plain_versions_on_the_cpu(step_case):
    assert step_case["launches"] == dict.fromkeys(ck.LAUNCHES, 0)
    assert step_case["port"].training
