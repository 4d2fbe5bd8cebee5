"""The port's opt-ins against the JAX package on the CPU: the nearest ball
query, the route rule of SA1 and SA2, the bfloat16 Linear, and the eval
forward and a train step on the unfused route (nearest; grouped with
`use_pallas=False`; the same in bfloat16). The same numpy inputs and
weights go to both sides, at N=256 (k1=8, k2=16) with random BN scale and
bias.

Tolerances, float32 (as `tests/test_torch_port_model.py` and
`tests/test_torch_port_train.py` state them): atol 2e-5 on coverages and
probabilities; loss parts within 2e-6; every gradient within 1e-3 of its
leaf's max |g|; BN state within 1e-5; params after Adam within 1e-7 plus
one ulp where |g + wd * p| exceeds the gradient tolerance, else 2 lr.

bfloat16: both sides round the same float32 operands to bfloat16, but an
operand that differs by a float32 rounding between the two (a BatchNorm
output, a sum of another order in a backward matmul) rounds to another
bfloat16 value now and then, a step of up to 2^-7 relative. The BF16_*
bounds are what was measured on this geometry (6.0e-8 on the forward,
1.2e-6 on the loss parts, 6.7e-3 of a leaf's max |g| on the gradients),
rounded up; each stays below JAX's own bfloat16-vs-float32 gap on the same
inputs, which the tests measure too (1.4e-4 on the forward, 5.5e-4 on the
loss parts, 0.53 on the gradients; and leaf by leaf, every leaf's port-vs-JAX
gap is below that leaf's bfloat16-vs-float32 gap, the least of which is
8.0e-4).
"""

import functools
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
from stratanet2_tpu.ops import ball_query as jax_ball_query
from stratanet2_tpu.ops import plotwise_coverages as jax_plotwise
from stratanet2_tpu_torch.config import Config, ModelConfig
from stratanet2_tpu_torch.learning.kde import KdeMixture
from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
from stratanet2_tpu_torch.models import pointnet2
from stratanet2_tpu_torch.models.nn import Linear
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.ops.ballquery import ball_query_nearest, radius_sq
from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3
from stratanet2_tpu_torch.parallel.mesh import Mesh
from stratanet2_tpu_torch.parallel.point_sharded import (
    make_point_sharded_train_step,
    pointnet2_forward_point_sharded,
)
from stratanet2_tpu_torch.utils.convert import from_jax_params, grads_to_jax, to_jax_params

torch.set_num_threads(1)

N, K1, K2 = 256, 8, 16
BF16_ATOL = 1e-6  # forward, coverages and probabilities (measured 6.0e-8)
BF16_LOSS_ATOL = 5e-6  # loss parts (measured 1.2e-6)
BF16_GRAD_RTOL = 1e-2  # of each leaf's max |g| (measured 6.7e-3)
VARIANTS = {  # (ball_query_method, use_pallas, compute_dtype)
    "nearest": ("nearest", True, "float32"),
    "grouped_unfused": ("grouped", False, "float32"),
    "bf16_unfused": ("grouped", False, "bfloat16"),
}


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# the nearest selection
# ---------------------------------------------------------------------------


def _d2(cent, pts):
    c, p = T(cent), T(pts)
    return expanded_d2(c, sq_norm3(c), p, sq_norm3(p)).numpy()


@pytest.mark.parametrize("cloud", ["random", "grid"])
@pytest.mark.parametrize("n,c,k,radius", [(500, 128, 16, 1.5), (300, 64, 48, 2.0),
                                          (256, 64, 48, 100.0)])
def test_nearest_selection_matches_jax(cloud, n, c, k, radius):
    """`ball_query_nearest` (plain, and the wrapper on the CPU) against
    JAX's `ball_query(method="nearest")`. Random clouds have no tied
    distances: idx and mask equal exactly. Integer-grid clouds with
    duplicated points tie most distances (zero ones among them), and the
    order of XLA's CPU `approx_min_k` among equal scores is not the index
    order past a few elements (40 equal scores, k=6 give [30, 21, 22, 23,
    24, 25]); there the masks equal exactly, each slot's d2 equals JAX's
    (both ascend), the picks strictly inside a centroid's k-th distance
    are the same set (the whole in-radius set where it fits in k), and the
    port's tied picks are the lowest indices, in order."""
    rng = np.random.default_rng(n + k)
    if cloud == "random":
        pts = rng.uniform(-3, 3, (2, n, 3)).astype(np.float32)
    else:
        pts = rng.integers(0, 6, (2, n, 3)).astype(np.float32)
        pts[:, n // 2 : n // 2 + n // 8] = pts[:, : n // 8]
    cent = pts[:, rng.choice(n, c, replace=False)]
    wi, wm = jax_ball_query(jnp.asarray(cent), jnp.asarray(pts), radius, k, chunk=32,
                            method="nearest")
    wi, wm = np.asarray(wi), np.asarray(wm)
    gi, gm = ball_query_nearest(T(cent), T(pts), radius, k)
    ti, tm = ck.ball_query_nearest(T(cent), T(pts), radius, k)
    assert gi.dtype == torch.int64 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), gi.numpy())
    np.testing.assert_array_equal(tm.numpy(), gm.numpy())
    gi, gm = gi.numpy(), gm.numpy()
    np.testing.assert_array_equal(gm, wm)
    assert (gi[~gm] == 0).all() and gm.any() and (~gm).any() == (radius < 10)
    if cloud == "random":
        np.testing.assert_array_equal(gi, wi)
        return
    d2 = _d2(cent, pts)
    r2 = radius_sq(radius)
    for b in range(2):
        for ci in range(c):
            m = gm[b, ci]
            got_d, want_d = d2[b, ci][gi[b, ci][m]], d2[b, ci][wi[b, ci][m]]
            np.testing.assert_array_equal(got_d, want_d)
            inside = got_d < got_d[-1]
            assert set(gi[b, ci][m][inside]) == set(wi[b, ci][m][inside])
            if (d2[b, ci] <= r2).sum() <= k:
                assert set(gi[b, ci][m]) == set(wi[b, ci][m])
            order = np.lexsort((np.arange(n), d2[b, ci]))  # by (d2, index)
            np.testing.assert_array_equal(gi[b, ci][m], order[: m.sum()])


def test_nearest_wrapper_checks_its_inputs():
    pts = torch.rand(1, 10, 3)
    with pytest.raises(ValueError, match="k <= N"):
        ck.ball_query_nearest(pts, pts, 1.0, 11)
    with pytest.raises(ValueError, match="float32"):
        ck.ball_query_nearest(pts.double(), pts.double(), 1.0, 4)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

ROUTES = [  # (method, use_pallas) -> fused, the selection wrapper of the unfused route
    ("grouped", True, True, None),
    ("grouped", False, False, "ball_query"),
    ("nearest", True, False, "ball_query_nearest"),
    ("nearest", False, False, "ball_query_nearest"),
]
SA_KERNELS = ("sa_fused_eval", "ball_query", "ball_query_nearest", "sa_train_stats",
              "sa_train_main")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("method,use_pallas,fused,selection", ROUTES)
def test_route_rule(monkeypatch, method, use_pallas, fused, selection, train):
    """`fused_eligible` is JAX's rule without its TPU and VMEM terms, and
    the forward calls the kernels of the route it names: fused eval, the SA
    kernel twice; fused train, the grouped query and the main pass twice
    each; unfused, the configured selection twice and no SA kernel."""
    cfg = ModelConfig(subsample_size=N, k1=K1, k2=K2, ball_query_method=method,
                      use_pallas=use_pallas)
    assert pointnet2.fused_eligible(cfg) == fused
    assert not pointnet2.fused_eligible(cfg, layers=3)
    calls = dict.fromkeys(SA_KERNELS, 0)
    for name in SA_KERNELS:
        real = getattr(ck, name)

        def counted(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(ck, name, counted)
    model = pointnet2.init_pointnet2(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    xyz = T(rng.uniform(-10, 10, (2, N, 3)).astype(np.float32))
    model.train(train)
    with torch.set_grad_enabled(train):
        model(T(rng.uniform(0, 1, (2, N, 8)).astype(np.float32)), xyz)
    want = dict.fromkeys(SA_KERNELS, 0)
    if fused and train:
        want.update(ball_query=2, sa_train_main=2, sa_train_stats=1)
    elif fused:
        want["sa_fused_eval"] = 2
    else:
        want[selection] = 2
    assert calls == want


def test_config_rejects_unknown_opt_ins():
    with pytest.raises(ValueError, match="ball_query_method"):
        ModelConfig(ball_query_method="approx")
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelConfig(compute_dtype="float16")
    cfg = ModelConfig()
    assert (cfg.ball_query_method, cfg.use_pallas, cfg.compute_dtype) == (
        JaxModelConfig().ball_query_method, JaxModelConfig().use_pallas,
        JaxModelConfig().compute_dtype)


def test_steps_refuse_a_model_built_for_other_opt_ins():
    cfg = Config(model=ModelConfig(subsample_size=N, k1=K1, k2=K2, ball_query_method="nearest"))
    model = pointnet2.init_pointnet2(torch.Generator().manual_seed(0), replace(
        cfg.model, ball_query_method="grouped"), device="cpu")
    kde = KdeMixture(np.linspace(0, 1, 8, dtype=np.float32), np.ones((3, 8), np.float32))
    opt, sched = make_optimizer(cfg, model, 1)
    with pytest.raises(ValueError, match="ball_query_method='grouped'"):
        make_train_step(cfg, kde, device="cpu")(model, opt, sched, np.zeros((1, N, 10)),
                                                 np.zeros((1, N, 3)), np.zeros((1, 4)))


# ---------------------------------------------------------------------------
# the bfloat16 Linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 50, 7, 11), (300, 34)])
def test_bf16_linear_matches_jax(shape):
    """Forward against `nn.linear(p, x, jnp.bfloat16)` within 4e-6 (float32
    sums of exact bfloat16 products in another order). The VJP's dx and dw
    are float32 sums rounded to bfloat16: where the two sums round apart
    the bfloat16 results differ by one ulp (2^-7 of the value at most), in
    under 1% of the elements; equal elsewhere. db within 1e-6 of its max.
    Every output is float32."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(shape[-1], 16)).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    g = rng.normal(size=shape[:-1] + (16,)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, x: jnn.linear(p, x, jnp.bfloat16),
                     {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    lin = Linear(shape[-1], 16)
    with torch.no_grad():
        lin.w.copy_(T(w))
        lin.b.copy_(T(b))
    xt = T(x).requires_grad_()
    yt = lin(xt, "bfloat16")
    yt.backward(T(g))
    assert yt.dtype == xt.grad.dtype == lin.w.grad.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=0, atol=4e-6)
    for got, want in ((xt.grad.numpy(), np.asarray(gx)), (lin.w.grad.numpy(), np.asarray(gp["w"]))):
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        assert (got != want).mean() < 0.01
    db = np.asarray(gp["b"])
    np.testing.assert_allclose(lin.b.grad.numpy(), db, rtol=0, atol=1e-6 * np.abs(db).max())
    np.testing.assert_array_equal(lin(xt).detach().numpy(), (T(x) @ T(w) + T(b)).numpy())


# ---------------------------------------------------------------------------
# the eval forward and a train step on the unfused route
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inputs():
    """Weights (random BN scale and bias; running statistics at init for
    the step, random for the forward), a batch and a KDE prior, shared by
    every variant so that the float32 variants are the bfloat16 one's
    reference gap."""
    rng = np.random.default_rng(N + 3)
    model = jax_init(jax.random.PRNGKey(N), JaxModelConfig(subsample_size=N, k1=K1, k2=K2))
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    eval_state = jax.tree_util.tree_map(np.copy, state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], eval_state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    xy = rng.uniform(-10, 10, (2, N, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (2, N, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    cloud = np.concatenate([xy / 10, z / 24.24, rng.uniform(0, 1, (2, N, 7))], -1)
    low = rng.uniform(0, 1, 2)
    gt = np.stack([low, 1 - low, rng.uniform(0, 1, 2), rng.uniform(0, 1, 2)], 1)
    kde = jax_fit_kde(z.reshape(-1) * 24.24)
    return params, state, eval_state, cloud.astype(np.float32), xyz, gt.astype(np.float32), kde


@functools.lru_cache(maxsize=None)
def _run(variant):
    """JAX's eval forward, value_and_grad of the step's loss and optax's
    update, and the port's eval forward and `make_train_step`, for one
    variant."""
    method, use_pallas, dtype = VARIANTS[variant]
    params, state, eval_state, cloud, xyz, gt, kde = _inputs()
    jm = JaxModelConfig(subsample_size=N, k1=K1, k2=K2, ball_query_method=method,
                        use_pallas=use_pallas, compute_dtype=dtype)
    jcfg = replace(JaxConfig(), model=jm)
    pm = ModelConfig(subsample_size=N, k1=K1, k2=K2, ball_query_method=method,
                     use_pallas=use_pallas, compute_dtype=dtype)
    pcfg = Config(model=pm)
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)

    cov, proba, _ = pointnet2_forward(PointNet2Params(tree(params), tree(eval_state)),
                                      jnp.asarray(cloud[..., 2:]), jnp.asarray(xyz), jm,
                                      train=False)

    def loss_fn(p):
        c, pr, new_state = pointnet2_forward(PointNet2Params(p, tree(state)),
                                             jnp.asarray(cloud[..., 2:]), jnp.asarray(xyz), jm,
                                             train=True)
        pred_pl = jax_plotwise(c, jnp.asarray(cloud[..., :2]), jm.diam_pix)
        loss, (comps, _) = jlosses.total_loss(
            pred_pl, jnp.asarray(gt), pr, jnp.asarray(cloud[..., 2]) * jm.z_max,
            jnp.asarray(kde.grid), jnp.asarray(kde.pdfs), jcfg.train.m, jcfg.train.e)
        return loss, (comps, new_state)

    jp = tree(params)
    (_, (jcomps, jstate)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    opt = jtrain.make_optimizer(jcfg, steps_per_epoch=1)
    updates, _ = opt.update(jgrads, opt.init(jp), jp)
    jparams = jax.tree_util.tree_map(lambda a, u: a + u, jp, updates)

    port = from_jax_params(params, eval_state, pm, device="cpu")
    with torch.no_grad():
        pcov, pproba = port(T(cloud[..., 2:]), T(xyz))
    port = from_jax_params(params, state, pm, device="cpu")
    popt, sched = make_optimizer(pcfg, port, steps_per_epoch=1)
    ck.reset_launches()
    comps = make_train_step(pcfg, KdeMixture(kde.grid, kde.pdfs), device="cpu")(
        port, popt, sched, cloud, xyz, gt)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    new_params, new_state = to_jax_params(port)
    return dict(
        cov=np.asarray(cov), proba=np.asarray(proba), pcov=pcov.numpy(), pproba=pproba.numpy(),
        jcomps=np_tree(jcomps), comps={k: float(v) for k, v in comps.items()},
        jgrads=np_tree(jgrads), grads=grads_to_jax(port), jstate=np_tree(jstate),
        state=new_state, jparams=np_tree(jparams), params=new_params,
        launches=ck.launch_counts(),
    )


def _rel(got, want):
    """Per leaf, max |got - want| / max |want|."""
    return np.array([np.abs(g - w).max() / np.abs(w).max()
                     for (_, g), (_, w) in zip(_leaves(got), _leaves(want))])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_forward_matches_jax(variant):
    r = _run(variant)
    gap = max(np.abs(r["pcov"] - r["cov"]).max(), np.abs(r["pproba"] - r["proba"]).max())
    if VARIANTS[variant][2] == "float32":
        assert gap <= 2e-5, gap
        return
    f32 = _run("grouped_unfused")
    jax_gap = max(np.abs(r["cov"] - f32["cov"]).max(), np.abs(r["proba"] - f32["proba"]).max())
    assert gap <= BF16_ATOL < jax_gap, (gap, jax_gap)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_loss_parts_and_gradients_match_jax(variant):
    r = _run(variant)
    assert set(r["comps"]) == set(r["jcomps"])
    loss_gap = max(abs(r["comps"][k] - float(r["jcomps"][k])) for k in r["comps"])
    want, got = _leaves(r["jgrads"]), _leaves(r["grads"])
    assert [k for k, _ in want] == [k for k, _ in got] and len(want) == 32
    grad_rel = _rel(r["grads"], r["jgrads"])
    assert r["launches"] == dict.fromkeys(ck.LAUNCHES, 0)  # the CPU: plain versions
    if VARIANTS[variant][2] == "float32":
        assert loss_gap <= 2e-6 and grad_rel.max() <= 1e-3, (loss_gap, grad_rel.max())
        return
    f32 = _run("grouped_unfused")
    jax_loss_gap = max(abs(float(r["jcomps"][k]) - float(f32["jcomps"][k])) for k in r["comps"])
    jax_grad_rel = _rel(r["jgrads"], f32["jgrads"])
    assert loss_gap <= BF16_LOSS_ATOL < jax_loss_gap, (loss_gap, jax_loss_gap)
    assert grad_rel.max() <= BF16_GRAD_RTOL < jax_grad_rel.max(), (grad_rel, jax_grad_rel)
    assert (grad_rel < jax_grad_rel).all(), (grad_rel, jax_grad_rel)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_bn_state_and_params_match_jax(variant):
    """BN state within 1e-5; params after Adam's first update, -lr * e /
    (|e| + 1e-8) with e = g + wd * p: within 1e-7 plus one ulp where |e|
    exceeds the gradient tolerance (in bfloat16 ten times it: there a
    gradient 6.7e-3 of its max apart moved Adam's eps term by 1.6e-7 at
    |e| = 1.2e-2 of the max), else within 2 lr."""
    r = _run(variant)
    bf16 = VARIANTS[variant][2] == "bfloat16"
    for (name, w), (_, g) in zip(_leaves(r["jstate"]), _leaves(r["state"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    rtol = 10 * BF16_GRAD_RTOL if bf16 else 1e-3
    old = dict(_leaves(_inputs()[0]))
    grads = dict(_leaves(r["jgrads"]))
    got = dict(_leaves(r["params"]))
    for name, w in _leaves(r["jparams"]):
        eff = grads[name] + 1e-3 * old[name]
        sure = np.abs(eff) > rtol * np.abs(grads[name]).max()
        diff = np.abs(got[name] - w)
        assert sure.any() and (diff[sure] <= 1e-7 + 1.2e-7 * np.abs(w[sure])).all(), name
        assert diff.max() <= 2e-3 + 1e-7, name


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_route_keeps_sa_in_float32(monkeypatch, train):
    """On the fused route bfloat16 reaches SA3 onwards only: the SA1 and SA2
    outputs are bit for bit those of the float32 model, the outputs are
    not."""
    seen = []
    real = pointnet2.PointNet2.decode

    def record(self, x0, pos0, x1, pos1, x2, pos2, *args, **kw):
        seen.append((x1.detach().clone(), x2.detach().clone()))
        return real(self, x0, pos0, x1, pos1, x2, pos2, *args, **kw)

    monkeypatch.setattr(pointnet2.PointNet2, "decode", record)
    params, state, eval_state = _inputs()[:3]
    _, _, _, cloud, xyz = _inputs()[:5]
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(subsample_size=N, k1=K1, k2=K2, compute_dtype=dtype)
        assert pointnet2.fused_eligible(cfg)
        model = from_jax_params(params, state if train else eval_state, cfg, device="cpu")
        model.train(train)
        with torch.set_grad_enabled(train):
            outs.append(model(T(cloud[..., 2:]), T(xyz))[1].detach())
    (a1, a2), (b1, b2) = seen
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(outs[0], outs[1])


def test_point_sharded_paths_ignore_the_opt_ins():
    """The point-sharded forward and train step (one rank, a 1x1 mesh) give
    bit for bit the same results whatever the opt-ins say: JAX's
    point_sharded.py hardcodes the grouped selection and float32."""
    params, state, eval_state, cloud, xyz, gt, kde = _inputs()
    mesh = Mesh(1, 1, None, None)
    prior = KdeMixture(kde.grid, kde.pdfs)
    runs = []
    for method, use_pallas, dtype in (("grouped", True, "float32"),
                                      ("nearest", False, "bfloat16")):
        cfg = Config(model=ModelConfig(subsample_size=N, k1=K1, k2=K2, ball_query_method=method,
                                       use_pallas=use_pallas, compute_dtype=dtype))
        model = from_jax_params(params, eval_state, cfg.model, device="cpu")
        cov, proba = pointnet2_forward_point_sharded(model, T(cloud[..., 2:]), T(xyz), cfg, mesh)
        model = from_jax_params(params, state, cfg.model, device="cpu")
        opt, sched = make_optimizer(cfg, model, steps_per_epoch=1)
        comps = make_point_sharded_train_step(cfg, prior, mesh, device="cpu")(
            model, opt, sched, T(cloud), T(xyz), T(gt))
        runs.append([cov, proba, *comps.values(), *(p.grad for p in model.parameters())])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
