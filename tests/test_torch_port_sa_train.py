"""The port's fused train-mode SA interior (`stratanet2_tpu_torch/ops/
sa_train.py`, the four `cuda_kernels.sa_train_*` passes, run here as their
plain versions) against the JAX package on the CPU, and against the port's
own unfused path.

Inputs come from `np.random.default_rng(seed)`: every case has a
negative-gamma channel in each BatchNorm (min routing) and nonzero
statistics shifts. Each tolerance is stated where it is used.

Winner semantics: the fused path sends each output's cotangent to ONE slot,
the first winner; `jnp.max` and `torch.amax` split it among tied slots.
Tied slots hold equal values and feed equal gradient terms, so the two
agree up to rounding; `test_exact_ties_give_the_split_gradients` builds
ties on purpose (repeated picks above zero, and whole centroids at a ReLU's
zero) and holds the fused gradients to the splitting composition.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.models import nn as jnn
from stratanet2_tpu.models.pointnet2 import _sa_train_fused_path
from stratanet2_tpu.ops import farthest_point_sampling as jax_fps
from stratanet2_tpu.ops.pallas_kernels import sa_train_fused as jax_sa_train_fused
from stratanet2_tpu_torch.models.nn import MLP
from stratanet2_tpu_torch.models.pointnet2 import (
    set_abstraction_unfused,
    set_abstraction_train_fused,
)
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.ops.sa_train import sa_train_fused

torch.set_num_threads(1)

GRAD_NAMES = ("q", "cterm", "g1", "b1", "w2", "b2", "g2", "b2n")
# (C1, C2): small widths as in tests/test_sa_train_fused.py, and the widths
# of the two kernel instances (SA1 two layers 16 -> 16, SA2 one layer 32)
WIDTHS = [(6, None), (6, 10), (16, 16), (32, None)]


def T(a):
    return torch.from_numpy(np.array(a))


def _unfused(q, cterm, scales, biases, w2, b2, idx, mask):
    """The exact composition the fused kernels replace, idx/mask in the
    (B, K, C) layout (copied from tests/test_sa_train_fused.py). Returns
    (out, [(mean, biased_var), ...])."""
    b, n, c1 = q.shape
    flat = q.reshape(b * n, c1)
    off = (jnp.arange(b) * n)[:, None, None]
    sel = jnp.take(flat, (idx + off).reshape(-1), axis=0).reshape(
        idx.shape + (c1,)
    )  # (B, K, C, C1)
    h = jax.nn.relu(sel - cterm[:, None, :, :])
    stats = []

    def bn(x, gamma, beta):
        m = mask.astype(jnp.float32)[..., None]
        cnt = jnp.maximum(jnp.sum(m), 1.0)
        mean = jnp.sum(x * m, axis=(0, 1, 2)) / cnt
        var = jnp.maximum(
            jnp.sum(x * x * m, axis=(0, 1, 2)) / cnt - mean * mean, 0.0
        )
        stats.append((mean, var))
        return (x - mean) * jax.lax.rsqrt(var + jnn.BN_EPS) * gamma + beta

    h = bn(h, scales[0], biases[0])
    if w2 is not None:
        h = jax.nn.relu(h @ w2 + b2)
        h = bn(h, scales[1], biases[1])
    h = jnp.where(mask[..., None], h, -1e30)
    return jnp.max(h, axis=1), stats


def _setup(seed, c1, c2, b=2, n=96, c=24, k=8, radius=1.2):
    """Numpy inputs of one SA interior: idx/mask (B, C, K) from the port's
    grouped ball query (plain), gamma[0] (and gamma2[1]) negative, nonzero
    shifts, a random output cotangent."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    idx, mask = ck.ball_query(T(pos[:, :c]), T(pos), radius, k)
    d = dict(idx=idx.numpy(), mask=mask.numpy(),
             q=rng.normal(size=(b, n, c1)).astype(np.float32),
             cterm=(rng.normal(size=(b, c, c1)) * 0.3).astype(np.float32),
             g1=rng.uniform(0.5, 1.5, c1).astype(np.float32),
             b1=(rng.normal(size=c1) * 0.2).astype(np.float32),
             shift1=(rng.normal(size=c1) * 0.3).astype(np.float32))
    d["g1"][0] = -0.7
    if c2 is not None:
        d.update(w2=(rng.normal(size=(c1, c2)) * 0.5).astype(np.float32),
                 b2=(rng.normal(size=c2) * 0.2).astype(np.float32),
                 g2=rng.uniform(0.5, 1.5, c2).astype(np.float32),
                 b2n=(rng.normal(size=c2) * 0.2).astype(np.float32),
                 shift2=(rng.normal(size=c2) * 0.3).astype(np.float32))
        d["g2"][1] = -0.9
    d["cw"] = rng.normal(size=(b, c, c2 or c1)).astype(np.float32)
    return d


def _names(d):
    return [name for name in GRAD_NAMES if name in d]


def _port_run(d):
    """The port's sa_train_fused (plain versions): out, stats, M and the
    gradients of sum(out * cw) in every differentiable input."""
    leaves = {name: T(d[name]).requires_grad_() for name in _names(d)}
    two = "w2" in d
    scales = (leaves["g1"], leaves["g2"]) if two else (leaves["g1"],)
    biases = (leaves["b1"], leaves["b2n"]) if two else (leaves["b1"],)
    shifts = (T(d["shift1"]), T(d["shift2"])) if two else (T(d["shift1"]),)
    ck.reset_launches()
    out, stats, me = sa_train_fused(
        leaves["q"], leaves["cterm"], scales, biases, leaves.get("w2"), leaves.get("b2"),
        T(d["idx"]).int(), T(d["mask"]), bn_shifts=shifts,
    )
    assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)  # CPU: plain versions
    (out * T(d["cw"])).sum().backward()
    return (out.detach().numpy(), [(m.numpy(), v.numpy()) for m, v in stats], float(me),
            {name: t.grad.numpy() for name, t in leaves.items()})


def _jax_run(d, fn):
    """fn(args, idx_kc, mask_kc) -> (out, stats) on the JAX side: out, stats
    and the gradients of sum(out * cw)."""
    names = _names(d)
    idx_kc = jnp.asarray(np.swapaxes(d["idx"], 1, 2).astype(np.int32))
    mask_kc = jnp.asarray(np.swapaxes(d["mask"], 1, 2))
    args = tuple(jnp.asarray(d[name]) for name in names)

    def loss(*a):
        out, stats = fn(dict(zip(names, a)), idx_kc, mask_kc)
        return jnp.sum(out * d["cw"]), (out, stats)

    (_, (out, stats)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return (np.asarray(out), [(np.asarray(m), np.asarray(v)) for m, v in stats],
            dict(zip(names, map(np.asarray, grads))))


def _layers(a):
    if "w2" in a:
        return (a["g1"], a["g2"]), (a["b1"], a["b2n"]), a["w2"], a["b2"]
    return (a["g1"],), (a["b1"],), None, None


def _assert_grads(got, want, rel, what=""):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=f"{what} gradient in {name}")


@pytest.mark.parametrize("c1,c2", WIDTHS)
def test_matches_xla_composition(c1, c2):
    """Against the exact XLA composition (gather + masked-BN MLP + max):
    out and per-layer (mean, biased var) within 2e-5 (float32 rounding of
    the statistics, here over ~300 edges, summed in another order and
    shifted), M equal to the mask count, every gradient within 1e-4 of its
    leaf's max."""
    d = _setup(10 + c1, c1, c2)
    out, stats, me, grads = _port_run(d)

    def fn(a, idx_kc, mask_kc):
        scales, biases, w2, b2 = _layers(a)
        return _unfused(a["q"], a["cterm"], scales, biases, w2, b2, idx_kc, mask_kc)

    w_out, w_stats, w_grads = _jax_run(d, fn)
    assert me == d["mask"].sum()
    np.testing.assert_allclose(out, w_out, rtol=0, atol=2e-5)
    for (m, v), (wm, wv) in zip(stats, w_stats):
        np.testing.assert_allclose(m, wm, rtol=0, atol=2e-5)
        np.testing.assert_allclose(v, wv, rtol=0, atol=2e-5)
    _assert_grads(grads, w_grads, 1e-4)


@pytest.mark.parametrize("c1,c2", [(6, None), (6, 10)])
def test_matches_jax_sa_train_fused(c1, c2):
    """Against JAX's `sa_train_fused` itself (its Pallas kernels in
    interpret mode, as tests/test_sa_train_fused.py runs them) with the same
    nonzero shifts: out, stats and gradients within that test's rtol 1e-3,
    atol 1e-4 (the Pallas side's hi/lo-bf16 dots drop the lo*lo terms)."""
    d = _setup(20 + c1, c1, c2)
    out, stats, me, grads = _port_run(d)

    def fn(a, idx_kc, mask_kc):
        scales, biases, w2, b2 = _layers(a)
        shifts = tuple(jnp.asarray(d[s]) for s in ("shift1", "shift2") if s in d)
        o, st, _ = jax_sa_train_fused(a["q"], a["cterm"], scales, biases, w2, b2, idx_kc,
                                      mask_kc, k=idx_kc.shape[1], bn_shifts=shifts)
        return o, st

    w_out, w_stats, w_grads = _jax_run(d, fn)
    np.testing.assert_allclose(out, w_out, rtol=1e-3, atol=1e-4)
    for (m, v), (wm, wv) in zip(stats, w_stats):
        np.testing.assert_allclose(m, wm, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(v, wv, rtol=1e-3, atol=1e-4)
    for name, w in w_grads.items():
        np.testing.assert_allclose(grads[name], w, rtol=1e-3, atol=1e-4, err_msg=name)


def test_exact_ties_give_the_split_gradients():
    """Ties built on purpose, two layers: in every centroid slots 0 and 1
    pick the same point (equal edges on every channel, above zero where the
    channel's max is), and in the first 6 centroids of each cloud every
    valid slot picks a point whose q row is far below cterm, so h1 = 0 on
    all channels and all K slots tie at every channel of both layers. The
    fused path routes each cotangent to one slot, the XLA composition splits
    it; out within 2e-5 and every gradient within 1e-4 of its leaf's max,
    as in `test_matches_xla_composition`."""
    d = _setup(7, 16, 16)
    d["idx"][:, :, 1] = d["idx"][:, :, 0]
    d["mask"][:, :, 1] = d["mask"][:, :, 0]
    low = d["idx"][:, :6].reshape(2, -1)
    for bi in range(2):
        d["q"][bi, low[bi]] = -50.0
    out, _, _, grads = _port_run(d)

    def fn(a, idx_kc, mask_kc):
        scales, biases, w2, b2 = _layers(a)
        return _unfused(a["q"], a["cterm"], scales, biases, w2, b2, idx_kc, mask_kc)

    w_out, _, w_grads = _jax_run(d, fn)
    np.testing.assert_allclose(out, w_out, rtol=0, atol=2e-5)
    _assert_grads(grads, w_grads, 1e-4)


def test_winner_rules_of_the_plain_versions():
    """sa_train_main's winners: the first slot on a tie (strict > and <),
    masked slots never win even with the largest value, vmax/vmin equal the
    masked max/min; the fused output takes the min where gamma < 0; M is
    the mask count."""
    b, n, c, k, ch = 1, 8, 2, 4, 2
    q = torch.zeros((b, n, ch))
    q[0, 1] = torch.tensor([3.0, 1.0])
    q[0, 2] = torch.tensor([3.0, 5.0])  # ties point 1 on channel 0
    q[0, 3] = torch.tensor([9.0, 9.0])  # the largest, but masked
    q[0, 4] = torch.tensor([0.5, 0.5])
    idx = torch.tensor([[[3, 1, 2, 4], [4, 2, 1, 3]]], dtype=torch.int32)
    mask = torch.tensor([[[False, True, True, True], [True, True, True, False]]])
    cterm = torch.zeros((b, c, ch))
    aff = ck.sa_aff(ch, shift_l=torch.zeros(ch))
    _, _, vmax, vmin, amax, amin = ck.sa_train_main(q, cterm, idx, mask, aff, None)
    assert amax.tolist() == [[[1, 2], [1, 1]]]  # centroid 0 ch 0: slots 1, 2 tie at 3
    assert vmax.tolist() == [[[3.0, 5.0], [3.0, 5.0]]]
    assert amin.tolist() == [[[3, 3], [0, 0]]]
    assert vmin.tolist() == [[[0.5, 0.5], [0.5, 0.5]]]
    gamma = torch.tensor([1.0, -1.0])
    out, ((mean, var),), me = sa_train_fused(q, cterm, [gamma], [torch.zeros(ch)], None, None,
                                             idx, mask, bn_shifts=[torch.zeros(ch)])
    assert float(me) == int(mask.sum()) == 6
    inv = torch.rsqrt(var + 1e-5) * gamma
    want = torch.stack([vmax[..., 0], vmin[..., 1]], -1) * inv + (0.0 - mean * inv)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the SA stage: against JAX's fused stage and the port's unfused stage
# ---------------------------------------------------------------------------

STAGES = [([11, 16, 16], 8, 2 ** 0.5), ([19, 32], 16, 8 ** 0.5)]  # SA1, SA2 channel plans


def _stage_inputs(seed, channels):
    """A JAX MLP with random BN affine and running state, the same weights
    in a port MLP (train mode), a cloud of 2 x 256 points and a cotangent."""
    rng = np.random.default_rng(seed)
    p, s = jnn.init_mlp(jax.random.PRNGKey(seed), channels)
    p = jax.tree_util.tree_map(np.asarray, p)
    s = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), s)
    mlp = MLP(channels)
    with torch.no_grad():
        for layer, lp, ls in zip(mlp.layers, p["layers"], s["layers"]):
            ch = lp["bn"]["scale"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
            lp["bn"]["scale"][0] = -0.8
            lp["bn"]["bias"] = rng.normal(0, 0.1, ch).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, ch).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
            layer.linear.w.copy_(T(lp["linear"]["w"]))
            layer.linear.b.copy_(T(lp["linear"]["b"]))
            layer.bn.scale.copy_(T(lp["bn"]["scale"]))
            layer.bn.bias.copy_(T(lp["bn"]["bias"]))
            layer.bn.mean.copy_(T(ls["mean"]))
            layer.bn.var.copy_(T(ls["var"]))
    x = rng.uniform(0, 1, (2, 256, channels[0] - 3)).astype(np.float32)
    pos = rng.uniform(-3, 3, (2, 256, 3)).astype(np.float32)
    gy = rng.normal(size=(2, 64, channels[-1])).astype(np.float32)
    return p, s, mlp.train(), x, pos, gy


def _port_stage(mlp, x, pos, gy, radius, k, fused, preproject=False):
    mlp = copy.deepcopy(mlp)
    xt = T(x).requires_grad_()
    if fused:
        out, cent = set_abstraction_train_fused(mlp, xt, T(pos), 64, radius, k, 1, 256)
    else:
        out, cent = set_abstraction_unfused(mlp, xt, T(pos), 64, radius, k, 1, 256,
                                          preproject=preproject)
    (out * T(gy)).sum().backward()
    grads = {"x": xt.grad.numpy()}
    for i, layer in enumerate(mlp.layers):
        for name, prm in (("w", layer.linear.w), ("b", layer.linear.b),
                          ("scale", layer.bn.scale), ("bias", layer.bn.bias)):
            grads[f"{i}.{name}"] = prm.grad.numpy()
    state = {f"{i}.{name}": getattr(layer.bn, name).numpy()
             for i, layer in enumerate(mlp.layers) for name in ("mean", "var")}
    return out.detach().numpy(), cent.numpy(), state, grads


@pytest.mark.parametrize("channels,k,radius", STAGES)
def test_stage_matches_jax_sa_train_fused_path(channels, k, radius):
    """`set_abstraction_train_fused` against JAX's `_sa_train_fused_path`
    (its Pallas ball query and SA train kernels in interpret mode) from the
    same weights and running state: equal centroids; out within rtol 1e-3,
    atol 1e-4 (hi/lo-bf16 gathers and dots on the Pallas side, as in
    `test_matches_jax_sa_train_fused`); BN running state within 1e-6; the
    gradients in every parameter and in x within 1e-3 of each leaf's max."""
    p, s, mlp, x, pos, gy = _stage_inputs(31, channels)
    cent_idx = jax_fps(jnp.asarray(pos), 64, use_pallas=False)
    want_cent = np.take_along_axis(pos, np.asarray(cent_idx)[..., None].astype(np.int64), 1)

    def jax_fn(p, x):
        out, _, ns = _sa_train_fused_path(p, s, x, jnp.asarray(pos), jnp.asarray(want_cent),
                                          radius, k)
        return jnp.sum(out * gy), (out, ns)

    (_, (w_out, w_s)), (gp, gx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    out, cent, state, grads = _port_stage(mlp, x, pos, gy, radius, k, fused=True)
    np.testing.assert_array_equal(cent, want_cent)
    np.testing.assert_allclose(out, np.asarray(w_out), rtol=1e-3, atol=1e-4)
    for i, ls in enumerate(w_s["layers"]):
        for name in ("mean", "var"):
            np.testing.assert_allclose(state[f"{i}.{name}"], np.asarray(ls[name]), rtol=0,
                                       atol=1e-6)
    want = {"x": np.asarray(gx)}
    for i, lp in enumerate(gp["layers"]):
        want.update({f"{i}.w": lp["linear"]["w"], f"{i}.b": lp["linear"]["b"],
                     f"{i}.scale": lp["bn"]["scale"], f"{i}.bias": lp["bn"]["bias"]})
    _assert_grads(grads, {kk: np.asarray(v) for kk, v in want.items()}, 1e-3, "JAX fused")


@pytest.mark.parametrize("channels,k,radius", STAGES)
def test_fused_stage_matches_unfused_stage(channels, k, radius):
    """The port's fused stage against its unfused `set_abstraction_unfused`
    (SA1's form for two layers, SA2's pre-projected form for one) on the
    same weights, nonzero running means and inputs: equal centroids, out
    within rtol 1e-3, atol 5e-5, BN running state within 1e-6, every
    gradient within 1e-3 of its leaf's max. Both take the shifted one-pass
    variance sq/M - (s/M)^2 with the running mean as the shift; the unfused
    BatchNorm sums in float32, the plain passes in float64. A random shift
    far from a ReLU channel's batch mean makes the two terms cancel (by up
    to ~1e3 here), and BN then divides by that channel's small std: the
    normalised outputs of such channels reach ~20 and differ by up to 4e-4
    of their value, and the gradient in x by up to 2.3e-4 of its max."""
    _, _, mlp, x, pos, gy = _stage_inputs(41, channels)
    f_out, f_cent, f_state, f_grads = _port_stage(mlp, x, pos, gy, radius, k, fused=True)
    u_out, u_cent, u_state, u_grads = _port_stage(mlp, x, pos, gy, radius, k, fused=False,
                                                  preproject=len(channels) == 2)
    np.testing.assert_array_equal(f_cent, u_cent)
    np.testing.assert_allclose(f_out, u_out, rtol=1e-3, atol=5e-5)
    for name, v in u_state.items():
        np.testing.assert_allclose(f_state[name], v, rtol=0, atol=1e-6, err_msg=name)
    _assert_grads(f_grads, u_grads, 1e-3, "unfused")
