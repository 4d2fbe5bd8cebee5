"""The PyTorch port's ops (stratanet2_tpu_torch/ops) against the JAX package
on the CPU. Inputs come from numpy with a seed and go to both sides.

On the CPU every kernel wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py. Selections (FPS, grouped ball query, kNN, pixel argmax) must
agree index for index; values agree to float32 rounding, with each
tolerance stated where it is used. The backward ops of the train step (the
scatter behind the kNN and gather gradients, the pixel-max backward) are
held to `jax.vjp` of their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.models import nn as jnn
from stratanet2_tpu.models.pointnet2 import _sa_module
from stratanet2_tpu.ops import ball_query, projection as jproj
from stratanet2_tpu.ops import farthest_point_sampling as jax_fps
from stratanet2_tpu.ops import knn_interpolate as jax_knn
from stratanet2_tpu.ops.fps import _fps_lax
from stratanet2_tpu.ops.knn import _iterative_min_k
from stratanet2_tpu.ops.pallas_kernels import (
    _knn_scatter_pallas,
    gather_rows as jax_gather_rows,
    pixel_max_pallas,
    scatter_add_pallas,
)
from stratanet2_tpu_torch.models.nn import MLP
from stratanet2_tpu_torch.models.pointnet2 import set_abstraction
from stratanet2_tpu_torch.ops import (
    ball_query_grouped,
    batched_raster_projection,
    cuda_kernels as ck,
    farthest_point_sampling,
    knn_interpolate,
    plotwise_coverages,
    raster_projection,
)
from stratanet2_tpu_torch.ops import projection as tproj
from stratanet2_tpu_torch.ops.gather import gather_rows

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, b, n, extent=5.0):
    xyz = rng.uniform(-extent, extent, (b, n, 3)).astype(np.float32)
    xyz[0, n // 2 : n // 2 + 4] = xyz[0, 3]  # duplicate points: exact ties
    return xyz


def _exact_fma_f32(a, b, c):
    """a*b + c for float32 scalars in exact rational arithmetic, rounded
    once to float32 (ties to even)."""
    from fractions import Fraction

    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(x)) - v) for x in cands]
    best = [x for x, e in zip(cands, err) if e == min(err)]
    return min(best, key=lambda x: int(x.view(np.int32)) & 1)


class TestDistanceRounding:
    """XLA's CPU path computes each 3-term sum of products as a chain of
    fused multiply-adds; the port's distances (and its kernels, on the
    card) round the same way, so the two packages agree bit for bit on every
    distance a selection compares.

    That parity rests on XLA's CPU backend contracting those sums into FMAs
    on the host that runs the tests (its fp-contract default and the host's
    FMA support). `test_xla_cpu_contracts_sums_into_fmas` checks that
    premise on its own, so a change of XLA or host fails there, with that
    message, and not only as an index mismatch of the port."""

    def test_xla_cpu_contracts_sums_into_fmas(self, rng):
        p = rng.uniform(-10, 10, (400, 3)).astype(np.float32)
        got = np.asarray(jax.jit(lambda p: jnp.sum(p * p, -1))(jnp.asarray(p)))
        fused = np.array([_exact_fma_f32(z, z, _exact_fma_f32(y, y, x * x)) for x, y, z in p],
                         np.float32)
        unfused = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
        assert (fused != unfused).any()  # the inputs tell the two roundings apart
        assert np.array_equal(got, fused), (
            "XLA's CPU backend no longer computes |p|^2 as fma(z, z, fma(y, y, x*x)) on "
            "this host; the port's bit-parity tests against JAX assume it does"
        )

    def test_bitwise_equal_to_jax(self, rng):
        from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

        p = rng.uniform(-10, 10, (2, 300, 3)).astype(np.float32)
        c = p[:, :40]
        last = 7

        def jax_side(c, p):
            cp = jax.lax.dot_general(c, jnp.swapaxes(p, 1, 2), (((2,), (1,)), ((0,), (0,))),
                                     precision=jax.lax.Precision.HIGHEST)
            d2 = (jnp.sum(c * c, -1, keepdims=True) - 2.0 * cp
                  + jnp.sum(p * p, -1)[:, None, :])
            diff = p - p[:, last : last + 1]
            return jnp.sum(p * p, -1), jnp.maximum(d2, 0.0), jnp.sum(diff * diff, -1)

        want_sq, want_d2, want_fps = map(np.asarray, jax.jit(jax_side)(c, p))
        np.testing.assert_array_equal(sq_norm3(T(p)).numpy(), want_sq)
        got_d2 = expanded_d2(T(c), sq_norm3(T(c)), T(p), sq_norm3(T(p)))
        np.testing.assert_array_equal(got_d2.numpy(), want_d2)
        np.testing.assert_array_equal(sq_norm3(T(p) - T(p)[:, last : last + 1]).numpy(),
                                      want_fps)

    def test_fma_is_correctly_rounded(self, rng):
        """fma_f32 against exact rational arithmetic, including a sum that a
        plain float64 fma would round onto a float32 midpoint and then the
        wrong way: a*b + c = 1 + 2^-23 + 2^-24 - 2^-60 must give 1 + 2^-23."""
        from stratanet2_tpu_torch.ops.distance import fma_f32

        a = (rng.uniform(-1, 1, 3000) * 2.0 ** rng.integers(-20, 20, 3000)).astype(np.float32)
        b = (rng.uniform(-1, 1, 3000) * 2.0 ** rng.integers(-20, 20, 3000)).astype(np.float32)
        c = (rng.uniform(-1, 1, 3000) * 2.0 ** rng.integers(-20, 20, 3000)).astype(np.float32)
        a = np.append(a, np.float32(2.0 ** -12 * (1 + 2.0 ** -18)))
        b = np.append(b, np.float32(2.0 ** -12 * (1 - 2.0 ** -18)))
        c = np.append(c, np.float32(1 + 2.0 ** -23))
        got = fma_f32(T(a), T(b), T(c)).numpy()
        want = np.array([_exact_fma_f32(*t) for t in zip(a, b, c)], np.float32)
        np.testing.assert_array_equal(got, want)
        assert got[-1] == np.float32(1 + 2.0 ** -23)


def _tie_cloud(rng, kind, b, n):
    """Clouds where many picks meet exactly equal running minima: points on
    an integer grid (equal distances everywhere, few distinct positions) or
    every point repeated four times (a repeat's minimum is 0 once its twin
    is picked, and with S = N every pick after the distinct points is a
    tie among zeros)."""
    if kind == "grid":
        return rng.integers(0, 6, (b, n, 3)).astype(np.float32)
    base = rng.uniform(-3, 3, (b, -(-n // 4), 3)).astype(np.float32)
    return np.repeat(base, 4, axis=1)[:, :n].copy()


class TestFPS:
    @pytest.mark.parametrize("kind", ["grid", "dup"])
    @pytest.mark.parametrize("n,s", [(77, 1), (77, 77), (1100, 1100)])
    def test_plain_matches_fps_lax_on_ties(self, rng, kind, n, s):
        """Index for index against `_fps_lax` on tie-heavy clouds: the first
        maximum wins every tie. N is a multiple of neither 32 nor 1024 (the
        kernel's warp and block); S=1 is the start alone, S=N every point."""
        xyz = _tie_cloud(rng, kind, 2, n)
        start = np.array([0, n - 1], np.int32)
        want = jax.vmap(lambda p, st: _fps_lax(p, s, st))(jnp.asarray(xyz), jnp.asarray(start))
        got = ck.fps(T(xyz), s, T(start))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if s == n:  # the picks outran the distinct positions: ties among zero minima
            assert len(np.unique(got.numpy()[0])) < n

    @pytest.mark.parametrize("kind", ["grid", "dup"])
    def test_partitioned_ties_match_jax(self, rng, kind):
        """The partitioned path (N=2048, parts=2, S=N) on tie-heavy clouds,
        through `farthest_point_sampling` on both sides."""
        xyz = _tie_cloud(rng, kind, 2, 2048)
        start = np.array([5, 1500], np.int32)
        want = jax_fps(jnp.asarray(xyz), 2048, start_idx=jnp.asarray(start),
                       use_pallas=False, parts=2)
        got = farthest_point_sampling(T(xyz), 2048, start_idx=T(start), parts=2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_plain_matches_fps_lax(self, rng):
        xyz = _cloud(rng, 2, 256)
        start = np.array([0, 17], np.int32)
        want = jax.vmap(lambda p, s: _fps_lax(p, 64, s))(jnp.asarray(xyz), jnp.asarray(start))
        got = ck.fps(T(xyz), 64, T(start))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("start", [0, [1500, 37]])
    def test_partitioned_matches_jax(self, rng, start):
        """N=2048, S=512, parts=2: 256 picks per part, so the partitioned
        path engages on both sides (shared start residue, offset parts,
        start swapped into slot 0)."""
        xyz = _cloud(rng, 2, 2048, extent=10.0)
        want = jax_fps(jnp.asarray(xyz), 512, start_idx=jnp.asarray(start, jnp.int32),
                       use_pallas=False, parts=2)
        got = farthest_point_sampling(T(xyz), 512, start_idx=torch.tensor(start), parts=2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[:, 0].tolist() == np.broadcast_to(start, (2,)).tolist()


class TestBallQueryGrouped:
    @pytest.mark.parametrize(
        "n,k,c,radius",
        [
            (256, 8, 64, 1.0),  # N divisible by K
            (250, 8, 60, 1.5),  # ragged last group (g=32, 26 real)
            (100, 16, 30, 2.0),  # g=7: group 14 has 2 real points, group 15 none
        ],
    )
    def test_matches_jax(self, rng, n, k, c, radius):
        pts = _cloud(rng, 2, n, extent=3.0)
        cent = pts[:, rng.choice(n, c, replace=False)]
        want_idx, want_mask = ball_query(jnp.asarray(cent), jnp.asarray(pts), radius, k,
                                         method="grouped")
        idx, mask = ball_query_grouped(T(cent), T(pts), radius, k)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        assert 0 < mask.float().mean() < 1  # both valid and masked slots occur

    @pytest.mark.parametrize("kind", ["grid", "dup"])
    @pytest.mark.parametrize(
        "n,k,c,radius",
        [
            (300, 8, 40, 2 ** 0.5),  # PROD SA1 radius: r^2 rounds to 1.9999999, d2 = 2 just outside
            (300, 8, 40, 8 ** 0.5),  # PROD SA2 radius: r^2 rounds to 7.9999995
            (300, 8, 40, 2.0),  # r^2 = 4 exactly: the points at d2 = 4 are inside
            (103, 16, 30, 8 ** 0.5),  # g=7: group 14 has 5 real points, group 15 none
        ],
    )
    def test_matches_jax_on_ties(self, rng, kind, n, k, c, radius):
        """Tie-heavy and boundary clouds, the cases the selection kernels'
        first-index rule and radius test decide: integer-grid points (every
        d2 an exact integer, many at the radius) or every point repeated
        four times; centroids are points of the cloud. Index for index."""
        pts = _tie_cloud(rng, kind, 2, n)
        cent = pts[:, rng.choice(n, c, replace=False)]
        want_idx, want_mask = ball_query(jnp.asarray(cent), jnp.asarray(pts), radius, k,
                                         method="grouped")
        idx, mask = ball_query_grouped(T(cent), T(pts), radius, k)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        g = -(-n // k)
        d2 = ((cent[:, :, None, :].astype(np.float64) - pts[:, None]) ** 2).sum(-1)
        d2 = np.pad(d2, ((0, 0), (0, 0), (0, k * g - n)), constant_values=np.inf)
        d2 = d2.reshape(2, c, k, g)
        best = d2.min(-1, keepdims=True)
        tied = ((d2 == best) & (best <= radius ** 2)).sum(-1) > 1
        assert tied.any()  # some valid picks are first-index ties
        if (k - 1) * g >= n:
            assert not mask.numpy()[..., -1].any()  # the empty last group
        if kind == "grid":  # points at d2 = 2, 8 or 4: on or one ulp past the radius
            assert (d2 == round(radius ** 2)).any()


def _jax_mlp(rng, channels):
    """A JAX MLP with random BN affines and running statistics (so the
    port's BN fold is exercised) and the same weights as a port MLP."""
    p, s = jnn.init_mlp(jax.random.PRNGKey(int(rng.integers(1 << 30))), channels)
    p = jax.tree_util.tree_map(np.asarray, p)
    s = jax.tree_util.tree_map(np.asarray, s)
    for lp, ls in zip(p["layers"], s["layers"]):
        c = ls["mean"].shape[0]
        lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    mlp = MLP(channels)
    with torch.no_grad():
        for layer, lp, ls in zip(mlp.layers, p["layers"], s["layers"]):
            layer.linear.w.copy_(T(lp["linear"]["w"]))
            layer.linear.b.copy_(T(lp["linear"]["b"]))
            layer.bn.scale.copy_(T(lp["bn"]["scale"]))
            layer.bn.bias.copy_(T(lp["bn"]["bias"]))
            layer.bn.mean.copy_(T(ls["mean"]))
            layer.bn.var.copy_(T(ls["var"]))
    return p, s, mlp


class TestSetAbstraction:
    @pytest.mark.parametrize(
        "channels,n,c,k,radius,preproject",
        [
            ([11, 16, 16], 256, 64, 8, 2 ** 0.5, False),  # SA1: two layers, concat route
            ([19, 32], 256, 64, 16, 8 ** 0.5, True),  # SA2: one layer, preprojected
        ],
    )
    def test_plain_matches_jax_sa_module(self, rng, channels, n, c, k, radius, preproject):
        """Port: fused route (q - cterm, folded BN). JAX: its XLA path
        (`use_pallas=False`, grouped). The two differ by rounding only
        (layer 1 distributed over the edge concat, BN folded into one
        affine), hence atol 2e-5 on outputs in the unit range."""
        p, s, mlp = _jax_mlp(rng, channels)
        x = rng.uniform(0, 1, (2, n, channels[0] - 3)).astype(np.float32)
        pos = _cloud(rng, 2, n, extent=3.0)
        want, want_cent, _ = _sa_module(
            p, s, jnp.asarray(x), jnp.asarray(pos), c, radius, k, train=False,
            compute_dtype=jnp.float32, use_pallas=False, chunk=1024,
            bq_method="grouped", preproject=preproject,
        )
        with torch.no_grad():
            got, cent = set_abstraction(mlp, T(x), T(pos), c, radius, k,
                                        fps_parts=1, fps_min_part_samples=256)
        np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    @pytest.mark.parametrize(
        "channels,kind,n,c,k,radius,preproject",
        [
            ([11, 16, 16], "grid", 256, 64, 8, 2 ** 0.5, False),
            ([19, 32], "grid", 256, 64, 16, 8 ** 0.5, True),
            ([11, 16, 16], "dup", 103, 32, 16, 2.0, False),  # g=7, group 15 empty
            ([19, 32], "dup", 103, 32, 16, 8 ** 0.5, True),
        ],
    )
    def test_plain_matches_jax_sa_module_on_ties(self, rng, channels, kind, n, c, k, radius,
                                                 preproject):
        """`test_plain_matches_jax_sa_module` on tie-heavy and boundary
        clouds (`_tie_cloud`: integer grids at the PROD radii, repeated
        points, N not a multiple of K with an empty last group): the same
        centroids and, within the same tolerance, the same outputs."""
        p, s, mlp = _jax_mlp(rng, channels)
        x = rng.uniform(0, 1, (2, n, channels[0] - 3)).astype(np.float32)
        pos = _tie_cloud(rng, kind, 2, n)
        want, want_cent, _ = _sa_module(
            p, s, jnp.asarray(x), jnp.asarray(pos), c, radius, k, train=False,
            compute_dtype=jnp.float32, use_pallas=False, chunk=1024,
            bq_method="grouped", preproject=preproject,
        )
        with torch.no_grad():
            got, cent = set_abstraction(mlp, T(x), T(pos), c, radius, k,
                                        fps_parts=1, fps_min_part_samples=256)
        np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def _jax_knn_idx(ps, pt):
    """The 3 indices `_knn_single` (stratanet2_tpu/ops/knn.py:71-96) selects
    (it returns only the interpolated features)."""

    def one(ps1, pt1):
        tp = jax.lax.dot_general(pt1, ps1.T, (((1,), (0,)), ((), ())),
                                 precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.sum(pt1 * pt1, -1, keepdims=True) - 2.0 * tp + jnp.sum(ps1 * ps1, -1)[None]
        return _iterative_min_k(jnp.maximum(d2, 0.0), 3)[1]

    return jax.jit(jax.vmap(one))(ps, pt)


class TestKnnInterpolate:
    def test_plain_matches_jax(self, rng):
        """atol 1e-5: same selections and weights; the 3-term weighted sum
        may round in another order."""
        src = _cloud(rng, 2, 128)
        tgt = rng.uniform(-5, 5, (2, 512, 3)).astype(np.float32)
        tgt[0, :4] = src[0, 3]  # targets on a source that has duplicates
        x = rng.normal(size=(2, 128, 34)).astype(np.float32)
        want = jax_knn(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), k=3, use_pallas=False)
        out, idx, w = ck.knn_interpolate(T(x), T(src), T(tgt))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        want_idx = np.asarray(_jax_knn_idx(jnp.asarray(src), jnp.asarray(tgt)))
        np.testing.assert_array_equal(idx.numpy(), want_idx.transpose(0, 2, 1))
        np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
        got = knn_interpolate(T(x), T(src), T(tgt))
        np.testing.assert_array_equal(got.numpy(), out.numpy())

    @staticmethod
    def _tie_clouds(rng, kind):
        """(src (2, S, 3), tgt (2, T, 3)) where many d2 are equal or zero."""
        if kind == "grid":  # integer coordinates: d2 takes few values
            return (rng.integers(0, 4, (2, 200, 3)).astype(np.float32),
                    rng.integers(0, 4, (2, 300, 3)).astype(np.float32))
        if kind == "duplicated_sources":  # every source three times, shuffled
            base = rng.uniform(-5, 5, (2, 40, 3)).astype(np.float32)
            src = np.repeat(base, 3, axis=1)[:, rng.permutation(120)]
            return src, rng.uniform(-5, 5, (2, 257, 3)).astype(np.float32)
        if kind == "targets_on_sources":  # d2 = 0 (the 1e-16 clamp), some to duplicates
            src = rng.uniform(-5, 5, (2, 96, 3)).astype(np.float32)
            src[:, 50:60] = src[:, 10:20]
            return src, np.concatenate([src, src[:, ::-1], src[:, 5:25]], 1)
        if kind == "s3":
            return (rng.uniform(-5, 5, (2, 3, 3)).astype(np.float32),
                    rng.uniform(-5, 5, (2, 77, 3)).astype(np.float32))
        # "ragged": S and T not multiples of 32, a few grid points among them
        src = rng.uniform(-2, 2, (2, 37, 3)).astype(np.float32)
        src[:, :9] = rng.integers(-1, 2, (2, 9, 3))
        tgt = rng.uniform(-2, 2, (2, 45, 3)).astype(np.float32)
        tgt[:, :15] = rng.integers(-1, 2, (2, 15, 3))
        return src, tgt

    @pytest.mark.parametrize(
        "kind", ["grid", "duplicated_sources", "targets_on_sources", "s3", "ragged"])
    def test_plain_matches_jax_on_ties(self, rng, kind):
        """The plain version against `_knn_single` where many d2 tie, lowest
        index first: indices equal, outputs within 1e-5 (see above)."""
        src, tgt = self._tie_clouds(rng, kind)
        x = rng.normal(size=(2, src.shape[1], 34)).astype(np.float32)
        want = jax_knn(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), k=3, use_pallas=False)
        want_idx = np.asarray(_jax_knn_idx(jnp.asarray(src), jnp.asarray(tgt)))
        out, idx, w = ck.knn_interpolate(T(x), T(src), T(tgt))
        np.testing.assert_array_equal(idx.numpy(), want_idx.transpose(0, 2, 1))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        assert np.isfinite(w.numpy()).all()
        np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)


class TestPixelMax:
    @pytest.mark.parametrize("n,lo,hi", [(700, -5, 405), (333, 0, 250)])
    def test_plain_matches_pallas_interpret(self, rng, n, lo, hi):
        """Against the Pallas kernel run in interpret mode, as
        tests/test_ops.py runs it: quantised values make ties (lowest index
        wins), ids outside [0, 400) match nothing, and empty pixels give
        -3.4e38 / -1."""
        pix = rng.integers(lo, hi, (3, n)).astype(np.int32)
        vals = (rng.integers(0, 6, (3, n, 3)) / 6).astype(np.float32)
        want_v, want_a = pixel_max_pallas(jnp.asarray(pix), jnp.asarray(vals), 400)
        got_v, got_a = ck.pixel_max(T(pix), T(vals), 400)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        assert (got_a.numpy() == -1).any()  # empty pixels occur


class TestBackward:
    """The scatter behind the kNN and gather gradients, and the pixel-max
    backward, against the JAX package."""

    @staticmethod
    def _scatter_inputs(rng, k, weighted):
        b, t, s, f = 2, 300, 77, (34 if k == 3 else 32)
        idx = rng.integers(0, s, (b, k, t)).astype(np.int32)
        idx[0, :, :5] = 3  # repeated destinations
        w = rng.uniform(0, 1, (b, k, t)).astype(np.float32) if weighted else None
        g = rng.normal(size=(b, t, f)).astype(np.float32)
        exact = np.zeros((b, s, f), np.float64)
        contrib = g[:, None] * (w[..., None] if weighted else np.float32(1))  # float32 products
        for bi in range(b):
            np.add.at(exact[bi], idx[bi].reshape(-1), contrib[bi].reshape(-1, f).astype(np.float64))
        return idx, w, g, s, exact

    @pytest.mark.parametrize("k,weighted", [(3, True), (1, False)])
    def test_scatter_matches_float64_and_pallas(self, rng, k, weighted):
        """k=3 with weights is the kNN backward, k=1 without weights the
        gather backward (`scatter_add_pallas`). The plain version sums the
        float32 products in float64, so it is the exact sum rounded once:
        within one float32 ulp of float64 `np.add.at`. The Pallas kernel
        (interpret mode) multiplies hi/lo-bf16 operands: within 1e-5 of the
        largest |dx|."""
        idx, w, g, s, exact = self._scatter_inputs(rng, k, weighted)
        got = ck.knn_scatter(T(idx), None if w is None else T(w), T(g), s).numpy()
        np.testing.assert_allclose(got, exact, rtol=2.0 ** -23, atol=0)
        if weighted:
            pallas = _knn_scatter_pallas(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), s)
        else:
            pallas = scatter_add_pallas(jnp.asarray(idx[:, 0]), jnp.asarray(g), s)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=0,
                                   atol=1e-5 * np.abs(exact).max())

    @staticmethod
    def _ordered_loop(idx, w, g, s, pairs, chunk):
        """The kernel's order of sums as a numpy loop of float32 adds: per
        row, its pairs p = j * T + t in rounds of `pairs` consecutive p, a
        round's pairs cut into chunks of `chunk`, each chunk summed in p
        order from 0, the row 0 plus its chunks in order."""
        b, k, t = idx.shape
        out = np.zeros((b, s, g.shape[2]), np.float32)
        for bi in range(b):
            groups = {}
            for p in range(k * t):
                j, ti = divmod(p, t)
                d = int(idx[bi, j, ti])
                if 0 <= d < s:
                    v = g[bi, ti] if w is None else np.float32(w[bi, j, ti]) * g[bi, ti]
                    groups.setdefault((d, p // pairs), []).append(v.astype(np.float32))
            for (d, _), terms in sorted(groups.items()):
                for c0 in range(0, len(terms), chunk):
                    part = np.zeros(g.shape[2], np.float32)
                    for v in terms[c0:c0 + chunk]:
                        part = (part + v).astype(np.float32)
                    out[bi, d] = (out[bi, d] + part).astype(np.float32)
        return out

    @pytest.mark.parametrize("k,weighted,pairs,chunk", [(3, True, 256, 8), (1, False, 128, 4),
                                                        (3, True, 8192, 64)])
    def test_ordered_scatter_is_the_kernels_float32_order(self, rng, k, weighted, pairs, chunk):
        """`knn_scatter_ordered_plain` sums as the kernel does, bit for bit:
        several rounds of `pairs`, a row (row 3 of cloud 0) with more than
        `chunk` pairs in a round, rows with none, ids outside [0, S)
        skipped; and within the float32 error bound of a sum in any order of
        `knn_scatter_plain` (float64 sums) on the ids in range."""
        idx, w, g, s, _ = self._scatter_inputs(rng, k, weighted)
        idx[0, :, 5:25] = 3  # row 3: 25 pairs of each j, more than a chunk
        idx[1, 0, :7] = -1
        idx[1, 0, 7:9] = s
        idx[idx == 70] = 71  # row 70 gets nothing
        got = ck.knn_scatter_ordered_plain(T(idx), None if w is None else T(w), T(g), s, pairs,
                                           chunk).numpy()
        want = self._ordered_loop(idx, w, g, s, pairs, chunk)
        assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
        assert not got[:, 70].any()
        valid = (idx >= 0) & (idx < s)
        # ids out of range go to row 0 with weight 0 (the plain version takes none)
        wz = np.where(valid, 1 if w is None else w, 0).astype(np.float32)
        plain = ck.knn_scatter_plain(T(np.where(valid, idx, 0).astype(np.int32)), T(wz), T(g),
                                     s).numpy()
        terms = np.abs(g[:, None] * wz[..., None]).astype(np.float64)
        absum = np.zeros(got.shape, np.float64)
        cnt = np.zeros(got.shape[:2], np.float64)
        for bi in range(idx.shape[0]):
            rows = np.where(valid[bi], idx[bi], 0).reshape(-1)
            np.add.at(absum[bi], rows, terms[bi].reshape(-1, g.shape[2]))
            np.add.at(cnt[bi], rows, valid[bi].reshape(-1).astype(np.float64))
        u = 2.0 ** -24
        bound = cnt[..., None] * u * absum + 2 * u * np.abs(plain)
        assert (np.abs(got.astype(np.float64) - plain) <= bound).all()

    def test_gather_rows_matches_jax_vjp(self, rng):
        """Forward: the same rows, exactly. Backward: JAX's VJP is the
        interpret-mode Pallas scatter (hi/lo bf16), within 1e-5 of the
        largest |dx|."""
        x = rng.normal(size=(2, 90, 32)).astype(np.float32)
        idx = rng.integers(0, 90, (2, 40, 16)).astype(np.int32)
        g = rng.normal(size=(2, 40, 16, 32)).astype(np.float32)
        want, vjp = jax.vjp(lambda a: jax_gather_rows(a, jnp.asarray(idx)), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
        xt = T(x).requires_grad_()
        got = gather_rows(xt, T(idx))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        got.backward(T(g))
        want_dx = np.asarray(want_dx)
        np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                                   atol=1e-5 * np.abs(want_dx).max())

    def test_knn_interpolate_grad_matches_jax_vjp(self, rng):
        """JAX's CPU kNN gradient is XLA autodiff of the exact path; the
        port scatters g times the normalised weights. The two round the
        per-term products differently: within 1e-6 of the largest |dx|."""
        src = _cloud(rng, 2, 128)
        tgt = rng.uniform(-5, 5, (2, 512, 3)).astype(np.float32)
        x = rng.normal(size=(2, 128, 34)).astype(np.float32)
        g = rng.normal(size=(2, 512, 34)).astype(np.float32)
        _, vjp = jax.vjp(lambda a: jax_knn(a, jnp.asarray(src), jnp.asarray(tgt), k=3,
                                           use_pallas=False), jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        xt = T(x).requires_grad_()
        knn_interpolate(xt, T(src), T(tgt)).backward(T(g))
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())

    def test_pixel_max_backward_matches_pallas_vjp(self, rng):
        """Each pixel's cotangent goes to its winning point, ties to the
        lowest index, as `pixel_max_pallas`' VJP (interpret mode) sends it:
        exactly equal, empty pixels and out-of-range ids included."""
        pix = rng.integers(-5, 405, (3, 700)).astype(np.int32)
        vals = (rng.integers(0, 6, (3, 700, 3)) / 6).astype(np.float32)
        g = rng.normal(size=(3, 400, 3)).astype(np.float32)
        _, vjp = jax.vjp(lambda v: pixel_max_pallas(jnp.asarray(pix), v, 400)[0], jnp.asarray(vals))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        vt = T(vals).requires_grad_()
        vmax, amax = tproj._PixelMax.apply(T(pix), vt, 400)
        vmax.backward(T(g))
        np.testing.assert_array_equal(vt.grad.numpy(), want)
        np.testing.assert_array_equal(ck.pixel_max_bwd(T(pix), amax, T(g)).numpy(), want)
        assert (amax.numpy() == -1).any() and (want == 0).any()

    def test_pixel_max_backward_zeroes_out_of_range_rows(self, rng):
        """Two thirds of the ids outside [0, 400) and a band of empty pixels: dv
        equals JAX's VJP, every row of an out-of-range point is zero, and
        the kernel's gather, dv[i] = g[pix[i]] where amax[pix[i]] == i
        (numpy here), equals the indexed store of the plain version."""
        pix = rng.integers(-400, 800, (2, 900)).astype(np.int32)
        pix[(pix >= 100) & (pix < 150)] = -3  # pixels 100..149 stay empty
        vals = (rng.integers(0, 4, (2, 900, 3)) / 4).astype(np.float32)
        g = rng.normal(size=(2, 400, 3)).astype(np.float32)
        _, vjp = jax.vjp(lambda v: pixel_max_pallas(jnp.asarray(pix), v, 400)[0], jnp.asarray(vals))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        _, amax = ck.pixel_max(T(pix), T(vals), 400)
        got = ck.pixel_max_bwd(T(pix), amax, T(g)).numpy()
        np.testing.assert_array_equal(got, want)
        out = (pix < 0) | (pix >= 400)
        assert out.mean() > 0.6 and (got[out] == 0).all()
        assert (amax.numpy()[:, 100:150] == -1).all()
        a = amax.numpy()
        bi = np.arange(2)[:, None]
        pc = np.clip(pix, 0, 399)
        win = ~out[..., None] & (a[bi, pc] == np.arange(900)[None, :, None])
        np.testing.assert_array_equal(np.where(win, g[bi, pc], 0.0), got)

    def test_plotwise_grad_matches_jax(self, rng):
        """The gradient of the plot coverages in the pointwise coverages
        against JAX's dense CPU path (whose max splits ties; continuous
        random coverages have none): within 1e-6 of the largest entry."""
        cov = rng.uniform(size=(2, 611, 4)).astype(np.float32)
        xy = rng.uniform(-1, 1, (2, 611, 2)).astype(np.float32)
        gp = rng.normal(size=(2, 4)).astype(np.float32)
        want = np.asarray(jax.grad(lambda c: jnp.sum(
            jproj.plotwise_coverages(c, jnp.asarray(xy), 20) * gp))(jnp.asarray(cov)))
        ct = T(cov).requires_grad_()
        (plotwise_coverages(ct, T(xy), 20) * T(gp)).sum().backward()
        np.testing.assert_allclose(ct.grad.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        assert (want[..., 1] == 0).all()  # bare soil derives from low


class TestProjection:
    def _inputs(self, rng, n=611):
        cov = rng.uniform(size=(2, n, 4)).astype(np.float32)
        xy = rng.uniform(-1, 1, size=(2, n, 2)).astype(np.float32)
        xy[0, :8] = np.arange(-4, 4)[:, None] / 10.0  # on bin edges
        return cov, xy

    def test_pixel_ids_identical(self, rng):
        _, xy = self._inputs(rng)
        want_mm = jax.vmap(lambda a: jproj._pixel_bins_minmax(a, 20))(jnp.asarray(xy))
        np.testing.assert_array_equal(tproj._pixel_bins_minmax(T(xy), 20).numpy(),
                                      np.asarray(want_mm))
        want_r = jproj._raster_bins(jnp.asarray(xy * 0.9), 20, 20)
        np.testing.assert_array_equal(tproj._raster_bins(T(xy * 0.9), 20, 20).numpy(),
                                      np.asarray(want_r))

    def test_plotwise_matches_jax(self, rng):
        cov, xy = self._inputs(rng)
        want = jproj.plotwise_coverages(jnp.asarray(cov), jnp.asarray(xy), 20)
        got = plotwise_coverages(T(cov), T(xy), 20)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    def test_rasters_match_jax(self, rng):
        """Per-pixel maxima are selections of the same values: exact, with
        NaN exactly where no point falls."""
        cov, xy = self._inputs(rng)
        want = np.asarray(jproj.batched_raster_projection(jnp.asarray(xy * 0.9),
                                                          jnp.asarray(cov), 20, 20))
        got = batched_raster_projection(T(xy * 0.9), T(cov), 20, 20).numpy()
        assert np.isnan(want).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got, want)
        one = raster_projection(T(xy[1] * 0.9), T(cov[1]), 20, 20).numpy()
        np.testing.assert_array_equal(one, want[1])


class TestWrappers:
    def test_cpu_tensors_take_plain_versions(self, rng):
        ck.reset_launches()
        xyz = _cloud(rng, 2, 64)
        start = np.zeros(2, np.int32)
        np.testing.assert_array_equal(ck.fps(T(xyz), 8, T(start)).numpy(),
                                      ck.fps_plain(T(xyz), 8, T(start)).numpy())
        x = rng.normal(size=(2, 64, 5)).astype(np.float32)
        out, _, _ = ck.knn_interpolate(T(x), T(xyz), T(xyz[:, :10]))
        np.testing.assert_array_equal(out.numpy(),
                                      ck.knn_interpolate_plain(T(x), T(xyz), T(xyz[:, :10]))[0].numpy())
        pix = rng.integers(0, 9, (2, 64)).astype(np.int32)
        v, a = ck.pixel_max(T(pix), T(x[..., :3]), 9)
        pv, pa = ck.pixel_max_plain(T(pix), T(x[..., :3]), 9)
        assert torch.equal(v, pv) and torch.equal(a, pa)
        q = rng.normal(size=(2, 64, 32)).astype(np.float32)
        ones, zeros = torch.ones(32), torch.zeros(32)
        args = (T(q), T(xyz), T(xyz[:, :10]), torch.zeros(2, 10, 32), ones, zeros,
                None, None, None, None, 2.0, 4)
        assert torch.equal(ck.sa_fused_eval(*args), ck.sa_fused_eval_plain(*args))
        cent = T(xyz[:, :10])
        idx, mask = ck.ball_query(cent, T(xyz), 2.0, 4)
        want_idx, want_mask = ball_query_grouped(cent, T(xyz), 2.0, 4)
        assert idx.dtype == torch.int32 and torch.equal(idx.long(), want_idx)
        assert torch.equal(mask, want_mask)
        kidx = T(rng.integers(0, 64, (2, 3, 10)).astype(np.int32))
        w, g = torch.rand(2, 3, 10), T(x[:, :10])
        assert torch.equal(ck.knn_scatter(kidx, w, g, 64), ck.knn_scatter_plain(kidx, w, g, 64))
        assert torch.equal(ck.pixel_max_bwd(T(pix), a, v), ck.pixel_max_bwd_plain(T(pix), a, v))
        assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)

    def test_mixed_devices_raise(self, rng):
        """Tensors on two devices, or on a device that is neither the CPU
        nor CUDA, raise before anything runs."""
        xyz = T(_cloud(rng, 2, 64))
        with pytest.raises(ValueError, match="several devices"):
            ck.fps(xyz, 8, torch.zeros(2, dtype=torch.int32, device="meta"))
        with pytest.raises(ValueError, match="unsupported device"):
            ck.fps(xyz.to("meta"), 8, torch.zeros(2, dtype=torch.int32, device="meta"))

    @pytest.mark.parametrize("bad", ["dtype", "shape", "start"])
    def test_bad_inputs_raise(self, rng, bad):
        xyz = T(_cloud(rng, 2, 64))
        start = torch.zeros(2, dtype=torch.int32)
        if bad == "dtype":
            xyz = xyz.double()
        elif bad == "shape":
            xyz = xyz[..., :2]
        else:
            start = start.long()
        with pytest.raises(ValueError):
            ck.fps(xyz, 8, start)
