"""The port's parallel paths (`stratanet2_tpu_torch/parallel/`) on gloo
ranks on the CPU, against the JAX package's `parallel/` on the 8-virtual-
device CPU mesh of tests/conftest.py: the collectives, the three
point-sharded ops at D = 2 and 4, the point-sharded forward at 1x2 and 2x2,
the data-parallel and point-sharded predict steps, the group plumbing and
the dryrun at 2 and 4 ranks.

Each world size is started once for the module (`ranks2`, `ranks4`: one
`launch.run_ranks` each, every rank running the module's cases in one
list, `dryrun.run_cases`); the ranks import torch and the port only and
meet through a file store under the test's temporary folder. The parallel
modules that start ranks running the training loop or the CLIs hide
matplotlib from them (`no_figures`): the port then skips its figures, which
none of these tests reads, and a run takes half the time.

Tolerances. The ball query's picks: equal (both sides select on the same
float32 distances). The projections: the sharded op against JAX's within
rtol 1e-5, atol 1e-6 (JAX's own sharded-vs-unsharded bound), NaN where
JAX's is. The forward and the predict steps: atol 2e-5, the serve step's
bound of tests/test_torch_port_model.py (the port folds eval BN into the
fused SA kernel's affine, JAX's sharded forward normalises after the
matmul).
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.inference import predict as jpredict
from stratanet2_tpu.models import init_pointnet2 as jax_init
from stratanet2_tpu.parallel import point_sharded as jps
from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data.loader import PlotLoader
from stratanet2_tpu_torch.inference.predict import make_point_sharded_predict_step
from stratanet2_tpu_torch.learning.train import point_sharded_eligible
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.parallel.dryrun import dryrun_multichip
from stratanet2_tpu_torch.parallel.launch import run_ranks
from synthetic import make_plot_dataset, tiny_config

torch.set_num_threads(1)

OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
FWD_ATOL = 2e-5
RANKS_TIMEOUT = 240.0


def port_config(jcfg):
    """The port's Config at the JAX tiny config's model and batch."""
    m = jcfg.model
    cfg = Config().as_dev()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=m.subsample_size, k1=m.k1, k2=m.k2,
                      fps_parts=m.fps_parts, fps_min_part_samples=m.fps_min_part_samples,
                      diam_meters=m.diam_meters, diam_pix=m.diam_pix),
        train=replace(cfg.train, batch_size=jcfg.train.batch_size),
    )


def ops_inputs(d):
    rng = np.random.default_rng(10 + d)
    n = 512
    return dict(
        points=rng.normal(size=(n, 3)).astype(np.float32),
        centroids=rng.normal(size=(32, 3)).astype(np.float32), radius=1.0, k=16,
        cov=rng.uniform(size=(n, 4)).astype(np.float32),
        xy=rng.uniform(-1, 1, size=(n, 2)).astype(np.float32), diam_pix=20,
        xy_rescaled=rng.uniform(-0.9, 0.9, size=(n, 2)).astype(np.float32),
        cov_raster=rng.uniform(size=(n, 4)).astype(np.float32), diam_meters=20,
    )


def forward_inputs(db, dp):
    """JAX's tiny config at N=512 with fps_parts = dp (the geometry at which
    JAX's sharded forward equals its unsharded one), its weights and a
    batch of 2 * db clouds."""
    jcfg = tiny_config()
    jcfg = replace(jcfg, model=replace(jcfg.model, subsample_size=512, fps_parts=dp,
                                       fps_min_part_samples=1))
    model = jax_init(jax.random.PRNGKey(db * 10 + dp), jcfg.model)
    rng = np.random.default_rng(db * 10 + dp)
    b, n = 2 * db, jcfg.model.subsample_size
    return dict(
        jcfg=jcfg, model=model,
        params=jax.tree_util.tree_map(np.asarray, model.params),
        state=jax.tree_util.tree_map(np.asarray, model.state),
        cloud=rng.uniform(0, 1, (b, n, 10)).astype(np.float32),
        xyz=rng.uniform(-10, 10, (b, n, 3)).astype(np.float32),
    )


def _forward_case(db, dp):
    f = forward_inputs(db, dp)
    return ("forward", "forward", dict(
        mcfg=port_config(f["jcfg"]).model, params=f["params"], state=f["state"],
        cloud=f["cloud"][..., 2:], xyz=f["xyz"], db=db, dp=dp))


def _predict_case(d):
    f = forward_inputs(1, d)
    return ("predict", "predict", dict(
        cfg=replace(port_config(f["jcfg"]), train=replace(port_config(f["jcfg"]).train,
                                                          batch_size=2 * d)),
        params=f["params"], state=f["state"], cloud=f["cloud"], xyz=f["xyz"]))


def _group_case():
    cfg = port_config(tiny_config())
    bad = replace(cfg, model=replace(cfg.model, subsample_size=255))
    return ("group", "group", dict(cfgs=[cfg, bad]))


def no_figures(mp, folder):
    """Hide matplotlib from the processes this test starts (ranks,
    torchrun): a package of that name under `folder`, first on their
    PYTHONPATH, raises ImportError, and the port skips its figures."""
    stub = os.path.join(str(folder), "no_figures", "matplotlib")
    os.makedirs(stub, exist_ok=True)
    with open(os.path.join(stub, "__init__.py"), "w") as f:
        f.write('raise ImportError("matplotlib is hidden from this test\'s processes")\n')
    mp.setenv("PYTHONPATH", os.path.dirname(stub) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _spawn(world, cases, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp(f"ranks{world}"))
    return run_ranks(world, "stratanet2_tpu_torch.parallel.dryrun:run_cases", cases,
                     backend="gloo", device="cpu", timeout=RANKS_TIMEOUT, workdir=workdir)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    values = np.random.default_rng(3).normal(size=(2, 5)).astype(np.float32)
    cases = [("collectives", "collectives", dict(values=values)),
             ("ops", "sharded_ops", ops_inputs(2)), _forward_case(1, 2), _predict_case(2),
             _group_case()]
    return dict(values=values, out=_spawn(2, cases, tmp_path_factory))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    values = np.random.default_rng(4).normal(size=(4, 5)).astype(np.float32)
    cases = [("collectives", "collectives", dict(values=values)),
             ("ops", "sharded_ops", ops_inputs(4)), _forward_case(2, 2), _group_case()]
    return dict(values=values, out=_spawn(4, cases, tmp_path_factory))


def _world(request):
    return request.getfixturevalue(f"ranks{request.param}")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


@pytest.fixture(params=[2, 4])
def world(request):
    return request.param, _world(request)


def test_collectives_forward_and_backward(world):
    """Rank r (c = r + 1) on its row x_r of `values`. sum: every rank holds
    sum_r x_r, and with loss_r = c * sum(y) the gradient in x_r is sum(c),
    the cotangents of every rank summed. all_gather: (D, n) rows in rank
    order, gradient in x_r with loss_r = c * sum((s + 1) * y[s]) is (r + 1)
    sum(c). max: the elementwise max, the whole gradient on the winning
    rank: 1 where each rank's loss is its share max / D (the global loss
    is the max once), D where every rank takes the replicated max whole
    (the D-times count of a replicated loss); tied ranks share it evenly.
    Exactness of the gather: -1e30, NaN, -0.0 and 3.4e38 survive, ints and
    bools too."""
    d, ranks = world
    values = ranks["values"]
    csum = sum(range(1, d + 1))
    winner = values.argmax(0)
    for r, out in enumerate(o["collectives"] for o in ranks["out"]):
        np.testing.assert_allclose(out["sum"], values.sum(0), rtol=1e-6)
        np.testing.assert_allclose(out["sum_grad"], np.full(5, csum), rtol=1e-6)
        np.testing.assert_array_equal(out["gather"], values)
        np.testing.assert_allclose(out["gather_grad"], np.full(5, (r + 1) * csum), rtol=1e-6)
        np.testing.assert_array_equal(out["max_shared"], values.max(0))
        np.testing.assert_array_equal(out["max_shared_grad"], (winner == r).astype(np.float32))
        np.testing.assert_array_equal(out["max_replicated_grad"],
                                      d * (winner == r).astype(np.float32))
        np.testing.assert_allclose(out["tied_grad"], np.full(3, 1.0), rtol=1e-6)
        odd = np.array([-1e30, np.nan, -0.0, 3.4e38], np.float32)
        with np.errstate(over="ignore"):  # 3.4e38 * 2 is inf, on both sides
            want = np.stack([odd * (s + 1) for s in range(d)])
        np.testing.assert_array_equal(out["gather_exact"], want)
        np.testing.assert_array_equal(out["gather_int"],
                                      np.arange(4)[None] + np.arange(d)[:, None])
        np.testing.assert_array_equal(out["gather_bool"],
                                      np.stack([[s == 0, True] for s in range(d)]))
        np.testing.assert_array_equal(out["max_bool"], [True, False])
        np.testing.assert_array_equal(out["min"], [0.0])


# ---------------------------------------------------------------------------
# the point-sharded ops, forward and predict step against JAX's
# ---------------------------------------------------------------------------


def test_sharded_ops_match_jax(world):
    """ball_query_point_sharded, plotwise_coverages_point_sharded and
    raster_projection_point_sharded over D ranks against JAX's over a
    D-device point mesh, on every rank."""
    d, ranks = world
    a = ops_inputs(d)
    mesh = jps.make_point_mesh(d)
    gi, gm = jps.ball_query_point_sharded(mesh, jnp.asarray(a["centroids"]),
                                          jnp.asarray(a["points"]), a["radius"], a["k"])
    xy = jnp.asarray(a["xy"])
    pl = jps.plotwise_coverages_point_sharded(mesh, jnp.asarray(a["cov"]), xy, a["diam_pix"],
                                              xy.min(axis=0), xy.max(axis=0))
    raster = np.asarray(jps.raster_projection_point_sharded(
        mesh, jnp.asarray(a["xy_rescaled"]), jnp.asarray(a["cov_raster"]), a["diam_pix"],
        a["diam_meters"]))
    for out in (o["ops"] for o in ranks["out"]):
        np.testing.assert_array_equal(out["mask"], np.asarray(gm))
        np.testing.assert_array_equal(out["idx"], np.asarray(gi))
        np.testing.assert_allclose(out["plotwise"], np.asarray(pl), rtol=OPS_RTOL,
                                   atol=OPS_ATOL)
        np.testing.assert_array_equal(np.isnan(out["raster"]), np.isnan(raster))
        np.testing.assert_allclose(np.nan_to_num(out["raster"]), np.nan_to_num(raster),
                                   rtol=OPS_RTOL, atol=OPS_ATOL)


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["1x2", "2x2"])
def test_forward_point_sharded_matches_jax(world):
    """pointnet2_forward_point_sharded on a 1x2 and a 2x2 mesh: each rank's
    rows and point shard of (cov, proba) against JAX's sharded forward on
    the same mesh shape, within FWD_ATOL."""
    d, ranks = world
    db, dp = (1, 2) if d == 2 else (2, 2)
    f = forward_inputs(db, dp)
    cov, proba = jps.pointnet2_forward_point_sharded(
        f["model"], jnp.asarray(f["cloud"][..., 2:]), jnp.asarray(f["xyz"]), f["jcfg"].model,
        jps.make_mesh_2d(db, dp))
    cov, proba = np.asarray(cov), np.asarray(proba)
    bl, nl = cov.shape[0] // db, cov.shape[1] // dp
    for out in (o["forward"] for o in ranks["out"]):
        rows = slice(out["batch_index"] * bl, (out["batch_index"] + 1) * bl)
        cols = slice(out["point_index"] * nl, (out["point_index"] + 1) * nl)
        np.testing.assert_allclose(out["cov"], cov[rows, cols], rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(out["proba"], proba[rows, cols], rtol=0, atol=FWD_ATOL)


def test_predict_steps_match_jax(ranks2):
    """On 2 ranks: the point-sharded predict step against JAX's
    `make_point_sharded_predict_step(cfg, 2)`, and the data-parallel step
    (a batch of 4 split over the ranks) against JAX's `make_predict_step`
    with a 2-device mesh, rasters and plot coverages whole on both ranks."""
    f = forward_inputs(1, 2)
    jcfg = replace(f["jcfg"], train=replace(f["jcfg"].train, batch_size=4))
    from stratanet2_tpu.parallel import make_mesh

    want = {
        "point_sharded": jpredict.make_point_sharded_predict_step(jcfg, 2)(
            f["model"], jnp.asarray(f["cloud"]), jnp.asarray(f["xyz"])),
        "data_parallel": jpredict.make_predict_step(jcfg, mesh=make_mesh(2))(
            f["model"], jnp.asarray(f["cloud"]), jnp.asarray(f["xyz"])),
    }
    for out in (o["predict"] for o in ranks2["out"]):
        for name, (w_r, w_p) in want.items():
            rasters, pred_pl = out[name]
            np.testing.assert_array_equal(np.isnan(rasters), np.isnan(np.asarray(w_r)))
            np.testing.assert_allclose(np.nan_to_num(rasters), np.nan_to_num(np.asarray(w_r)),
                                       rtol=0, atol=FWD_ATOL, err_msg=name)
            np.testing.assert_allclose(pred_pl, np.asarray(w_p), rtol=0, atol=FWD_ATOL,
                                       err_msg=name)


def test_point_sharded_predict_step_validates_divisibility():
    """As JAX's (test_point_sharded.py): N = 500 does not divide over 8,
    and the step refuses before it needs a process group."""
    cfg = port_config(tiny_config())
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=500))
    with pytest.raises(ValueError, match="divisible"):
        make_point_sharded_predict_step(cfg, 8, device="cpu")


# ---------------------------------------------------------------------------
# the group plumbing
# ---------------------------------------------------------------------------


def test_group_plumbing(world):
    """Each rank knows its rank and the world, feeds its contiguous host
    slice, gets one memoized mesh per shape, draws its own dropout masks
    (a generator seeded from both mesh indices: no two ranks alike), and
    `point_sharded_eligible` counts the ranks: N = 256 divides over 2 and 4
    ranks, N = 255 does not (the reason names it)."""
    d, ranks = world
    for r, out in enumerate(o["group"] for o in ranks["out"]):
        assert (out["rank"], out["world"]) == (r, d)
        assert out["slice"] == slice(4 * r, 4 * r + 4)
        assert out["memoized"] and out["point_index"] == r and out["batch_index"] == r
        others = [o["group"]["dropout_draws"] for o in ranks["out"] if o is not None]
        assert sum(np.array_equal(out["dropout_draws"], x) for x in others) == 1
        (ok, why), (bad_ok, bad_why) = out["eligible"]
        assert ok and why == ""
        assert not bad_ok and "subsample_size=255" in bad_why and f"{d} devices" in bad_why


def test_point_sharded_eligible_in_one_process():
    ok, why = point_sharded_eligible(port_config(tiny_config()))
    assert not ok and why == "needs more than one device"


def test_initialize_reads_the_environment(monkeypatch):
    """One process: no-op without WORLD_SIZE / JAX_NUM_PROCESSES (or with
    1). Several: the backend must be named, the process id must be in
    range, and a rendezvous must be given; JAX's variables are read where
    torchrun's are absent."""
    for name in ("WORLD_SIZE", "RANK", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(backend="gloo") == (0, 1)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert multihost.initialize() == (0, 1)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize()
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="out of range"):
        multihost.initialize(backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="no rendezvous"):
        multihost.initialize(backend="gloo")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("gb,n", [(12, 2), (24, 4), (48, 8)])
def test_host_batch_slice_partitions(gb, n):
    covered = [i for pid in range(n) for i in range(gb)[multihost.host_batch_slice(gb, pid, n)]]
    assert covered == list(range(gb))
    with pytest.raises(ValueError):
        multihost.host_batch_slice(gb + 1, 0, n)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    """Every path once on n gloo ranks: finite losses, equal on every
    rank, the 2-D mesh step at 4."""
    out = dryrun_multichip(n, "gloo", "cpu")
    assert {"dp_loss", "epoch_loss", "point_sharded_loss", "predict_mean_cov"} <= set(out)
    assert ("mesh_2d_loss" in out) == (n >= 4)
    assert all(np.isfinite(v) for v in out.values())


def test_entry_points_default_to_the_card():
    """`dryrun_multichip` and `launch.run_ranks` run on the card unless the
    caller names the CPU: without one they raise before starting a rank."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(2, "stratanet2_tpu_torch.parallel.dryrun:run_cases", [], backend="gloo")


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_rows_are_the_batch_rows(workers):
    """`PlotLoader(rows=...)`, a data-parallel rank's loader on the host
    path, gives that rank's rows of every train batch bit for bit, the
    augmentation included (each plot draws from its own generator)."""
    ds = make_plot_dataset(np.random.default_rng(5), n_plots=9, n_points=300)
    cfg = port_config(tiny_config())
    whole = list(PlotLoader(ds, cfg, train=True, batch_size=4, seed=3, workers=workers))
    for pid in range(2):
        rows = multihost.host_batch_slice(4, pid, 2)
        part = list(PlotLoader(ds, cfg, train=True, batch_size=4, seed=3, workers=workers,
                               rows=rows))
        assert len(part) == len(whole) == 2
        for a, b in zip(part, whole):
            for key in ("cloud", "xyz", "coverages"):
                np.testing.assert_array_equal(a[key], b[key][rows])
            assert a["plot_id"] == b["plot_id"][rows]
