"""The PyTorch port's model, converter and serve step against the JAX
package on the CPU, at two DEV geometries: N=256 (k1=8, k2=16) and N=2048,
where partitioned FPS engages at SA1 (2 parts of 256 picks). The same
numpy inputs and the same weights (through `from_jax_params`) go to both
sides; BN scale/bias and running statistics are random so the fold is
exercised.

Tolerances: atol 2e-5 on coverages, probabilities, rasters and plot
coverages (values in [0, 1]); the port folds BN and distributes SA layer 1
over the edge concat where JAX's CPU path does neither, which differs by
rounding only. Every selected index must be equal.
"""

import copy
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.config import ModelConfig as JaxModelConfig, default_config as jax_config
from stratanet2_tpu.inference.predict import make_predict_step as jax_predict_step
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init, pointnet2_forward
from stratanet2_tpu.ops import ball_query, farthest_point_sampling as jax_fps
from stratanet2_tpu_torch.config import ModelConfig, default_config
from stratanet2_tpu_torch.inference.predict import make_predict_step
from stratanet2_tpu_torch.learning.kde import KdeMixture, fit_kde_mixture
from stratanet2_tpu_torch.learning.crossval import cross_validate
from stratanet2_tpu_torch.learning.evaluate import evaluate
from stratanet2_tpu_torch.learning.train import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    train_full,
)
from stratanet2_tpu_torch.models import count_params, init_pointnet2
from stratanet2_tpu_torch.ops import ball_query_grouped, cuda_kernels as ck
from stratanet2_tpu_torch.ops import farthest_point_sampling
from stratanet2_tpu_torch.utils.convert import from_jax_params, to_jax_params

torch.set_num_threads(1)

GEOMETRIES = {"N256": (256, 8, 16), "N2048": (2048, 32, 64)}
REPO = Path(__file__).resolve().parents[1]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """JAX model + inputs + JAX outputs at one geometry, computed once."""
    n, k1, k2 = GEOMETRIES[request.param]
    rng = np.random.default_rng(n)
    jcfg = JaxModelConfig(subsample_size=n, k1=k1, k2=k2, use_pallas=False)
    pcfg = ModelConfig(subsample_size=n, k1=k1, k2=k2)
    model = jax_init(jax.random.PRNGKey(n), jcfg)
    params, state = _numpy_tree(model.params), _numpy_tree(model.state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, state))
    xy = rng.uniform(-10, 10, (2, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (2, n, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    cloud = np.concatenate([xy / 10, z / 24.24, rng.uniform(0, 1, (2, n, 7))], -1)
    cloud = cloud.astype(np.float32)
    cov, proba, _ = pointnet2_forward(jmodel, jnp.asarray(cloud[..., 2:]), jnp.asarray(xyz),
                                      jcfg, train=False)
    rasters, pred_pl = jax_predict_step(replace(jax_config("DEV"), model=jcfg))(
        jmodel, jnp.asarray(cloud), jnp.asarray(xyz))
    port = from_jax_params(params, state, pcfg, device="cpu")
    return dict(
        jcfg=jcfg, pcfg=pcfg, port=port, cloud=cloud, xyz=xyz,
        cov=np.asarray(cov), proba=np.asarray(proba),
        rasters=np.asarray(rasters), pred_pl=np.asarray(pred_pl),
    )


def test_forward_matches_jax(case):
    with torch.no_grad():
        cov, proba = case["port"](torch.from_numpy(case["cloud"][..., 2:]),
                                  torch.from_numpy(case["xyz"]))
    np.testing.assert_allclose(cov.numpy(), case["cov"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(proba.numpy(), case["proba"], rtol=0, atol=2e-5)


def test_predict_step_matches_jax(case):
    step = make_predict_step(replace(default_config(), model=case["pcfg"]), device="cpu")
    ck.reset_launches()
    rasters, pred_pl = step(case["port"], case["cloud"], case["xyz"])
    assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)  # CPU: plain versions
    assert rasters.shape == case["rasters"].shape and pred_pl.shape == (2, 4)
    np.testing.assert_array_equal(np.isnan(rasters.numpy()), np.isnan(case["rasters"]))
    np.testing.assert_allclose(rasters.numpy(), case["rasters"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(pred_pl.numpy(), case["pred_pl"], rtol=0, atol=2e-5)


def test_predict_step_after_a_train_step_runs_in_eval_mode(case):
    """A train step leaves the model in train mode; the predict step must
    still run it in eval mode, as JAX's `train=False` does: its outputs
    equal those of an eval copy bit for bit, it changes no BN running
    statistic, and the model is in train mode again afterwards."""
    cfg = replace(default_config(), model=case["pcfg"])
    model = copy.deepcopy(case["port"])
    cloud, xyz = case["cloud"], case["xyz"]
    kde = fit_kde_mixture(xyz[..., 2].reshape(-1))
    gt = np.array([[0.3, 0.7, 0.2, 0.5], [0.6, 0.4, 0.1, 0.8]], np.float32)
    opt, sched = make_optimizer(cfg, model, steps_per_epoch=1)
    make_train_step(cfg, kde, device="cpu")(model, opt, sched, cloud, xyz, gt)
    assert model.training
    state = {k: v.clone() for k, v in model.named_buffers()}
    eval_copy = copy.deepcopy(model).eval()
    step = make_predict_step(cfg, device="cpu")
    rasters, pred_pl = step(model, cloud, xyz)
    want_rasters, want_pred_pl = step(eval_copy, cloud, xyz)
    np.testing.assert_array_equal(rasters.numpy(), want_rasters.numpy())
    np.testing.assert_array_equal(pred_pl.numpy(), want_pred_pl.numpy())
    for name, value in model.named_buffers():
        assert torch.equal(value, state[name]), name
        assert not value.is_inference(), name
    assert model.training


def test_selections_match_jax(case):
    """FPS and grouped ball-query indices of both SA stages (the plain query
    and the `ball_query` wrapper of the train path), and the kNN indices of
    FP2 and FP1, at the model's geometry."""
    jcfg = case["jcfg"]
    pos0 = case["xyz"]
    stages = [(jcfg.n_centroids1, jcfg.r1, jcfg.k1), (jcfg.n_centroids2, jcfg.r2, jcfg.k2)]
    positions = [pos0]
    for n_c, radius, k in stages:
        pos = positions[-1]
        want = np.asarray(jax_fps(jnp.asarray(pos), n_c, use_pallas=False,
                                  parts=jcfg.fps_parts,
                                  min_part_samples=jcfg.fps_min_part_samples))
        got = farthest_point_sampling(torch.from_numpy(pos), n_c, parts=jcfg.fps_parts,
                                      min_part_samples=jcfg.fps_min_part_samples)
        np.testing.assert_array_equal(got.numpy(), want)
        cent = np.take_along_axis(pos, want[..., None].astype(np.int64), axis=1)
        w_idx, w_mask = ball_query(jnp.asarray(cent), jnp.asarray(pos), radius, k,
                                   method="grouped")
        g_idx, g_mask = ball_query_grouped(torch.from_numpy(cent), torch.from_numpy(pos),
                                           radius, k)
        np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
        t_idx, t_mask = ck.ball_query(torch.from_numpy(cent), torch.from_numpy(pos), radius, k)
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(w_mask))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(w_idx))  # the train path's query
        positions.append(cent)
    from test_torch_port_ops import _jax_knn_idx

    for src, tgt in ((positions[2], positions[1]), (positions[1], positions[0])):
        want = np.asarray(_jax_knn_idx(jnp.asarray(src), jnp.asarray(tgt)))
        x = torch.zeros(src.shape[:2] + (1,))
        _, idx, _ = ck.knn_interpolate(x, torch.from_numpy(src), torch.from_numpy(tgt))
        np.testing.assert_array_equal(idx.numpy(), want.transpose(0, 2, 1))


def test_partitioned_fps_engages_at_n2048():
    cfg = ModelConfig(subsample_size=2048)
    assert cfg.n_centroids1 % cfg.fps_parts == 0
    assert cfg.n_centroids1 // cfg.fps_parts >= cfg.fps_min_part_samples
    assert cfg.n_centroids2 // cfg.fps_parts < cfg.fps_min_part_samples  # SA2 exact


class TestConverter:
    def test_round_trip_is_exact(self):
        jcfg = JaxModelConfig()
        model = jax_init(jax.random.PRNGKey(3), jcfg)
        params, state = _numpy_tree(model.params), _numpy_tree(model.state)
        port = from_jax_params(params, state, ModelConfig(), device="cpu")
        assert count_params(port) == 14997
        back_p, back_s = to_jax_params(port)
        for want, got in ((params, back_p), (state, back_s)):
            assert (jax.tree_util.tree_structure(want)
                    == jax.tree_util.tree_structure(got))
            for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "bad_shape"])
    def test_unmapped_unused_or_misshapen_leaves_raise(self, fault):
        model = jax_init(jax.random.PRNGKey(0), JaxModelConfig())
        params, state = _numpy_tree(model.params), _numpy_tree(model.state)
        if fault == "extra_leaf":
            params["lin3"] = {"w": np.zeros((2, 2), np.float32)}
        elif fault == "missing_leaf":
            del state["fp1"]["layers"][0]["var"]
        else:
            params["lin1"]["b"] = np.zeros(17, np.float32)
        with pytest.raises(ValueError):
            from_jax_params(params, state, ModelConfig(), device="cpu")


def test_init_follows_jax_init():
    cfg = ModelConfig()
    model = init_pointnet2(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert not model.training
    assert count_params(model) == 14997
    p, s = to_jax_params(model)
    jm = jax_init(jax.random.PRNGKey(0), JaxModelConfig())
    assert jax.tree_util.tree_structure(p) == jax.tree_util.tree_structure(_numpy_tree(jm.params))
    assert jax.tree_util.tree_structure(s) == jax.tree_util.tree_structure(_numpy_tree(jm.state))
    np.testing.assert_array_equal(p["lin2"]["b"], np.asarray(cfg.head_bias_init, np.float32))
    for stage in ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1"):
        for lp, ls in zip(p[stage]["layers"], s[stage]["layers"]):
            w = lp["linear"]["w"]
            assert np.abs(w).max() <= 1 / np.sqrt(w.shape[0])
            assert np.abs(w).max() > 0.5 / np.sqrt(w.shape[0])  # uniform over the range
            np.testing.assert_array_equal(lp["bn"]["scale"], 1.0)
            np.testing.assert_array_equal(ls["var"], 1.0)


def test_port_imports_without_jax():
    """The port and chip_smoke.py import with jax and the JAX package
    blocked, in a fresh interpreter; and with pandas, matplotlib, sklearn
    and scipy blocked too, which the card's machine may lack (the port
    imports them only inside the functions that use them). The walk takes
    every module, parcel predict's, the CLIs', the device-resident
    dataset's, the checkpoint import's and the metascripts' among them."""
    code = (
        "import sys\n"
        "blocked = ('jax', 'jaxlib', 'stratanet2_tpu', 'pandas', 'matplotlib', 'sklearn',\n"
        "           'scipy')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, stratanet2_tpu_torch\n"
        "walked = []\n"
        "for m in pkgutil.walk_packages(stratanet2_tpu_torch.__path__, 'stratanet2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.append(m.name)\n"
        "import chip_smoke\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in blocked]\n"
        "assert not loaded, loaded\n"
        "want = {'stratanet2_tpu_torch.inference.' + m for m in\n"
        "        ('polygons', 'shapefile_io', 'rasters', 'tiling', 'predict')}\n"
        "want.add('stratanet2_tpu_torch.utils.worklist')\n"
    "want |= {'stratanet2_tpu_torch.cli.' + m for m in\n"
    "         ('main', 'prepare', 'predict', 'main_ssl')}\n"
    "want.add('stratanet2_tpu_torch.data.device_dataset')\n"
    "want |= {'stratanet2_tpu_torch.parallel.' + m for m in\n"
    "         ('multihost', 'mesh', 'collectives', 'point_sharded', 'launch', 'dryrun')}\n"
    "want.add('stratanet2_tpu_torch.utils.torch_import')\n"
    "want |= {'stratanet2_tpu_torch.metascripts.' + m for m in\n"
    "         ('benchmark_all_models', 'predictions_analysis', 'quantification_errors')}\n"
        "assert want <= set(walked), sorted(want - set(walked))\n"
        "print('imported')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = default_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_predict_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pointnet2(torch.Generator().manual_seed(0), cfg.model)
    kde = KdeMixture(np.linspace(0, 1, 8, dtype=np.float32), np.ones((3, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, kde)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(cfg, kde)
    sink = object()  # never reached: the device is resolved first
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_full({}, [], [], cfg, kde, "unused", sink, fold_id=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(None, {}, [], cfg, kde, None, "unused", sink)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cross_validate({}, cfg, kde, "unused", sink)
    make_predict_step(cfg, device="cpu")  # the CPU when asked
    make_train_step(cfg, kde, device="cpu")
    make_eval_step(cfg, kde, device="cpu")

