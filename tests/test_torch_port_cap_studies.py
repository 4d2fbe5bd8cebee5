"""The capped-K studies of the port on the CPU against the JAX side's:
`stratanet2_tpu_torch/utils/reference_oracle.py` bit for bit
`stratanet2_tpu/utils/reference_oracle.py`, function by function;
`scripts/torch_neighbor_cap_study.py` against `scripts/neighbor_cap_study.py`
at N=1024, 2 clouds, 1 weight seed (each line's deviations within 5e-5);
`scripts/torch_cap_train_study.py`'s gradient study against
`scripts/cap_train_study.py`'s at n=1024, B=2, one batch, on JAX's init
carried across (`utils/convert.load_jax_params`): each gradient leaf within
GRAD_RTOL of the leaf's max |g|, the cosine and the norm ratio within 1e-3;
and its training study's plots, configurations and caps against JAX's."""

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from stratanet2_tpu.utils import reference_oracle as jax_oracle
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils import reference_oracle as oracle

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
# of each gradient leaf's max |g|: the bound of tests/test_torch_port_train.py
# at N=256 (its module doc says why a larger cloud may need more)
GRAD_RTOL = 1e-3
NEIGHBOR_ARGS = ["--n", "1024", "--n_clouds", "2", "--seeds", "1"]


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


# ---------------------------------------------------------------------------
# the oracle copy
# ---------------------------------------------------------------------------


def _cloud(rng, b, n):
    xyz = np.concatenate([rng.uniform(-10, 10, (b, n, 2)), rng.uniform(0, 5, (b, n, 1))],
                         -1).astype(np.float32)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    return feats, xyz


def _fps(mod, rng):
    return mod.fps_numpy(_cloud(rng, 1, 400)[1][0], 64, start=5)


def _radius(mod, rng):
    xyz = _cloud(rng, 1, 400)[1][0]
    return mod.radius_numpy(xyz, xyz[:50], 2.0, 7)


def _mlp(mod, rng):
    sd = {k: torch.from_numpy(v) for k, v in mod.make_reference_state_dict(2).items()}
    return mod._mlp_eval(sd, "sa1_module.conv.local_nn", 2,
                         torch.from_numpy(rng.normal(size=(300, 11)).astype(np.float32)))


def _pointconv(mod, rng):
    sd = {k: torch.from_numpy(v) for k, v in mod.make_reference_state_dict(2).items()}
    feats, xyz = _cloud(rng, 1, 400)
    pos = torch.from_numpy(xyz[0])
    nbrs = mod.radius_numpy(xyz[0], xyz[0][:40], 2.0, 50)
    return mod._pointconv_max(sd, "sa1_module.conv.local_nn", 2, torch.from_numpy(feats[0]),
                              pos, pos[:40], nbrs)


def _knn(mod, rng):
    x = torch.from_numpy(rng.normal(size=(60, 34)).astype(np.float32))
    src = torch.from_numpy(_cloud(rng, 1, 60)[1][0])
    tgt = torch.from_numpy(_cloud(rng, 1, 200)[1][0])
    return mod._knn_interpolate(x, src, tgt, 3)


def _forward(mod, rng):
    feats, xyz = _cloud(rng, 2, 300)
    return mod.reference_forward(mod.make_reference_state_dict(4), feats, xyz,
                                 n_centroids1=75, n_centroids2=19, r1=2 ** 0.5, r2=8 ** 0.5,
                                 max_num_neighbors=20)


def _plotwise(mod, rng):
    cov = rng.uniform(0, 1, (3, 500, 4)).astype(np.float32)
    return mod.reference_plotwise_coverages(cov, rng.uniform(-1, 1, (3, 500, 2)), 20)


def _state_dict(mod, rng):
    return mod.make_reference_state_dict(int(rng.integers(1000)), n_input_feats=8, n_class=4)


ORACLE_CASES = {"fps_numpy": _fps, "radius_numpy": _radius, "_mlp_eval": _mlp,
                "_pointconv_max": _pointconv, "_knn_interpolate": _knn,
                "reference_forward": _forward, "reference_plotwise_coverages": _plotwise,
                "make_reference_state_dict": _state_dict}


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        w = want.numpy() if torch.is_tensor(want) else np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_copy_equals_the_jax_packages(name):
    """Each copied function on the same seeded inputs: the same outputs bit
    for bit, dtype and shape included; the copy exports what it copied."""
    got = ORACLE_CASES[name](oracle, np.random.default_rng(11))
    want = ORACLE_CASES[name](jax_oracle, np.random.default_rng(11))
    _assert_same(got, want, name)
    assert hasattr(oracle, name)
    assert set(oracle.__all__) <= set(jax_oracle.__all__)


# ---------------------------------------------------------------------------
# the neighbour-cap study
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def neighbor_runs():
    """Both scripts at NEIGHBOR_ARGS: the JAX script's printed lines (its
    `main` with its `sys.argv` set) and the port's at `--device cpu`,
    returned lines and printed ones."""
    jax_script = load_script("neighbor_cap_study")
    port = load_script("torch_neighbor_cap_study")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", ["neighbor_cap_study.py", *NEIGHBOR_ARGS])
        jax_script.main()
    want = json_lines(out.getvalue())
    out = io.StringIO()
    ck.reset_launches()
    with contextlib.redirect_stdout(out):
        lines, summaries = port.main([*NEIGHBOR_ARGS, "--device", "cpu"])
    return dict(want=want, printed=json_lines(out.getvalue()), lines=lines,
                summaries=summaries, launches=ck.launch_counts())


def test_neighbor_study_lines_match_the_jax_scripts(neighbor_runs):
    """A line a weight seed and policy, in JAX's order, with JAX's keys plus
    the devices and the launches; each line's deviations within 5e-5 of JAX's (the
    grouped picks are JAX's; the nearest ones can order exact ties
    otherwise); the plain versions ran (no launch)."""
    want = [x for x in neighbor_runs["want"] if "policy" in x]
    got = [x for x in neighbor_runs["printed"] if "policy" in x]
    assert [(x["weight_seed"], x["policy"]) for x in got] == [
        (x["weight_seed"], x["policy"]) for x in want] == [(100, "grouped"), (100, "nearest")]
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device", "oracle_device", "launches"}
        assert set(g["launches"]) == set(ck.LAUNCHES)
        assert g["device"] == g["oracle_device"] == "cpu" and g["clouds"] == w["clouds"] == 2
        for key in ("mean_abs_dev", "max_abs_dev"):
            assert abs(g[key] - w[key]) <= 5e-5, (g, w)
    for line in neighbor_runs["lines"]:
        assert line["pl"].shape == line["pl_ref"].shape == (2, 4)
        np.testing.assert_allclose(np.abs(line["pl"] - line["pl_ref"]).mean(),
                                   line["mean_abs_dev"], rtol=1e-6)
    assert not any(neighbor_runs["launches"].values())


def test_neighbor_study_summaries_match_the_jax_scripts(neighbor_runs):
    """The summary a policy: JAX's keys and caps, deviations within 5e-5."""
    want = [x for x in neighbor_runs["want"] if "summary" in x]
    got = [x for x in neighbor_runs["printed"] if "summary" in x]
    assert got == neighbor_runs["summaries"]
    assert [x["summary"] for x in got] == [x["summary"] for x in want] == ["grouped", "nearest"]
    for g, w in zip(got, want):
        assert set(g) == set(w) and (g["k1"], g["k2"], g["clouds"]) == (w["k1"], w["k2"], 2)
        for key in ("mean_abs_dev", "max_abs_dev"):
            assert abs(g[key] - w[key]) <= 5e-5
        np.testing.assert_allclose(g["per_stratum_mean"], w["per_stratum_mean"], rtol=0,
                                   atol=5e-5)


def test_neighbor_study_clouds_are_the_jax_scripts():
    """`synth` draws the JAX script's clouds in its order (its draws are
    inline there: the same expressions, bit for bit)."""
    port = load_script("torch_neighbor_cap_study")
    rng = np.random.default_rng(0)
    b, n, z_max = 3, 50, 24.24
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = 10.0 * np.sqrt(rng.uniform(0, 1, (b, n)))
    z = rng.uniform(0, 1.5, (b, n)) ** 2 * 10
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    feats[..., 0] = (z / z_max).astype(np.float32)
    got = port.synth(np.random.default_rng(0), b, n, z_max)
    np.testing.assert_array_equal(got[0], feats)
    np.testing.assert_array_equal(got[1], xyz)


# ---------------------------------------------------------------------------
# the gradient study
# ---------------------------------------------------------------------------


def _named(tree):
    """A JAX params tree as {port parameter name: array}."""
    import jax

    from stratanet2_tpu_torch.utils.convert import _flatten

    return _flatten(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def grad_runs():
    """JAX's `grad_study` at n=1024, B=2, one batch, init only (its two
    gradients captured where it takes their cosine), and the port's on
    JAX's `init_pointnet2(PRNGKey(0))` weights."""
    import jax

    from stratanet2_tpu.config import Config as JaxConfig
    from stratanet2_tpu.models import init_pointnet2 as jax_init
    from stratanet2_tpu_torch.models.pointnet2 import PointNet2
    from stratanet2_tpu_torch.utils.convert import load_jax_params

    ns = argparse.Namespace(n=1024, batch=2, seeds=1, skip_pretrain=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        jax_script = load_script("cap_train_study")
        captured = []
        cosine = jax_script.tree_cosine

        def capture(a, b):
            captured.append((_named(a), _named(b)))
            return cosine(a, b)

        mp.setattr(jax_script, "tree_cosine", capture)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_script.grad_study(ns)
    want = json_lines(out.getvalue())

    port = load_script("torch_cap_train_study")
    base, capped, generous = port.grad_configs(ns.n)
    jbase = replace(JaxConfig().model, subsample_size=ns.n, use_pallas=False, knn_chunk=512)
    jm = jax_init(jax.random.PRNGKey(0), jbase)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    state = jax.tree_util.tree_map(np.asarray, jm.state)
    model = load_jax_params(PointNet2(base), params, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ck.reset_launches()
    lines = port.grad_study(ns, "cpu", weight_sets={"init": model}, on_line=lambda line: None)
    return dict(want=want, captured=captured, lines=lines, model=model, before=before,
                launches=ck.launch_counts())


def test_grad_study_gradients_match_jax_on_its_init(grad_runs):
    """The capped and the generous gradient, leaf by leaf, within GRAD_RTOL
    of the leaf's max |g| of JAX's `grads_for` at the same weights and
    batch; every leaf finite and not all zero."""
    (jcap, jgen), = grad_runs["captured"]
    grads = grad_runs["lines"][0]["grads"]
    for name, want in (("capped", jcap), ("generous", jgen)):
        got = grads[name]
        assert set(got) == set(want) and len(got) == 32
        for leaf, w in want.items():
            g = got[leaf]
            assert g.shape == w.shape and np.isfinite(g).all(), (name, leaf)
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"{name} {leaf}")
        assert any(np.abs(g).max() > 0 for g in got.values())


def test_grad_study_lines_match_jax(grad_runs):
    """A line for the batch and the summary, JAX's keys plus the device (the
    losses on the batch's, the launches on the summary), the same caps, the cosine and the norm
    ratio within 1e-3 of JAX's; the source model left as it was (weights
    moved by state_dict, BN state put back)."""
    want, got = grad_runs["want"], [
        {k: v for k, v in x.items() if k != "grads"} for x in grad_runs["lines"]]
    assert [x["study"] for x in got] == [x["study"] for x in want] == ["grad", "grad_summary"]
    for g, w in zip(got, want):
        assert set(g) - set(w) <= {"device", "launches", "loss"} and set(w) <= set(g)
    assert got[0]["capped_k"] == want[0]["capped_k"] == [32, 64]
    assert got[0]["exact_k"] == want[0]["exact_k"] == [128, 64]
    assert abs(got[0]["cosine"] - want[0]["cosine"]) <= 1e-3
    assert abs(got[0]["grad_norm_ratio"] - want[0]["grad_norm_ratio"]) <= 1e-3
    assert abs(got[1]["cosine_mean"] - want[1]["cosine_mean"]) <= 1e-3
    assert abs(got[1]["norm_ratio_mean"] - want[1]["norm_ratio_mean"]) <= 1e-3
    after = grad_runs["model"].state_dict()
    assert all(torch.equal(after[k], v) for k, v in grad_runs["before"].items())
    assert not any(grad_runs["launches"].values())


def test_param_grads_restores_bn_state_and_clears_grads():
    """The train-mode forward moves the BN running state; `param_grads`
    puts it back and leaves no `.grad`, so two calls give the same
    gradient."""
    from stratanet2_tpu_torch.config import Config
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_train_loss
    from stratanet2_tpu_torch.models.pointnet2 import init_pointnet2

    port = load_script("torch_cap_train_study")
    base, capped, _ = port.grad_configs(256)
    model = port.models_for(init_pointnet2(torch.Generator().manual_seed(3), base, "cpu"),
                            (capped,), "cpu")[0]
    kde = fit_kde_mixture(np.random.default_rng(0).uniform(0, 20, 500))
    loss_fn = make_train_loss(replace(Config(), model=capped), kde, "cpu")
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(np.concatenate([rng.uniform(-10, 10, (2, 256, 2)),
                                           rng.uniform(0, 3, (2, 256, 1))], -1).astype(np.float32))
    cloud = torch.cat([xyz[..., :2] / 10, xyz[..., 2:] / capped.z_max,
                       torch.rand(2, 256, 7, generator=torch.Generator().manual_seed(2))], -1)
    gt = torch.tensor([[0.3, 0.7, 0.2, 0.5], [0.6, 0.4, 0.1, 0.8]])
    before = {k: v.clone() for k, v in model.named_buffers()}
    first, loss = port.param_grads(loss_fn, model, cloud, xyz, gt)
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    assert all(p.grad is None for p in model.parameters())
    second, again = port.param_grads(loss_fn, model, cloud, xyz, gt)
    assert loss == again and np.isfinite(loss)
    for k in first:
        np.testing.assert_array_equal(first[k], second[k])
    loss_fn(model, cloud, xyz, gt)  # without param_grads the state moves
    assert any(not torch.equal(v, before[k]) for k, v in model.named_buffers())


def test_models_for_moves_every_tensor():
    """Each cap's model holds the source's tensors; a source of another
    layout is refused."""
    from stratanet2_tpu_torch.models.pointnet2 import init_pointnet2

    port = load_script("torch_cap_train_study")
    base, capped, generous = port.grad_configs(1024)
    src = init_pointnet2(torch.Generator().manual_seed(0), base, "cpu")
    for m, cfg in zip(port.models_for(src, (capped, generous), "cpu"), (capped, generous)):
        assert m.cfg == cfg
        got = m.state_dict()
        assert all(torch.equal(got[k], v) for k, v in src.state_dict().items())
    wrong = init_pointnet2(torch.Generator().manual_seed(0), replace(base, n_input_feats=12),
                           "cpu")
    with pytest.raises(RuntimeError):
        port.models_for(wrong, (capped,), "cpu")


# ---------------------------------------------------------------------------
# the training study
# ---------------------------------------------------------------------------


def _config_fields(cfg):
    """A Config's fields, nested, without the two the port has no copy of."""
    out = dataclasses.asdict(cfg)
    out.pop("comet_disabled", None)
    out["model"].pop("knn_chunk", None)
    return out


@pytest.fixture(scope="module")
def jax_train_calls():
    """The configs, plots and ids JAX's `train_study` hands `train_full`
    at several train_n (`train_full` recorded, not run)."""
    import stratanet2_tpu.learning.train as jtrain

    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        jax_script = load_script("cap_train_study")
        for train_n in (256, 2048, 10000):
            def record(dataset, train_ids, val_ids, cfg, kde, td, sink, fold_id, seed,
                       _n=train_n):
                calls.setdefault(_n, []).append(dict(dataset=dataset, train_ids=train_ids,
                                                     val_ids=val_ids, cfg=cfg, seed=seed,
                                                     fold_id=fold_id))
                return None, [{"MAE_loss": 0.5}], [{"MAE_loss": 0.25}], None

            mp.setattr(jtrain, "train_full", record)
            ns = argparse.Namespace(seed=0, n_plots=10, train_n=train_n, epochs=40)
            with contextlib.redirect_stdout(io.StringIO()):
                jax_script.train_study(ns)
    return calls


@pytest.mark.parametrize("train_n", [256, 2048, 10000])
def test_train_study_configs_match_jax(jax_train_calls, train_n):
    """Each configuration's caps and Config, field for field (bar JAX's
    `knn_chunk` and `comet_disabled`), the plots bit for bit and the split
    and seed as JAX's `train_study` hands them to `train_full`."""
    port = load_script("torch_cap_train_study")
    calls = jax_train_calls[train_n]
    caps = port.train_caps(train_n)
    assert list(caps) == ["capped", "generous"] and len(calls) == 2
    dataset = load_script("torch_learnability_check").make_dataset(10, 0)
    for (name, (k1, k2)), call in zip(caps.items(), calls):
        want = call["cfg"]
        assert (k1, k2) == (want.model.k1, want.model.k2), name
        assert _config_fields(port.train_config(train_n, k1, k2, 40)) == _config_fields(want)
        assert list(call["val_ids"]) == ["L000", "L001"] and len(call["train_ids"]) == 8
        assert call["seed"] == 0 and call["fold_id"] == 1
        assert list(dataset) == list(call["dataset"])
        for pid, item in call["dataset"].items():
            for key, value in item.items():
                np.testing.assert_array_equal(dataset[pid][key], value, err_msg=f"{pid} {key}")


def test_pretrain_config_matches_jax():
    """The generous pretraining's Config as `_pretrain_generous` builds it."""
    from stratanet2_tpu.config import Config as JaxConfig

    port = load_script("torch_cap_train_study")
    cfg = JaxConfig()
    want = replace(cfg, model=replace(cfg.model, subsample_size=2048, k1=128, k2=128,
                                      use_pallas=False),
                   train=replace(cfg.train, n_epoch=12, n_epoch_test=1000, batch_size=8))
    assert _config_fields(port.pretrain_config(2048, 12, 12)) == _config_fields(want)


def test_train_study_runs_on_the_cpu(monkeypatch):
    """A tiny run (10 plots, 1 epoch, train_n 256; matplotlib hidden):
    finite MAEs under JAX's line keys, the caps, the batches and evals it
    counted, no launch on the CPU. The MAE itself is not held to JAX's: the
    two packages draw their initial weights from different generators."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    port = load_script("torch_cap_train_study")
    ns = port.parse_args(["--device", "cpu", "--train_only", "--n_plots", "10", "--epochs",
                          "1", "--train_n", "256"])
    ck.reset_launches()
    lines = port.train_study(ns, "cpu", on_line=lambda line: None)
    assert [x["study"] for x in lines] == ["train", "train", "train_summary"]
    for x, name in zip(lines, ("capped", "generous")):
        assert {"study", "config", "k", "val_MAE", "train_MAE_last"} <= set(x)
        assert x["config"] == name and x["k"] == list(port.train_caps(256)[name])
        assert np.isfinite(x["val_MAE"]) and np.isfinite(x["train_MAE_last"])
        # 8 train plots: a batch of 8 an epoch; 2 val plots: a batch an eval
        assert x["train_batches"] == 1 and x["eval_batches"] == x["evals"] >= 2
        assert not x["figures"]
        assert not any(x["launches"].values())
    assert set(lines[2]) == {"study", "epochs", "n_plots", "delta_val_MAE"}
    assert lines[2]["delta_val_MAE"] == round(lines[0]["val_MAE"] - lines[1]["val_MAE"], 4)
