"""Reference-checkpoint import (`stratanet2_tpu_torch/utils/torch_import.py`)
on the CPU: every tensor of a reference-layout state_dict lands where it
should, the torch.save round trip, equality with the JAX package's
converter, and the port against the reference's own math
(`stratanet2_tpu/utils/reference_oracle.py`) with weights loaded through the
port's import.

The reference-math tests run in tests/test_reference_parity.py's regime:
`ball_query_method="nearest"` with k >= every centroid's true in-radius
count (asserted), N=256, `fps_parts=1`, where the fixed-K neighbourhoods are
the reference's whole balls. Tolerances are that file's: forward within
2e-5; loss parts within rtol 2e-4 and atol 1e-5; every gradient within 5e-3
of max(1e-3, its leaf's max |g|).
"""

import numpy as np
import pytest
import torch

from stratanet2_tpu.config import ModelConfig as JaxModelConfig
from stratanet2_tpu.utils.reference_oracle import (
    make_reference_state_dict,
    reference_forward,
    reference_train_loss,
)
from stratanet2_tpu.utils.torch_import import params_from_torch_state_dict as jax_import
from stratanet2_tpu_torch.config import Config, ModelConfig
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
from stratanet2_tpu_torch.utils.convert import to_jax_params
from stratanet2_tpu_torch.utils.torch_import import (
    load_reference_checkpoint,
    params_from_torch_state_dict,
)
from test_reference_parity import _max_neighbor_count, _synthetic_batch
from test_torch_import import build_reference_state_dict

torch.set_num_threads(1)

# the port's counterpart of test_reference_parity._parity_config
PARITY = ModelConfig(subsample_size=256, k1=48, k2=48, ball_query_method="nearest", fps_parts=1)
BLOCK = {"0.weight": "linear.w", "0.bias": "linear.b", "2.weight": "bn.scale",
         "2.bias": "bn.bias", "2.running_mean": "bn.mean", "2.running_var": "bn.var"}
STAGE = {"sa1_module.conv.local_nn": "sa1", "sa1_module.conv.nn": "sa1",
         "sa2_module.conv.local_nn": "sa2", "sa2_module.conv.nn": "sa2",
         "sa3_module.nn": "sa3", "fp3_module.nn": "fp3", "fp2_module.nn": "fp2",
         "fp1_module.nn": "fp1"}


def _port_name(key: str):
    """The port tensor a reference key lands on, and whether it is
    transposed; None for num_batches_tracked."""
    if key.endswith("num_batches_tracked"):
        return None
    if key.startswith("lin"):
        lin, leaf = key.split(".")
        return (f"{lin}.w", True) if leaf == "weight" else (f"{lin}.b", False)
    prefix, block, suffix = key.rsplit(".", 3)[0], key.rsplit(".", 3)[1], ".".join(
        key.rsplit(".", 3)[2:])
    return f"{STAGE[prefix]}.layers.{block}.{BLOCK[suffix]}", suffix == "0.weight"


@pytest.mark.parametrize("layout", ["local_nn", "conv_nn"])
def test_every_tensor_lands_bit_for_bit(layout):
    """Each tensor of the reference layout (tests/test_torch_import.py's)
    lands on its port tensor bit for bit, Linear weights transposed;
    `conv.nn` is taken for `conv.local_nn`; num_batches_tracked is
    ignored; every port tensor is set."""
    sd = build_reference_state_dict(ModelConfig())
    if layout == "conv_nn":
        sd = {k.replace("conv.local_nn", "conv.nn"): v for k, v in sd.items()}
    model = params_from_torch_state_dict(sd, ModelConfig(), device="cpu")
    assert not model.training
    got = model.state_dict()
    placed = set()
    for key, value in sd.items():
        target = _port_name(key)
        if target is None:
            continue
        name, transposed = target
        want = value.t() if transposed else value
        assert torch.equal(got[name], want.float()), key
        placed.add(name)
    assert placed == set(got)


@pytest.mark.parametrize("fault", ["missing", "bad_shape"])
def test_faults_raise(fault):
    sd = build_reference_state_dict(ModelConfig())
    if fault == "missing":
        del sd["fp2_module.nn.0.2.running_var"]
        with pytest.raises(KeyError, match="suffix 2.running_var"):
            params_from_torch_state_dict(sd, ModelConfig(), device="cpu")
    else:
        sd["sa2_module.conv.local_nn.0.2.bias"] = torch.zeros(31)
        with pytest.raises(ValueError, match="sa2.layers.0.bn.bias"):
            params_from_torch_state_dict(sd, ModelConfig(), device="cpu")


@pytest.mark.parametrize("payload", ["checkpoint", "bare"])
def test_torch_save_round_trip(tmp_path, payload):
    """A torch.save payload as the reference writes it ({"state_dict": ...,
    "best_metric_epoch": ...}), or a bare state_dict, loads to the same
    model as the dict itself."""
    sd = {k: torch.as_tensor(v) for k, v in make_reference_state_dict(seed=1).items()}
    path = tmp_path / "PCC_model_full.pt"
    torch.save({"state_dict": sd, "best_metric_epoch": 3, "best_metric_value": 0.1}
               if payload == "checkpoint" else sd, path)
    model = load_reference_checkpoint(str(path), PARITY, device="cpu")
    want = params_from_torch_state_dict(sd, PARITY, device="cpu").state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert torch.equal(model.lin2.b, torch.tensor([0.733, 0.266, 0.235, 0.358, 0.500]))


def test_equals_the_jax_import():
    """On the oracle's state_dict (numpy arrays), the port's model holds
    JAX's `params_from_torch_state_dict` params and state leaf for leaf."""
    import jax

    sd = make_reference_state_dict(seed=3)
    params, state = to_jax_params(params_from_torch_state_dict(sd, ModelConfig(), device="cpu"))
    jm = jax_import(sd, JaxModelConfig())
    for got, want in ((params, jm.params), (state, jm.state)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, want))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_forward_matches_the_reference():
    """The eval forward with imported weights against `reference_forward`
    (max_num_neighbors 2000, the whole ball) within 2e-5."""
    rng = np.random.default_rng(7)
    feats, xyz = _synthetic_batch(rng, b=2, n=PARITY.subsample_size)
    assert _max_neighbor_count(xyz, PARITY) <= min(PARITY.k1, PARITY.k2)
    sd = make_reference_state_dict(seed=3)
    cov_ref, proba_ref = reference_forward(
        sd, feats, xyz, n_centroids1=PARITY.n_centroids1, n_centroids2=PARITY.n_centroids2,
        r1=PARITY.r1, r2=PARITY.r2, max_num_neighbors=2000)
    model = params_from_torch_state_dict(sd, PARITY, device="cpu")
    with torch.no_grad():
        cov, proba = model(torch.from_numpy(feats), torch.from_numpy(xyz))
    np.testing.assert_allclose(proba.numpy(), proba_ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(cov.numpy(), cov_ref, rtol=0, atol=2e-5)


def test_train_loss_and_gradients_match_the_reference():
    """One `make_train_step` from imported weights: its loss parts and the
    gradients it leaves in `.grad` against torch autograd through
    `reference_train_loss` (train-mode BN over the flattened batch, the
    plotwise projection, abs + m NLL + e entropy), the reference's
    gradients mapped onto the port's tensors by the same import."""
    rng = np.random.default_rng(31)
    b = 2
    feats, xyz = _synthetic_batch(rng, b=b, n=PARITY.subsample_size)
    assert _max_neighbor_count(xyz, PARITY) <= min(PARITY.k1, PARITY.k2)
    cloud = np.concatenate([(xyz[..., :2] / 10.0).astype(np.float32), feats], axis=-1)
    gt = rng.uniform(0, 1, (b, 4)).astype(np.float32)
    kde = fit_kde_mixture(rng.uniform(0, 15, 4000))
    cfg = Config(model=PARITY)
    sd = make_reference_state_dict(seed=13)

    sd_t = {k: torch.tensor(np.asarray(v)).requires_grad_(
        not k.endswith(("running_mean", "running_var"))) for k, v in sd.items()}
    loss_t, comps_t = reference_train_loss(
        sd_t, torch.tensor(cloud), xyz, torch.tensor(gt), np.asarray(kde.grid),
        np.asarray(kde.pdfs), cfg.train.m, cfg.train.e, n_centroids1=PARITY.n_centroids1,
        n_centroids2=PARITY.n_centroids2, r1=PARITY.r1, r2=PARITY.r2, z_max=PARITY.z_max,
        diam_pix=PARITY.diam_pix)
    loss_t.backward()
    grad_sd = {k: (t.grad if t.grad is not None else t.detach()) for k, t in sd_t.items()}
    want = dict(params_from_torch_state_dict(grad_sd, PARITY, device="cpu").named_parameters())

    model = params_from_torch_state_dict(sd, PARITY, device="cpu")
    opt, sched = make_optimizer(cfg, model, steps_per_epoch=1)
    comps = make_train_step(cfg, kde, device="cpu")(model, opt, sched, cloud, xyz, gt)
    for name, value in comps.items():
        np.testing.assert_allclose(float(value), comps_t[name], rtol=2e-4, atol=1e-5,
                                   err_msg=name)
    for name, prm in model.named_parameters():
        g, w = prm.grad.numpy(), want[name].detach().numpy()
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * scale, err_msg=name)
