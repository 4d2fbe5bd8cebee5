"""Weights between the JAX package and the port.

`from_jax_params` takes the JAX `PointNet2Params` pytree as nested
dicts/lists of arrays (`params`, `state`; e.g. after
`jax.tree_util.tree_map(np.asarray, ...)`) and returns a loaded port model
(`load_jax_params` loads them into a model that exists);
`to_jax_params` is its inverse, and `grads_to_jax` gives the parameter
gradients in the params layout. The layouts agree leaf for leaf (Linear `w`
is (in, out) on both sides), so every leaf maps to one tensor of the same
shape; a leaf that maps nowhere, a tensor left unset, or a shape that
differs raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import ModelConfig
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.models.pointnet2 import PointNet2

_STATE_LEAVES = ("mean", "var")  # BN running statistics, under ".bn." here


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _state_name(path: str) -> str:
    head, _, leaf = path.rpartition(".")
    return f"{head}.bn.{leaf}"


def from_jax_params(
    params: Any,
    state: Any,
    cfg: ModelConfig = ModelConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> PointNet2:
    """A PointNet2 with the JAX model's weights and BN state, on `device`
    (default CUDA), in eval mode."""
    model = load_jax_params(PointNet2(cfg), params, state)
    return model.to(resolve_device(device)).eval()


def load_jax_params(model: PointNet2, params: Any, state: Any) -> PointNet2:
    """Copy the JAX model's weights and BN state into `model`, in place (its
    device and mode unchanged), and return it."""
    leaves = _flatten(params)
    for path, value in _flatten(state).items():
        leaves[_state_name(path)] = value
    targets = model.state_dict()
    unmapped = sorted(set(leaves) - set(targets))
    unset = sorted(set(targets) - set(leaves))
    if unmapped or unset:
        raise ValueError(
            f"JAX leaves with no port tensor: {unmapped}; port tensors with no "
            f"JAX leaf: {unset}"
        )
    loaded = {}
    for name, target in targets.items():
        value = torch.from_numpy(np.array(leaves[name], dtype=np.float32))
        if value.shape != target.shape:
            raise ValueError(
                f"{name}: JAX leaf has shape {tuple(value.shape)}, the port "
                f"expects {tuple(target.shape)}"
            )
        loaded[name] = value
    model.load_state_dict(loaded)
    return model


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        node = root
        parts = path.split(".")
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def to_jax_params(model: PointNet2) -> Tuple[Any, Any]:
    """(params, state) as nested dicts/lists of float32 numpy arrays, in the
    layout of the JAX `PointNet2Params`."""
    params, state = {}, {}
    for name, tensor in model.state_dict().items():
        value = tensor.detach().cpu().numpy().copy()
        head, _, leaf = name.rpartition(".")
        if leaf in _STATE_LEAVES and head.endswith(".bn"):
            state[f"{head[: -len('.bn')]}.{leaf}"] = value
        else:
            params[name] = value
    return _unflatten(params), _unflatten(state)


def grads_to_jax(model: PointNet2) -> Any:
    """The parameters' `.grad` as nested dicts/lists of float32 numpy
    arrays, in the layout of the JAX params (a parameter without a gradient
    raises)."""
    grads = {}
    for name, param in model.named_parameters():
        if param.grad is None:
            raise ValueError(f"{name} has no gradient")
        grads[name] = param.grad.detach().cpu().numpy().copy()
    return _unflatten(grads)
