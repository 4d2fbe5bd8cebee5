"""Import reference PyTorch checkpoints into the port (counterpart of
`stratanet2_tpu/utils/torch_import.py`).

The reference saves `{"state_dict": model.state_dict(), ...}` with
torch.save (model/point_net2.py:186-199). Its key layout (torch_geometric
1.7.2):

  sa{1,2}_module.conv.local_nn.<i>.0.{weight,bias}        Linear of MLP block i
  sa{1,2}_module.conv.local_nn.<i>.2.{weight,bias,        BatchNorm of block i
                                      running_mean,running_var}
  sa3_module.nn.<i>...                                    GlobalSAModule MLP
  fp{3,2,1}_module.nn.<i>...                              FPModule MLPs
  lin1.{weight,bias}, lin2.{weight,bias}                  head

`conv.nn` is accepted for `conv.local_nn` (older torch_geometric), and
`num_batches_tracked` is ignored. A torch Linear stores its weight as
(out, in); the port's `Linear.w` is (in, out), so weights are transposed.
BN weight, bias, running_mean and running_var land on scale, bias, mean and
var. A missing key raises KeyError, as JAX's converter does; a tensor of
another shape raises ValueError (JAX's asserts the Linear weights' shapes).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import ModelConfig
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.models.pointnet2 import STAGES, PointNet2

_MODULE_PREFIXES = {
    "sa1": ("sa1_module.conv.local_nn", "sa1_module.conv.nn"),
    "sa2": ("sa2_module.conv.local_nn", "sa2_module.conv.nn"),
    "sa3": ("sa3_module.nn",),
    "fp3": ("fp3_module.nn",),
    "fp2": ("fp2_module.nn",),
    "fp1": ("fp1_module.nn",),
}
# reference suffix of an MLP block -> the port's tensor under layers.<i>
_BLOCK_TENSORS = {
    "0.weight": "linear.w", "0.bias": "linear.b",
    "2.weight": "bn.scale", "2.bias": "bn.bias",
    "2.running_mean": "bn.mean", "2.running_var": "bn.var",
}


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.from_numpy(np.asarray(v, np.float32))


def _find(sd, prefixes, block: int, suffix: str):
    for pref in prefixes:
        key = f"{pref}.{block}.{suffix}"
        if key in sd:
            return sd[key]
    raise KeyError(f"none of {prefixes} has block {block} suffix {suffix}")


def params_from_torch_state_dict(
    state_dict: Dict[str, object],
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> PointNet2:
    """A PointNet2 of `cfg` holding a reference state_dict's weights and BN
    running statistics (tensors or numpy arrays), on `device` (default
    CUDA), in eval mode."""
    dev = resolve_device(device)
    model = PointNet2(cfg)
    targets = model.state_dict()
    loaded = {}
    for stage in STAGES:
        for i, _ in enumerate(getattr(model, stage).layers):
            for suffix, name in _BLOCK_TENSORS.items():
                loaded[f"{stage}.layers.{i}.{name}"] = _find(
                    state_dict, _MODULE_PREFIXES[stage], i, suffix)
    for lin in ("lin1", "lin2"):
        loaded[f"{lin}.w"] = state_dict[f"{lin}.weight"]
        loaded[f"{lin}.b"] = state_dict[f"{lin}.bias"]
    for name, value in loaded.items():
        t = _to_tensor(value)
        if name.endswith(".w"):
            t = t.t()  # torch (out, in) -> (in, out)
        if t.shape != targets[name].shape:
            raise ValueError(f"{name}: the checkpoint's tensor has shape {tuple(t.shape)}, "
                             f"the model expects {tuple(targets[name].shape)}")
        loaded[name] = t.contiguous()
    model.load_state_dict(loaded)
    return model.to(dev).eval()


def load_reference_checkpoint(
    path: str, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None
) -> PointNet2:
    """A reference PCC_model_*.pt file (a torch.save payload with a
    "state_dict" entry, or a bare state_dict) as a PointNet2 on `device`
    (default CUDA), in eval mode."""
    dev = resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload["state_dict"] if "state_dict" in payload else payload
    return params_from_torch_state_dict(sd, cfg, dev)
