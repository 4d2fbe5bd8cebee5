"""Checkpoint I/O (counterpart of `stratanet2_tpu/utils/checkpoint.py`).

The same files as the JAX package: `PCC_model_fold_n={K}.pt` for a
cross-validation fold, `PCC_model_full.pt` otherwise (reference
model/point_net2.py:194-198), each a pickled dict of numpy trees with
`params`, `model_state`, `opt_state` and `metadata`, written atomically.
`params` and `model_state` are in the JAX layout (`utils/convert.py`), so a
file written by either package loads in the other.

`opt_state` is the optax chain state `(add_decayed_weights,
scale_by_adam, scale_by_learning_rate)` of `learning/train.make_optimizer`:
`(EmptyState(), ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))`. JAX pickles it with its optax classes; the
port reads those as plain tuples (`load_checkpoint` maps every optax class
to one, so optax is never imported) and writes the same leaves in the same
order as plain tuples: `((), (count, mu, nu), (count,))`, `mu` and `nu` in
the params layout, the counts int32 scalars. On the torch side `mu` and
`nu` are Adam's `exp_avg` and `exp_avg_sq`, Adam's count each parameter's
`step`, and the schedule's count `LambdaLR.last_epoch`.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from stratanet2_tpu_torch.utils.convert import _flatten, _unflatten


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def checkpoint_name(fold_id: int) -> str:
    crossvalidating = fold_id > 0
    tag = f"fold_n={fold_id}" if crossvalidating else "full"
    return f"PCC_model_{tag}.pt"


def save_checkpoint(
    path: str,
    params,
    model_state,
    opt_state=None,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": _to_host(params),
        "model_state": _to_host(model_state),
        "opt_state": _to_host(opt_state) if opt_state is not None else None,
        "metadata": metadata or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


class _Leaves(tuple):
    """Stands in for an optax state class while unpickling: the namedtuple
    is rebuilt as a plain tuple of its fields."""

    def __new__(cls, *fields):
        return tuple(fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "optax" or module.startswith("optax."):
            return _Leaves
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def find_checkpoint_by_experiment(experiments_path: str, experiment_id: str) -> str:
    """Locate a checkpoint by experiment id, preferring 'full' over fold
    checkpoints (utils/utils.py:145-153)."""
    matches = []
    for root, _dirs, files in os.walk(experiments_path):
        if os.path.basename(root) == experiment_id or experiment_id in root.split(os.sep):
            matches += [os.path.join(root, f) for f in files if f.endswith(".pt")]
    if not matches:
        raise FileNotFoundError(
            f"no checkpoint for experiment {experiment_id} under {experiments_path}"
        )
    full = sorted(m for m in matches if "full" in os.path.basename(m))
    if full:
        return full[0]
    # exact fold-1 match: a bare substring test would also hit
    # fold_n=10..19, and os.walk order is filesystem-dependent
    fold1 = sorted(
        m for m in matches
        if re.search(r"fold_n=1(?!\d)", os.path.basename(m))
    )
    return (fold1 or sorted(matches))[0]


def adam_state(model: torch.nn.Module, optimizer, scheduler):
    """The optimizer's and the schedule's state as the optax chain's leaves:
    `((), (count, mu, nu), (count,))` with `mu`, `nu` in the params
    layout. Before the first step Adam holds no state: zero moments."""
    mu, nu = {}, {}
    count = 0
    for name, param in model.named_parameters():
        st = optimizer.state.get(param, {})
        if st:
            count = int(st["step"])
        mu[name] = st["exp_avg"] if st else torch.zeros_like(param)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(param)
    return (
        (),
        (np.asarray(count, np.int32), _host_tree(mu), _host_tree(nu)),
        (np.asarray(scheduler.last_epoch, np.int32),),
    )


def _host_tree(flat: Dict[str, torch.Tensor]):
    return _unflatten({k: v.detach().cpu().numpy().copy() for k, v in flat.items()})


def load_adam_state(model: torch.nn.Module, optimizer, scheduler, opt_state) -> None:
    """Restore `adam_state`'s leaves (or JAX's optax chain state read by
    `load_checkpoint`) into the optimizer and the schedule."""
    _, (count, mu, nu), (sched_count,) = opt_state
    mu, nu = _flatten(mu), _flatten(nu)
    names = [name for name, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("optimizer moments do not match the model's parameters")
    for name, param in model.named_parameters():
        optimizer.state[param] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name], np.float32), device=param.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32), device=param.device),
        }
    u = int(sched_count)
    scheduler.last_epoch = u
    scheduler._step_count = u + 1
    lrs = [base * fn(u) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
