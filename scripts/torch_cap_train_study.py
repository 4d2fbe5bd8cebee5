"""The fixed-K neighbour cap's effect on TRAINING, measured on the PyTorch
port (counterpart of `scripts/cap_train_study.py`).

1. gradient study: at shared weights and identical batches, the parameter
   gradients of the whole train loss (plot projection and the 3-term loss:
   `learning/train.make_train_loss`, the function the train step
   differentiates) under PROD caps against generous caps (K at or above the
   in-ball count): the cosine and the norm ratio a batch, then a summary,
   at init and at weights pretrained with the generous caps.
2. training study: two short `train_full` runs on the learnability
   check's plots (`torch_learnability_check.make_dataset`), capped against
   generous K, same data and seed: the final val MAE of each.

Cap scaling as the JAX script's: the PROD cap keeps ~16% of the expected
r1-ball (k1=32 of ~200 in-ball points at N=10000 over the 10 m disk) and
~32% of the r2-ball; the training study's smaller geometry scales the caps
to the same fractions.

Every forward runs on `--device` (default cuda) on the unfused SA route
(`use_pallas=False`, as the JAX script's), where the generous grouped caps
(512 / 256 at N=10000) need no limit. A model carries its configuration,
so each cap's model is built apart and the weights move by `state_dict`
(checked equal, tensor for tensor); its train-mode forward updates the BN
running state in place, which the gradient study puts back after each
gradient. The JAX script's `knn_chunk` sizes XLA's chunking and has no
counterpart here. The initial weights are the port's
`init_pointnet2(torch.Generator().manual_seed(0))`, not JAX's
`PRNGKey(0)` draw, so the cosines and MAEs are a new draw.

Each JSON line has the JAX script's keys, plus the device, the kernel
launches of what it measured, a batch's two losses and a training run's
seconds, batches and evals.

Usage:
  python3 scripts/torch_cap_train_study.py [--grad_only|--train_only] [--skip_pretrain]
  python3 scripts/torch_cap_train_study.py --device cpu --n 1024 --batch 2 --seeds 1 \\
      --skip_pretrain --n_plots 10 --epochs 2 --train_n 256
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(SCRIPTS, ".."))
sys.path.insert(0, SCRIPTS)

PRIVATE = ("grads",)  # a line's keys that are returned, not printed


def printable(line: Dict) -> Dict:
    return {k: v for k, v in line.items() if k not in PRIVATE}


def emit(line: Dict) -> None:
    print(json.dumps(printable(line)), flush=True)


def tree_cosine(a: Dict, b: Dict) -> float:
    """The cosine of two gradients ({name: array}) flattened in one order."""
    fa = np.concatenate([np.ravel(a[k]) for k in sorted(a)])
    fb = np.concatenate([np.ravel(b[k]) for k in sorted(a)])
    return float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb) + 1e-30))


def tree_norm(a: Dict) -> float:
    return float(np.sqrt(sum(float((x ** 2).sum()) for x in a.values())))


def grad_configs(n: int):
    """(base, capped, generous) model configs of the gradient study at n
    points: PROD caps 32 / 64 against min(512, n // 8) / min(256, C1 // 4)
    (E|r1-ball| = 0.02 n, E|r2-ball| = 0.08 C1)."""
    from stratanet2_tpu_torch.config import Config

    base = replace(Config().model, subsample_size=n, use_pallas=False)
    capped = replace(base, k1=32, k2=64)
    generous = replace(base, k1=min(512, n // 8), k2=min(256, base.n_centroids1 // 4))
    return base, capped, generous


def train_caps(train_n: int) -> Dict[str, Tuple[int, int]]:
    """The training study's (k1, k2) of each configuration at `train_n`
    points: PROD's fractions of the balls, and generous 128 / 128."""
    return {"capped": (max(4, int(train_n * 0.02 * 0.16) // 4 * 4), 16),
            "generous": (128, 128)}


def train_config(train_n: int, k1: int, k2: int, epochs: int):
    """The training study's Config of one configuration."""
    from stratanet2_tpu_torch.config import Config

    cfg = Config()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=train_n, k1=k1, k2=k2, use_pallas=False),
        train=replace(cfg.train, n_epoch=epochs, n_epoch_test=max(epochs // 4, 1),
                      batch_size=8),
    )


def pretrain_config(train_n: int, epochs: int, n_plots: int):
    """The generous pretraining's Config."""
    from stratanet2_tpu_torch.config import Config

    cfg = Config()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=train_n, k1=128, k2=128, use_pallas=False),
        train=replace(cfg.train, n_epoch=epochs, n_epoch_test=1000,
                      batch_size=min(8, n_plots)),
    )


def learnable_dataset(rng: np.random.Generator, count: int, n: int) -> Dict[str, Dict]:
    """`count` learnable plots of `n` points (each drawn at 1.3 n and
    subsampled), in the JAX script's order, under the ids G000, G001, ..."""
    from stratanet2_tpu_torch.utils.synthetic import make_learnable_plot

    dataset = {}
    for i in range(count):
        cloud, gt = make_learnable_plot(rng, n=int(n * 1.3), center=(0.0, 0.0))
        sel = rng.choice(cloud.shape[1], n, replace=cloud.shape[1] < n)
        pid = f"G{i:03d}"
        dataset[pid] = {
            "cloud": cloud[:, sel], "coverages": gt,
            "plot_center": np.zeros(2, np.float32), "plot_id": pid,
            "N_points_in_cloud": n, "index": i,
        }
    return dataset


def models_for(source, cfgs, device):
    """A model of each config holding `source`'s weights and BN state, moved
    by `state_dict` and checked equal tensor for tensor."""
    import torch

    from stratanet2_tpu_torch.models.pointnet2 import PointNet2

    sd = source.state_dict()
    models = []
    for cfg in cfgs:
        model = PointNet2(cfg).to(device)
        model.load_state_dict(sd)
        got = model.state_dict()
        differ = [k for k in sd if not torch.equal(got[k], sd[k].to(device))]
        if differ or set(got) != set(sd):
            raise RuntimeError(f"the weights did not move whole: {differ}")
        models.append(model)
    return models


def param_grads(loss_fn, model, cloud, xyz, gt) -> Tuple[Dict[str, np.ndarray], float]:
    """The gradient of `loss_fn` at `model`'s parameters, {name: array}, and
    the loss, with the model's BN running state as it was before the
    forward and no `.grad` left behind."""
    import torch

    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, cloud, xyz, gt)
    loss.backward()
    grads = {k: p.grad.detach().cpu().numpy().copy() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(buffers[k])
    return grads, float(loss.detach())


def grad_batches(n: int, batch: int, seeds: int) -> Tuple[Dict[str, Dict], List[Dict]]:
    """The gradient study's plots (rng 7) and its batches: `PlotLoader`'s
    eval batches (its transforms, in order) at n points."""
    from stratanet2_tpu_torch.config import Config
    from stratanet2_tpu_torch.data.loader import PlotLoader

    _, capped, _ = grad_configs(n)
    dataset = learnable_dataset(np.random.default_rng(7), batch * seeds, n)
    cfg = Config()
    loader_cfg = replace(cfg, model=capped, train=replace(cfg.train, batch_size=batch))
    return dataset, list(PlotLoader(dataset, loader_cfg, train=False))


def grad_study(ns, device=None, weight_sets: Optional[Dict] = None,
               on_line: Callable[[Dict], None] = emit) -> List[Dict]:
    """The gradient study's lines (a line a batch with its gradients under
    the private key `grads`, then a summary) for each set of weights:
    `weight_sets` ({name: model}), by default the port's init from seed 0
    and, unless `ns.skip_pretrain`, the generous pretraining's."""
    import torch

    from stratanet2_tpu_torch.config import Config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_train_loss
    from stratanet2_tpu_torch.models.pointnet2 import init_pointnet2
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    dev = resolve_device(device)
    n = ns.n
    base, capped, generous = grad_configs(n)
    kde = fit_kde_mixture(np.random.default_rng(0).uniform(0, 20, 5000))
    cfg = Config()
    losses = {name: make_train_loss(replace(cfg, model=m), kde, dev)
              for name, m in (("capped", capped), ("generous", generous))}
    dataset, batches = grad_batches(n, ns.batch, ns.seeds)

    if weight_sets is None:
        weight_sets = {"init": init_pointnet2(torch.Generator().manual_seed(0), base, dev)}
        if not ns.skip_pretrain:
            weight_sets["trained"] = pretrain_generous(ns, dataset, kde, dev)

    lines = []
    for wname, source in weight_sets.items():
        m_cap, m_gen = models_for(source, (capped, generous), dev)
        coss, normr = [], []
        before = ck.launch_counts()
        for i, batch in enumerate(batches[: ns.seeds]):
            cloud = torch.as_tensor(batch["cloud"], device=dev).float()
            xyz = torch.as_tensor(batch["xyz"], device=dev).float()
            gt = torch.as_tensor(
                np.stack([dataset[p]["coverages"] for p in batch["plot_id"]]), device=dev
            ).float()
            g_cap, loss_cap = param_grads(losses["capped"], m_cap, cloud, xyz, gt)
            g_gen, loss_gen = param_grads(losses["generous"], m_gen, cloud, xyz, gt)
            cos = tree_cosine(g_cap, g_gen)
            ratio = tree_norm(g_cap) / tree_norm(g_gen)
            coss.append(cos)
            normr.append(ratio)
            lines.append({
                "study": "grad", "weights": wname, "batch": i, "n": n,
                "capped_k": [capped.k1, capped.k2],
                "exact_k": [generous.k1, generous.k2],
                "cosine": round(cos, 4),
                "grad_norm_ratio": round(ratio, 4),
                "loss": [loss_cap, loss_gen],
                "device": str(dev),
                "grads": {"capped": g_cap, "generous": g_gen},
            })
            on_line(lines[-1])
        lines.append({
            "study": "grad_summary", "weights": wname,
            "batches": len(coss),
            "cosine_mean": round(float(np.mean(coss)), 4),
            "cosine_min": round(float(np.min(coss)), 4),
            "norm_ratio_mean": round(float(np.mean(normr)), 4),
            "device": str(dev),
            "launches": {k: v - before[k] for k, v in ck.launch_counts().items()},
        })
        on_line(lines[-1])
    return lines


def pretrain_generous(ns, dataset: Dict, kde, device):
    """A few generous-config epochs at `ns.train_n` points for weights past
    init (the shared MLPs do not depend on the geometry): the trained model."""
    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    cfg = pretrain_config(ns.train_n, ns.pretrain_epochs, len(dataset))
    ids = np.array(sorted(dataset.keys()))
    with tempfile.TemporaryDirectory() as td:
        sink = MetricSink(td)
        try:
            ts, _, _, _ = train_full(dataset, ids, ids[:2], cfg, kde, td, sink, fold_id=1,
                                     seed=0, device=device)
        finally:
            sink.close()
    return ts.model


def figures_drawn() -> bool:
    """Whether a run's last eval draws a figure a val plot (a pixel max
    each): where matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def train_study(ns, device=None, on_line: Callable[[Dict], None] = emit) -> List[Dict]:
    """Capped against generous `train_full` on the same plots and seed: a
    line a configuration (with its seconds and launches), then the delta."""
    from torch_learnability_check import make_dataset

    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    dev = resolve_device(device)
    dataset = make_dataset(ns.n_plots, ns.seed)  # the learnability check's plots
    kde = fit_kde_mixture_from_dataset(dataset)
    ids = np.array(sorted(dataset.keys()))
    n_val = ns.n_plots // 5
    lines, results = [], {}
    for name, (k1, k2) in train_caps(ns.train_n).items():
        cfg = train_config(ns.train_n, k1, k2, ns.epochs)
        before = ck.launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            sink = MetricSink(td)
            try:
                _, train_losses, test_losses, _ = train_full(
                    dataset, ids[n_val:], ids[:n_val], cfg, kde, td, sink, fold_id=1,
                    seed=ns.seed, device=dev,
                )
            finally:
                sink.close()
        results[name] = {
            "k": [k1, k2],
            "val_MAE": round(float(test_losses[-1]["MAE_loss"]), 4),
            "train_MAE_last": round(float(train_losses[-1]["MAE_loss"]), 4),
        }
        b = cfg.train.batch_size
        lines.append({"study": "train", "config": name, **results[name],
                      "seconds": time.perf_counter() - t0, "device": str(dev),
                      "train_batches": (len(ids) - n_val) // b * len(train_losses),
                      "evals": len(test_losses),
                      "eval_batches": -(-n_val // b) * len(test_losses),
                      "val_plots": n_val, "figures": figures_drawn(),
                      "launches": {k: v - before[k] for k, v in ck.launch_counts().items()}})
        on_line(lines[-1])
    lines.append({
        "study": "train_summary",
        "epochs": ns.epochs,
        "n_plots": ns.n_plots,
        "delta_val_MAE": round(results["capped"]["val_MAE"] - results["generous"]["val_MAE"], 4),
    })
    on_line(lines[-1])
    return lines


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10000, help="grad-study points (PROD)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n_plots", type=int, default=40)
    ap.add_argument("--train_n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pretrain_epochs", type=int, default=12)
    ap.add_argument("--skip_pretrain", action="store_true")
    ap.add_argument("--grad_only", action="store_true")
    ap.add_argument("--train_only", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ns = parse_args(argv)
    lines = []
    if not ns.train_only:
        lines += grad_study(ns, ns.device)
    if not ns.grad_only:
        lines += train_study(ns, ns.device)
    return lines


if __name__ == "__main__":
    main()
