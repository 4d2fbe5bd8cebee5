"""Per-stage profile of the training step at the reference PROD geometry
(b=20 x 10000 points), on the PyTorch port (counterpart of
`scripts/profile_train.py`).

Each stage is the port's own function on the JAX script's inputs (drawn
from `numpy.random.default_rng(0)` in its order), timed by CUDA events over
`--iters` calls in a row after a warm-up, the best of three:

  fps1, fps2        `ops/fps.farthest_point_sampling` (one part, as the
                    JAX script calls it), 10000 -> 2500 and 2500 -> 625
  bq1, bq2          `cuda_kernels.ball_query` at SA1 and SA2
  SA1 train / eval  `models/pointnet2.set_abstraction_train_fused` (FPS,
                    the ball query and the four SA train passes; BN state
                    updated) and `set_abstraction` (the fused eval kernel)
  SA1 fwd+bwd       the train stage and the gradient of its output's sum
                    in SA1's parameters
  FP2, FP1          `ops/knn.knn_interpolate`, and FP1 with its backward
                    (`cuda_kernels.knn_scatter`)
  forward           the whole model in train and in eval mode
  train step        `learning/train.make_train_step` (on the card its CUDA
                    graph), 8 steps back to back by the synchronised host
                    clock

With `--device cpu` the plain versions run and every time printed is a
CPU time.

Usage:
  python3 scripts/torch_profile_train.py
  python3 scripts/torch_profile_train.py --device cpu --batch 2 --subsample 1024 --iters 1
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from torch_serve_bench import build_kernels, chained  # noqa: E402

TRIALS = 3
TRAIN_STEPS = 8  # steps a trial of the whole train step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=0, help="override batch_size (PROD 20)")
    ap.add_argument("--subsample", type=int, default=0,
                    help="override subsample_size (PROD 10000)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def stages(cfg, dev):
    """[(name, fn)] of the JAX script's stages, on its inputs, and the
    train step's run."""
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import init_train_state, make_train_step
    from stratanet2_tpu_torch.models import init_pointnet2
    from stratanet2_tpu_torch.models.pointnet2 import set_abstraction, set_abstraction_train_fused
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.ops.fps import farthest_point_sampling
    from stratanet2_tpu_torch.ops.knn import knn_interpolate

    mcfg = cfg.model
    b, n = cfg.train.batch_size, mcfg.subsample_size
    c1, c2 = mcfg.n_centroids1, mcfg.n_centroids2
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()

    cloud = t(rng.uniform(0, 1, (b, n, 10)))
    xyz = t(rng.uniform(-10, 10, (b, n, 3)))
    gt = t(rng.uniform(0, 1, (b, 4)))
    feats = cloud[..., 2:].contiguous()
    sub = xyz[:, :c1].contiguous()
    rows = torch.arange(b, device=dev)[:, None]
    cent1 = xyz[rows, farthest_point_sampling(xyz, c1).long()].contiguous()
    cent2 = sub[rows, farthest_point_sampling(sub, c2).long()].contiguous()
    model = init_pointnet2(torch.Generator().manual_seed(0), mcfg, device=dev)
    fps_kw = dict(fps_parts=mcfg.fps_parts, fps_min_part_samples=mcfg.fps_min_part_samples)
    x2 = t(rng.uniform(-1, 1, (b, c2, 64)))
    x1 = t(rng.uniform(-1, 1, (b, c1, 34)))
    x1g = x1.clone().requires_grad_(True)
    sa1_params = list(model.sa1.parameters())

    def sa1_train():
        model.train()
        return set_abstraction_train_fused(model.sa1, feats, xyz, c1, mcfg.r1, mcfg.k1, **fps_kw)

    def sa1_eval():
        model.eval()
        with torch.inference_mode():
            return set_abstraction(model.sa1, feats, xyz, c1, mcfg.r1, mcfg.k1, **fps_kw)

    def sa1_grad():
        out, _ = sa1_train()
        return torch.autograd.grad(out.sum(), sa1_params)

    def fp1_grad():
        return torch.autograd.grad(knn_interpolate(x1g, cent1, xyz).sum(), x1g)

    def forward(train: bool):
        def fn():
            model.train(train)
            with torch.inference_mode(not train):
                return model(feats, xyz)
        return fn

    kde = fit_kde_mixture(np.random.default_rng(0).uniform(0, 20, 10000))
    ts = init_train_state(cfg, steps_per_epoch=10, seed=0, device=dev)
    step = make_train_step(cfg, kde, device=dev)

    def train_step():
        return step(ts.model, ts.optimizer, ts.scheduler, cloud, xyz, gt)

    timed = [
        (f"fps1 ({n}->{c1})", lambda: farthest_point_sampling(xyz, c1)),
        (f"fps2 ({c1}->{c2})", lambda: farthest_point_sampling(sub, c2)),
        (f"ball_query1 ({c1}x{n}, K={mcfg.k1})",
         lambda: ck.ball_query(cent1, xyz, mcfg.r1, mcfg.k1)),
        (f"ball_query2 ({c2}x{c1}, K={mcfg.k2})",
         lambda: ck.ball_query(cent2, sub, mcfg.r2, mcfg.k2)),
        ("SA1 fwd train (fused SA train passes)", sa1_train),
        ("SA1 fwd eval (fused kernel)", sa1_eval),
        ("SA1 fwd+bwd train", sa1_grad),
        (f"kNN FP2 ({c2}->{c1}, F=64) fwd", lambda: knn_interpolate(x2, cent2, cent1)),
        (f"kNN FP1 ({c1}->{n}, F=34) fwd", lambda: knn_interpolate(x1, cent1, xyz)),
        ("kNN FP1 fwd+bwd", fp1_grad),
        ("full forward train=True", forward(True)),
        ("full forward train=False", forward(False)),
    ]
    return timed, train_step


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.utils.profiling import card_name, time_ms

    dev = resolve_device(ns.device)
    cfg = default_config()
    if ns.subsample:
        cfg = replace(cfg, model=replace(cfg.model, subsample_size=ns.subsample))
    if ns.batch:
        cfg = replace(cfg, train=replace(cfg.train, batch_size=ns.batch))
    print(f"device: {card_name(dev)}")
    built = build_kernels(dev)
    if built is not None:
        print(f"kernels built in {built:.2f} s")
    timed, train_step = stages(cfg, dev)
    rows = []
    for name, fn in timed:
        rows.append((name, min(time_ms(fn, ns.iters, dev) for _ in range(TRIALS))))
    train_step()  # the warm-up and the graph's capture
    host, events = chained(train_step, TRAIN_STEPS, dev)
    rows.append(("FULL TRAIN STEP (fwd+proj+loss+bwd+adam)", host))
    if events is not None:
        rows.append(("  (the train step by CUDA events)", events))

    b, n = cfg.train.batch_size, cfg.model.subsample_size
    what = ("stages by CUDA events, the train step by the synchronised host clock"
            if dev.type == "cuda" else "CPU times")
    print(f"\nPROD geometry b={b} x n={n}, device={dev.type} ({what})")
    print(f"{'stage':<45} {'ms':>8}")
    for name, ms in rows:
        print(f"{name:<45} {ms:>8.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
