"""The fixed-K neighbour cap's deviation from the reference's selection,
measured on the PyTorch port (counterpart of `scripts/neighbor_cap_study.py`).

SA neighbourhoods keep a fixed K (PROD k1=32 / k2=64) per centroid, where the
reference keeps an arbitrary <=2000-neighbour subset of the whole ball
(model/point_net2.py:23-25). This script measures the plot-level coverage
deviation that causes on clouds at the PROD geometry (N=10000), with the
same weights both ways:

  oracle : the reference-semantics forward (`utils/reference_oracle`), cap
           2000, on the CPU: it is the standard, not the system under test
  port   : the port's eval forward at PROD caps on `--device` (default
           cuda), for both `ball_query_method` policies, on the unfused SA
           route (`use_pallas=False`, as the JAX script runs it)

The clouds come from `default_rng(0)` in the JAX script's order, the weights
from `make_reference_state_dict(100 + ws)` through the port's
`utils/torch_import.params_from_torch_state_dict`. Each JSON line has the
JAX script's keys, plus the device of the port's forward and of the
oracle's and the kernel launches of the port's forward.

Usage:
  python3 scripts/torch_neighbor_cap_study.py [--n_clouds 20] [--n 10000] [--seeds 3]
  python3 scripts/torch_neighbor_cap_study.py --device cpu --n 1024 --n_clouds 2 --seeds 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

POLICIES = ("grouped", "nearest")
ORACLE_CAP = 2000  # the reference's max_num_neighbors (model/point_net2.py:24)


def synth(rng: np.random.Generator, b: int, n: int, z_max: float) -> Tuple[np.ndarray, np.ndarray]:
    """`b` disk clouds of `n` points (features (b, n, 8), centred xyz in
    metres (b, n, 3)), drawn in the JAX script's order."""
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = 10.0 * np.sqrt(rng.uniform(0, 1, (b, n)))
    z = rng.uniform(0, 1.5, (b, n)) ** 2 * 10
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    feats[..., 0] = (z / z_max).astype(np.float32)
    return feats, xyz


def study_config(n: int):
    """The study's model config: PROD's at `n` points on the unfused SA
    route."""
    from stratanet2_tpu_torch.config import Config

    return replace(Config().model, subsample_size=n, use_pallas=False)


def port_coverages(sd: Dict, mcfg, feats: np.ndarray, xyz: np.ndarray, device) -> np.ndarray:
    """The port's eval forward and plot projection of a batch with the
    reference-layout weights `sd`, on `device`: (B, 4) plot coverages."""
    import torch

    from stratanet2_tpu_torch.ops.projection import plotwise_coverages
    from stratanet2_tpu_torch.utils.torch_import import params_from_torch_state_dict

    model = params_from_torch_state_dict(sd, mcfg, device)
    x = torch.from_numpy(feats).to(device)
    pos = torch.from_numpy(xyz).to(device)
    xy = (pos[..., :2] / 10.0).contiguous()
    with torch.no_grad():
        cov, _ = model(x, pos)
        pl = plotwise_coverages(cov, xy, mcfg.diam_pix)
    return pl.cpu().numpy()


def study(n_clouds: int = 20, n: int = 10000, seeds: int = 3, device: Optional[str] = None,
          on_line: Optional[Callable[[Dict], None]] = None) -> Tuple[List[Dict], List[Dict]]:
    """Every weight seed x policy: (the lines, each with the JAX script's
    keys plus `device`, `oracle_device`, the kernel `launches` of the port's
    forward and, not printed, the port's plot coverages `pl` and the
    oracle's `pl_ref`; the summaries a policy). `on_line` takes each line as
    it is made."""
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.reference_oracle import (
        make_reference_state_dict,
        reference_forward,
        reference_plotwise_coverages,
    )

    dev = resolve_device(device)
    mcfg = study_config(n)
    rng = np.random.default_rng(0)
    per_policy: Dict[str, List[np.ndarray]] = {p: [] for p in POLICIES}
    lines: List[Dict] = []
    clouds_per_seed = -(-n_clouds // seeds)
    for ws in range(seeds):
        sd = make_reference_state_dict(seed=100 + ws)
        feats, xyz = synth(rng, clouds_per_seed, n, mcfg.z_max)
        xy = (xyz[..., :2] / 10.0).astype(np.float32)
        cov_ref, _ = reference_forward(
            sd, feats, xyz, n_centroids1=mcfg.n_centroids1, n_centroids2=mcfg.n_centroids2,
            r1=mcfg.r1, r2=mcfg.r2, max_num_neighbors=ORACLE_CAP,
        )
        pl_ref = reference_plotwise_coverages(cov_ref, xy, mcfg.diam_pix)
        for policy in POLICIES:
            before = ck.launch_counts()
            pl = port_coverages(sd, replace(mcfg, ball_query_method=policy), feats, xyz, dev)
            launches = {k: v - before[k] for k, v in ck.launch_counts().items()}
            dev_abs = np.abs(pl - pl_ref)
            per_policy[policy].append(dev_abs)
            lines.append({
                "weight_seed": 100 + ws,
                "policy": policy,
                "clouds": int(pl.shape[0]),
                "mean_abs_dev": float(np.mean(dev_abs)),
                "max_abs_dev": float(np.max(dev_abs)),
                "device": str(dev),
                "oracle_device": "cpu",
                "pl": pl, "pl_ref": pl_ref, "launches": launches,
            })
            if on_line:
                on_line(lines[-1])
    summaries = []
    for policy, devs in per_policy.items():
        d = np.concatenate(devs, axis=0)  # (clouds, 4)
        summaries.append({
            "summary": policy,
            "k1": mcfg.k1,
            "k2": mcfg.k2,
            "clouds": int(d.shape[0]),
            "mean_abs_dev": float(d.mean()),
            "max_abs_dev": float(d.max()),
            "per_stratum_mean": [float(v) for v in d.mean(0)],
        })
    return lines, summaries


PRIVATE = ("pl", "pl_ref")  # a line's keys that are returned, not printed


def printable(line: Dict) -> Dict:
    return {k: v for k, v in line.items() if k not in PRIVATE}


def main(argv: Optional[Sequence[str]] = None) -> Tuple[List[Dict], List[Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_clouds", type=int, default=20)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--seeds", type=int, default=3, help="weight seeds")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    lines, summaries = study(ns.n_clouds, ns.n, ns.seeds, ns.device,
                             on_line=lambda line: print(json.dumps(printable(line)), flush=True))
    for row in summaries:
        print(json.dumps(row), flush=True)
    return lines, summaries


if __name__ == "__main__":
    main()
