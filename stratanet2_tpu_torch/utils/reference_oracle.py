"""Reference-semantics forward on the host (a copy of the parts of
`stratanet2_tpu/utils/reference_oracle.py` that the capped-K studies and the
parity evaluation need; plain numpy and torch).

An independent reimplementation of the reference's EXACT eval forward:
long-form batch, farthest-point sampling, capped `radius` neighbourhoods, the
per-edge PointConv MLP with max aggregation, knn_interpolate (k=1/3), the
head, and `project_to_plotwise_coverages`. It is the standard that
`scripts/torch_neighbor_cap_study.py` measures the port's fixed-K neighbour
cap against, and it runs on the CPU by nature: it is not a fallback of the
port's forward.

The math is pinned to:

- SAModule: fps -> radius(cap max_num) -> PointConv
  (model/point_net2.py:14-29)
- PointConv message = local_nn(cat[x_j, pos_j - pos_i]), max aggregation,
  empty target rows filled with 0 (torch_geometric 1.7.2 PointConv,
  add_self_loops=False)
- GlobalSAModule: MLP(cat[x, pos]) -> per-cloud max (:32-42)
- FPModule: knn_interpolate (inverse-d^2, w = 1/max(d^2, 1e-16)) + skip
  concat + MLP (:56-67; torch_geometric knn_interpolate)
- head: lin1 -> ReLU -> dropout(p=0) -> lin2 -> softmax(4) || sigmoid(1);
  coverages = proba * density (:141-153)
- MLP block = Linear -> ReLU -> BatchNorm1d(eval: running stats, eps 1e-5)
  (:45-53)
- plotwise projection: per-cloud min-max binning to diam_pix cells, pixel
  max, bare soil = 1 - low pixel, mean over occupied pixels
  (model/project_to_2d.py:7-55)

Determinism: the reference's `fps` uses a random start (torch_cluster
default); the oracle pins start = the first point of each cloud, as the
port's `ops/fps.farthest_point_sampling` does, so both forwards select the
same centroids. `radius` keeps the first `max_num` in-radius points in
input order (torch_cluster's CPU iteration order).

The rest of the JAX package's oracle (the train loss, rasters, merge, the
hard medium-vegetation band) is held only by the tests and is not copied.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "fps_numpy",
    "radius_numpy",
    "reference_forward",
    "reference_plotwise_coverages",
    "make_reference_state_dict",
]


def fps_numpy(pos: np.ndarray, n_samples: int, start: int = 0) -> np.ndarray:
    """Farthest-point sampling of one (N, 3) cloud; iterative argmax of the
    running min-distance (torch_cluster.fps semantics, deterministic start)."""
    n = pos.shape[0]
    pos = pos.astype(np.float32)
    idxs = np.empty(n_samples, np.int64)
    idxs[0] = start
    min_d2 = np.full(n, np.inf, np.float32)
    last = start
    for i in range(1, n_samples):
        d2 = np.sum((pos - pos[last]) ** 2, axis=1)
        np.minimum(min_d2, d2, out=min_d2)
        last = int(np.argmax(min_d2))
        idxs[i] = last
    return idxs


def radius_numpy(
    pos: np.ndarray, centroids: np.ndarray, r: float, max_num: int
) -> List[np.ndarray]:
    """Per-centroid in-radius point indices (input order, capped at max_num)
    — torch_cluster.radius semantics (model/point_net2.py:23-25)."""
    # exact per-centroid subtraction in float64: the ||c||^2 - 2c.p + ||p||^2
    # expansion in float32 cancels near the ball's boundary and can flip
    # membership for points within ~1e-5 of r^2
    pos64 = np.asarray(pos, np.float64)
    out = []
    for c in np.asarray(centroids, np.float64):
        d2 = np.sum((pos64 - c) ** 2, axis=1)
        hits = np.flatnonzero(d2 <= r * r)
        out.append(hits[:max_num])
    return out


def _mlp_eval(sd: Dict, prefix: str, n_blocks: int, x: torch.Tensor):
    """Seq of (Linear -> ReLU -> BatchNorm1d) in eval mode
    (model/point_net2.py:45-53; torch BN eps 1e-5)."""
    for i in range(n_blocks):
        w = sd[f"{prefix}.{i}.0.weight"]
        b = sd[f"{prefix}.{i}.0.bias"]
        x = F.relu(F.linear(x, w, b))
        rm = sd[f"{prefix}.{i}.2.running_mean"]
        rv = sd[f"{prefix}.{i}.2.running_var"]
        g = sd[f"{prefix}.{i}.2.weight"]
        beta = sd[f"{prefix}.{i}.2.bias"]
        x = (x - rm) / torch.sqrt(rv + 1e-5) * g + beta
    return x


def _pointconv_max(
    sd: Dict,
    prefix: str,
    n_blocks: int,
    x: torch.Tensor,
    pos: torch.Tensor,
    centroids: torch.Tensor,
    neighbor_lists: Sequence[np.ndarray],
):
    """PointConv with max aggregation over explicit edge lists."""
    rows, cols = [], []
    for ci, hits in enumerate(neighbor_lists):
        rows.append(np.full(len(hits), ci, np.int64))
        cols.append(hits)
    row = torch.from_numpy(np.concatenate(rows))
    col = torch.from_numpy(np.concatenate(cols))
    msg = torch.cat([x[col], pos[col] - centroids[row]], dim=1)
    msg = _mlp_eval(sd, prefix, n_blocks, msg)
    out = torch.zeros(centroids.shape[0], msg.shape[1])
    out.scatter_reduce_(
        0, row[:, None].expand_as(msg), msg, reduce="amax", include_self=False
    )
    return out


def _knn_interpolate(x: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor, k: int):
    """torch_geometric.nn.knn_interpolate on one cloud: k nearest sources per
    target, weights 1/max(d^2, 1e-16), normalized."""
    d2 = torch.cdist(pos_tgt, pos_src).pow(2)
    dk, idx = torch.topk(d2, k, dim=1, largest=False)
    w = 1.0 / torch.clamp(dk, min=1e-16)  # (T, k)
    return (x[idx] * w[..., None]).sum(1) / w.sum(1, keepdim=True)


def reference_forward(
    state_dict: Dict,
    cloud: np.ndarray,
    xyz: np.ndarray,
    *,
    n_centroids1: int,
    n_centroids2: int,
    r1: float,
    r2: float,
    max_num_neighbors: int = 2000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the reference forward on a batch, on the CPU.

    Args:
      state_dict: reference-layout weights (keys as model/point_net2.py names
        them; tensors or arrays).
      cloud: (B, N, F) rescaled features with x,y ALREADY dropped (the
        reference drops them at model/point_net2.py:118).
      xyz: (B, N, 3) centered positions in meters.

    Returns:
      (coverages_pointwise, proba_pointwise), each (B, N, 4) float32.
    """
    sd = {
        k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).float()
        for k, v in state_dict.items()
    }

    def n_blocks(prefix):
        i = 0
        while f"{prefix}.{i}.0.weight" in sd:
            i += 1
        return i

    covs, probas = [], []
    with torch.no_grad():
        for b in range(cloud.shape[0]):
            x0 = torch.from_numpy(np.asarray(cloud[b], np.float32))
            pos0 = torch.from_numpy(np.asarray(xyz[b], np.float32))

            # SA1 / SA2 (model/point_net2.py:21-29)
            sa_in = (x0, pos0)
            sa_outs = []
            for name, n_c, r in (
                ("sa1_module.conv.local_nn", n_centroids1, r1),
                ("sa2_module.conv.local_nn", n_centroids2, r2),
            ):
                x, pos = sa_in
                idx = fps_numpy(pos.numpy(), n_c, start=0)
                cent = pos[torch.from_numpy(idx)]
                nbrs = radius_numpy(
                    pos.numpy(), cent.numpy(), r, max_num_neighbors
                )
                x = _pointconv_max(sd, name, n_blocks(name), x, pos, cent, nbrs)
                sa_in = (x, cent)
                sa_outs.append(sa_in)
            (x1, pos1), (x2, pos2) = sa_outs

            # Global SA (:32-42)
            g = _mlp_eval(
                sd, "sa3_module.nn", n_blocks("sa3_module.nn"),
                torch.cat([x2, pos2], dim=1),
            ).max(0).values

            # FP3: k=1 from the single global point == broadcast (:91)
            h = torch.cat([g[None].expand(x2.shape[0], -1), x2], dim=1)
            h = _mlp_eval(sd, "fp3_module.nn", n_blocks("fp3_module.nn"), h)
            # FP2 / FP1: k=3 (:92-93)
            h = torch.cat([_knn_interpolate(h, pos2, pos1, 3), x1], dim=1)
            h = _mlp_eval(sd, "fp2_module.nn", n_blocks("fp2_module.nn"), h)
            h = torch.cat([_knn_interpolate(h, pos1, pos0, 3), x0], dim=1)
            h = _mlp_eval(sd, "fp1_module.nn", n_blocks("fp1_module.nn"), h)

            # head (:141-153); dropout p=0 in eval
            h = F.relu(F.linear(h, sd["lin1.weight"], sd["lin1.bias"]))
            scores = F.linear(h, sd["lin2.weight"], sd["lin2.bias"])
            proba = torch.softmax(scores[:, :4], dim=1)
            density = torch.sigmoid(scores[:, 4:])
            covs.append((proba * density).numpy())
            probas.append(proba.numpy())
    return np.stack(covs), np.stack(probas)


def reference_plotwise_coverages(
    coverages_pointwise: np.ndarray, xy: np.ndarray, diam_pix: int
) -> np.ndarray:
    """project_to_plotwise_coverages (model/project_to_2d.py:7-55) in numpy:
    per-cloud min-max binning, pixel max, bare soil = 1 - low pixel, mean
    over occupied pixels. (B, N, 4), (B, N, 2) -> (B, 4)."""
    out = []
    for cov, xy1 in zip(coverages_pointwise, xy):
        mn, mx = xy1.min(0), xy1.max(0)
        bins = np.floor((xy1 - mn) / (mx - mn + 1e-4) * diam_pix).astype(int)
        flat = bins[:, 0] * diam_pix + bins[:, 1]
        pix_ids = np.unique(flat)
        pix_max = np.stack(
            [cov[flat == p].max(0) for p in pix_ids]
        )  # (n_pix, 4)
        low = pix_max[:, 0]
        out.append(
            [low.mean(), (1.0 - low).mean(), pix_max[:, 2].mean(), pix_max[:, 3].mean()]
        )
    return np.asarray(out, np.float32)


def make_reference_state_dict(
    seed: int, n_input_feats: int = 8, n_class: int = 4
) -> Dict[str, np.ndarray]:
    """Random weights in the reference's state_dict layout (channel plan per
    model/point_net2.py:81-99), with non-trivial BatchNorm running stats so
    that the eval-BN math is exercised."""
    rng = np.random.default_rng(seed)
    mlp1 = [n_input_feats + 3, 16, 16]
    mlp2 = [mlp1[-1] + 3, 32]
    mlp3 = [mlp2[-1] + 3, 64]
    mlp3_fp = [mlp3[-1] + mlp2[-1], 64]
    mlp2_fp = [mlp3_fp[-1] + mlp1[-1], 34]
    mlp1_fp = [mlp2_fp[-1] + n_input_feats, 34]

    sd: Dict[str, np.ndarray] = {}

    def mlp(prefix, channels):
        for i in range(1, len(channels)):
            cin, cout = channels[i - 1], channels[i]
            sd[f"{prefix}.{i-1}.0.weight"] = rng.normal(
                0, 1.0 / np.sqrt(cin), (cout, cin)
            ).astype(np.float32)
            sd[f"{prefix}.{i-1}.0.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
            sd[f"{prefix}.{i-1}.2.weight"] = rng.uniform(0.5, 1.5, cout).astype(
                np.float32
            )
            sd[f"{prefix}.{i-1}.2.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
            sd[f"{prefix}.{i-1}.2.running_mean"] = rng.normal(0.3, 0.3, cout).astype(
                np.float32
            )
            sd[f"{prefix}.{i-1}.2.running_var"] = rng.uniform(0.2, 1.5, cout).astype(
                np.float32
            )

    mlp("sa1_module.conv.local_nn", mlp1)
    mlp("sa2_module.conv.local_nn", mlp2)
    mlp("sa3_module.nn", mlp3)
    mlp("fp3_module.nn", mlp3_fp)
    mlp("fp2_module.nn", mlp2_fp)
    mlp("fp1_module.nn", mlp1_fp)
    sd["lin1.weight"] = rng.normal(0, 1.0 / np.sqrt(34), (16, 34)).astype(np.float32)
    sd["lin1.bias"] = rng.normal(0, 0.1, 16).astype(np.float32)
    sd["lin2.weight"] = rng.normal(0, 1.0 / 4.0, (n_class + 1, 16)).astype(np.float32)
    sd["lin2.bias"] = np.asarray([0.733, 0.266, 0.235, 0.358, 0.500], np.float32)
    return sd
