"""PointNet2 segmentation backbone (counterpart of
`stratanet2_tpu/models/pointnet2.py`, reference model/point_net2.py:70-153).

  stage   here
  -----   ----------------------------------------------------------------
  SA1     FPS (partitioned at PROD) + SA interior [11 -> 16 -> 16], K=k1
  SA2     FPS + SA interior [19 -> 32], K=k2 (each fused or unfused, below)
  SA3     MLP [35 -> 64] on [x, pos], per-cloud max
  FP3     broadcast of the global feature + skip + MLP [96 -> 64]
  FP2/1   exact 3-NN interpolation + skip + MLP [80 -> 34] / [42 -> 34]
  head    lin 34 -> 16, ReLU, lin 16 -> 5; softmax(4) * sigmoid(1)

The route of SA1 and SA2 follows the config's opt-ins as JAX's
`fused_eligible` does (pointnet2.py:130-137, without its TPU and VMEM
terms): `fused_eligible(cfg)` holds when `use_pallas`, the "grouped"
selection and at most two layers (every `channel_plan` gives SA1 two and
SA2 one).

The fused route, in eval mode: layer 1 distributes over the edge concat
[x_j, pos_j - pos_c], so q = x@W1x + pos@W1p + b1 (per point) and cterm =
pos_c@W1p (per centroid) are two matmuls here, and
`cuda_kernels.sa_fused_eval` does the grouped selection, the gather, both
layers with eval BN folded, and the masked max. In train mode
(`model.train()`) it is the fused train route of the JAX
`_sa_train_fused_path` (pointnet2.py:218-270): the standalone grouped ball
query (`cuda_kernels.ball_query`), q and cterm as two matmuls, and
`ops/sa_train.sa_train_fused`, whose four edge passes compute the BN batch
statistics, the max over the K slots and the gradients without writing an
edge tensor; the BN running state is updated from the statistics it
returns.

The unfused route (`set_abstraction_unfused`) is JAX's XLA path of
`_sa_module` (pointnet2.py:147-215), the one JAX runs when the fused
kernels are not eligible: the selection the config names
(`cuda_kernels.ball_query`, grouped, or `cuda_kernels.ball_query_nearest`),
a gather, the masked-BN MLP (batch statistics in train mode, running ones
in eval mode) and the masked max over the K slots with -1e30 at masked
slots (`torch.amax`, which splits the gradient evenly among ties as
`jnp.max` does). SA1's form gathers [x, pos] and subtracts the
zero-padded centroid offset; SA2's pre-projects q and gathers it with
`gather_rows`, whose backward is the scatter kernel. It is also the
reference the fused train route is held to, and the point-sharded train
step's SA2 stage.

`compute_dtype="bfloat16"` reaches the Linear layers that JAX's
`nn.linear` computes (`models/nn.Linear`): on the unfused route the SA
MLP's (SA1's two layers; none of SA2's, whose only layer is pre-projected),
and on both routes SA3, FP3, FP2, FP1, lin1 and lin2. The pre-projection
matmuls, the fused SA kernels and every distance stay float32.

Given a process group (`group`, the data-parallel ranks of
`learning/train.make_train_step`), every train-mode BatchNorm and the fused
SA route normalise with the statistics of all the group's rows, so that a
rank's forward is its rows of the single-process forward on the global
batch.

SA3, FP3, the MLPs and the head are plain torch in both modes. The
point-sharded paths (`parallel/point_sharded.py`) keep the grouped
selection and float32 whatever the config says, as JAX's do. In train
mode with `cfg.drop` > 0 the head drops units of relu(lin1) at that rate
(pointnet2.py:380, `nn.dropout`), drawing the mask from the generator the
caller passes; without one it raises, as JAX does without a key.

Inputs follow the JAX package: `cloud` (B, N, 8) features with x, y dropped,
`xyz` (B, N, 3) centred positions in metres. The model has 14,997
parameters; BN running statistics are buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from stratanet2_tpu_torch.config import ModelConfig
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.models.nn import MLP, Linear
from stratanet2_tpu_torch.ops import cuda_kernels
from stratanet2_tpu_torch.ops.fps import farthest_point_sampling
from stratanet2_tpu_torch.ops.gather import gather_rows
from stratanet2_tpu_torch.ops.knn import knn_interpolate
from stratanet2_tpu_torch.ops.sa_train import sa_train_fused

STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")


def channel_plan(cfg: ModelConfig):
    """Channels per MLP stage (model/point_net2.py:81-99)."""
    f_in = cfg.n_input_feats - 2  # x and y dropped
    mlp1 = [f_in + 3, 16, 16]
    mlp2 = [mlp1[-1] + 3, 32]
    mlp3 = [mlp2[-1] + 3, 64]
    mlp3_fp = [mlp3[-1] + mlp2[-1], 64]
    mlp2_fp = [mlp3_fp[-1] + mlp1[-1], 34]
    mlp1_fp = [mlp2_fp[-1] + f_in, 34]
    return dict(zip(STAGES, (mlp1, mlp2, mlp3, mlp3_fp, mlp2_fp, mlp1_fp)))


def _centroids(pos, n_centroids, fps_parts, fps_min_part_samples):
    idx = farthest_point_sampling(
        pos, n_centroids, parts=fps_parts, min_part_samples=fps_min_part_samples
    )
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return pos[rows, idx.long()]


def fused_eligible(cfg: ModelConfig, layers: int = 2) -> bool:
    """Whether an SA stage of `layers` layers takes the fused route: JAX's
    `fused_eligible` (pointnet2.py:130-137) without its TPU and VMEM terms."""
    return cfg.use_pallas and cfg.ball_query_method == "grouped" and layers <= 2


OPT_INS = ("ball_query_method", "use_pallas", "compute_dtype")


def check_opt_ins(model: "PointNet2", cfg: ModelConfig) -> None:
    """Raise unless `model` was built with `cfg`'s opt-ins: its forward
    routes by its own config, so a step built for other opt-ins would run
    another route silently."""
    differ = [f"{name}={getattr(model.cfg, name)!r} (the step's {getattr(cfg, name)!r})"
              for name in OPT_INS if getattr(model.cfg, name) != getattr(cfg, name)]
    if differ:
        raise ValueError(f"the model was built with other opt-ins: {', '.join(differ)}")


SELECTIONS = {"grouped": "ball_query", "nearest": "ball_query_nearest"}  # cuda_kernels wrappers


def set_abstraction_unfused(
    mlp: MLP,
    x: torch.Tensor,
    pos: torch.Tensor,
    n_centroids: int,
    radius: float,
    k: int,
    fps_parts: int,
    fps_min_part_samples: int,
    preproject: bool,
    group=None,
    method: str = "grouped",
    dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SA stage on the unfused route: FPS -> the `method` ball query
    ("grouped" or "nearest") -> gather -> masked-BN MLP -> masked max over
    the k slots. `preproject` selects SA2's form (q = x@W1x + pos@W1p + b1
    gathered, minus cterm) over SA1's (gather [x, pos], subtract [0,
    pos_c]); the MLP's Linear layers after the gather compute in `dtype`.
    In train mode the MLP's BN normalises with the batch statistics of the
    valid slots (over `group`'s ranks where given) and updates its running
    state; in eval mode it uses the running state.
    Returns (features (B, C, C_out), centroids (B, C, 3))."""
    centroids = _centroids(pos, n_centroids, fps_parts, fps_min_part_samples)
    select = getattr(cuda_kernels, SELECTIONS[method])
    nbr_idx, nbr_mask = select(centroids.contiguous(), pos.contiguous(), radius, k)  # (B, C, k)
    if preproject:
        q, cterm = _layer1_terms(mlp, x, pos, centroids)
        h = torch.relu(gather_rows(q, nbr_idx) - cterm[:, :, None, :])
        h = mlp.layers[0].bn(h, nbr_mask, group)
        for layer in mlp.layers[1:]:
            h = layer(h, nbr_mask, group, dtype)
    else:
        both = gather_rows(torch.cat([x, pos], dim=-1), nbr_idx)  # (B, C, k, F + 3)
        offset = torch.nn.functional.pad(centroids, (x.shape[-1], 0))  # [0, pos_c]
        h = mlp(both - offset[:, :, None, :], nbr_mask, group, dtype)
    h = h.masked_fill(~nbr_mask[..., None], -1e30)
    return torch.amax(h, dim=2), centroids


def _layer1_terms(mlp: MLP, x, pos, centroids):
    """Layer 1 distributed over the edge concat [x_j, pos_j - pos_c]:
    q = x@W1x + pos@W1p + b1 per point, cterm = pos_c@W1p per centroid."""
    l1 = mlp.layers[0]
    f = x.shape[-1]
    w1 = l1.linear.w
    return x @ w1[:f] + pos @ w1[f:] + l1.linear.b, centroids @ w1[f:]


def set_abstraction_train_fused(
    mlp: MLP,
    x: torch.Tensor,
    pos: torch.Tensor,
    n_centroids: int,
    radius: float,
    k: int,
    fps_parts: int,
    fps_min_part_samples: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train-mode SA stage on the fused route (one or two layers): FPS ->
    standalone grouped ball query -> `sa_train_fused` on q and cterm, with
    the running means as the statistics' shifts. Updates the MLP's BN
    running state from the returned statistics over the M valid edges (of
    every rank of `group`, where given).
    Returns (features (B, C, C_out), centroids)."""
    centroids = _centroids(pos, n_centroids, fps_parts, fps_min_part_samples)
    idx, mask = cuda_kernels.ball_query(centroids.contiguous(), pos.contiguous(), radius, k)
    q, cterm = _layer1_terms(mlp, x, pos, centroids)
    bns = [layer.bn for layer in mlp.layers]
    if len(mlp.layers) == 2:
        w2, b2 = mlp.layers[1].linear.w, mlp.layers[1].linear.b
    elif len(mlp.layers) == 1:
        w2 = b2 = None
    else:
        raise ValueError("the fused SA train route takes one or two layers")
    out, stats, m_edges = sa_train_fused(
        q, cterm, [bn.scale for bn in bns], [bn.bias for bn in bns], w2, b2, idx, mask,
        bn_shifts=[bn.mean for bn in bns], group=group,
    )
    for bn, (mean, var) in zip(bns, stats):
        bn.update_running_stats(mean, var, m_edges)
    return out, centroids


def set_abstraction(
    mlp: MLP,
    x: torch.Tensor,
    pos: torch.Tensor,
    n_centroids: int,
    radius: float,
    k: int,
    fps_parts: int,
    fps_min_part_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS -> grouped ball query -> shared MLP -> masked max over the k
    slots (reference SAModule, model/point_net2.py:14-29), eval mode.
    Returns (features (B, C, C_out), centroids (B, C, 3))."""
    centroids = _centroids(pos, n_centroids, fps_parts, fps_min_part_samples)
    return sa_eval_interior(mlp, x, pos, centroids, radius, k), centroids


def sa_eval_interior(
    mlp: MLP, x: torch.Tensor, pos: torch.Tensor, centroids: torch.Tensor, radius: float, k: int
) -> torch.Tensor:
    """The eval SA interior around given centroids, on the fused kernel:
    (B, C, C_out), the max over each centroid's valid picks
    (`cuda_kernels.NEG` where it has none among these points)."""
    q, cterm = _layer1_terms(mlp, x, pos, centroids)
    a1, c1 = mlp.layers[0].bn.folded()
    if len(mlp.layers) == 2:
        l2 = mlp.layers[1]
        w2, b2 = l2.linear.w, l2.linear.b
        a2, c2 = l2.bn.folded()
    elif len(mlp.layers) == 1:
        w2 = b2 = a2 = c2 = None
    else:
        raise ValueError("the fused SA interior takes one or two layers")
    return cuda_kernels.sa_fused_eval(
        q.contiguous(), pos.contiguous(), centroids.contiguous(), cterm.contiguous(),
        a1, c1, w2, b2, a2, c2, radius, k,
    )


class PointNet2(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        for name, channels in channel_plan(cfg).items():
            setattr(self, name, MLP(channels))
        self.lin1 = Linear(self.fp1.layers[-1].linear.w.shape[1], 16)
        self.lin2 = Linear(16, cfg.n_class + 1)

    def forward(
        self,
        cloud: torch.Tensor,
        xyz: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        return_embeddings: bool = False,
        group=None,
    ):
        """(B, N, 8) features, (B, N, 3) positions -> (coverages (B, N, 4),
        proba (B, N, 4)), and the (B, 64) SA3 global feature as a third
        output if `return_embeddings` (reference `last_G_tensor`). In train
        mode every BN normalises with batch statistics (summed over
        `group`'s ranks where given) and updates its running state, and the
        head's dropout draws from `generator` (on the inputs' device)."""
        cfg = self.cfg
        x0, pos0 = cloud.float(), xyz.float()
        fps_kw = dict(
            fps_parts=cfg.fps_parts, fps_min_part_samples=cfg.fps_min_part_samples
        )
        x1, pos1 = self._sa(self.sa1, x0, pos0, cfg.n_centroids1, cfg.r1, cfg.k1, False,
                            group, fps_kw)
        x2, pos2 = self._sa(self.sa2, x1, pos1, cfg.n_centroids2, cfg.r2, cfg.k2, True,
                            group, fps_kw)
        return self.decode(x0, pos0, x1, pos1, x2, pos2, generator, return_embeddings, group,
                           cfg.compute_dtype)

    def _sa(self, mlp, x, pos, n_centroids, radius, k, preproject, group, fps_kw):
        """One SA stage on the route `fused_eligible` names for it."""
        cfg = self.cfg
        if not fused_eligible(cfg, len(mlp.layers)):
            return set_abstraction_unfused(
                mlp, x, pos, n_centroids, radius, k, **fps_kw, preproject=preproject,
                group=group, method=cfg.ball_query_method, dtype=cfg.compute_dtype)
        if self.training:
            return set_abstraction_train_fused(mlp, x, pos, n_centroids, radius, k, **fps_kw,
                                               group=group)
        return set_abstraction(mlp, x, pos, n_centroids, radius, k, **fps_kw)

    def decode(self, x0, pos0, x1, pos1, x2, pos2, generator=None, return_embeddings=False,
               group=None, dtype: str = "float32"):
        """SA3 -> FP3 -> FP2 -> FP1 -> head from the SA outputs (features
        x and positions pos of levels 0, 1 and 2), the Linear layers'
        operands in `dtype`. Level 0 may be a shard of a cloud's points: FP1
        and the head are pointwise."""
        cfg = self.cfg
        # global SA (model/point_net2.py:32-42): MLP on [x, pos], max over points
        g = torch.amax(self.sa3(torch.cat([x2, pos2], dim=-1), group=group, dtype=dtype), dim=1)
        # FP3: k=1 interpolation from the single global point is a broadcast
        h = self.fp3(torch.cat([g[:, None, :].expand(-1, x2.shape[1], -1), x2], dim=-1),
                     group=group, dtype=dtype)
        h = self.fp2(torch.cat([knn_interpolate(h, pos2, pos1), x1], dim=-1), group=group,
                     dtype=dtype)
        h = self.fp1(torch.cat([knn_interpolate(h, pos1, pos0), x0], dim=-1), group=group,
                     dtype=dtype)

        h = dropout(torch.relu(self.lin1(h, dtype)), cfg.drop, self.training, generator)
        scores = self.lin2(h, dtype)
        proba = torch.softmax(scores[..., : cfg.n_class], dim=-1)
        density = torch.sigmoid(scores[..., cfg.n_class :])
        if return_embeddings:
            return proba * density, proba, g
        return proba * density, proba


def dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout (nn.py:148-158): each unit kept with probability
    1 - rate and scaled by 1 / (1 - rate); the identity in eval mode or at
    rate 0."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        # a training caller that forgot its generator would otherwise train
        # with dropout silently off
        raise ValueError(f"dropout(rate={rate}) in train mode needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def init_pointnet2(
    generator: torch.Generator,
    cfg: ModelConfig = ModelConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> PointNet2:
    """A model initialised as the JAX `init_pointnet2` does: every Linear
    U(+-1/sqrt(fan_in)), BN scale 1 / bias 0 / mean 0 / var 1, and the fixed
    head bias (model/point_net2.py:97-99). Draws come from the CPU
    `generator`; the model is returned on `device` (default CUDA), in eval
    mode."""
    dev = resolve_device(device)
    model = PointNet2(cfg)
    for name in STAGES:
        for layer in getattr(model, name).layers:
            layer.linear.reset_parameters(generator)
    model.lin1.reset_parameters(generator)
    model.lin2.reset_parameters(generator)
    model.lin2.b.copy_(torch.tensor(cfg.head_bias_init, dtype=torch.float32))
    return model.to(dev).eval()
