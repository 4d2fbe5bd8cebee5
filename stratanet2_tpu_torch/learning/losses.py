"""Training losses (counterpart of `stratanet2_tpu/learning/losses.py`,
reference learning/loss_functions.py).

Total loss = abs + m * NLL + e * entropy (learning/train.py:62):

- `absolute_loss`: per-stratum sqrt((pred - gt)^2 + 1e-4) on strata
  [low, med, high] (indices 0, 2, 3), mean over plots, then over strata.
- `entropy_loss`: binary entropy of the medium/high class probabilities.
- `nll_loss`: negative log-likelihood of the pointwise class probabilities
  under the KDE strata prior of z, read off the fitted equidistant grid by
  direct bracket arithmetic, with the likelihood floored at 1e-38 so that a
  point beyond the grid, where a stratum's pdf is exactly 0, gives a finite
  loss.

`torch.maximum` against a tensor, not `clamp_min`: at equality it gives
half the gradient to each side, as `jnp.maximum` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-4
STRATA_IDX = (0, 2, 3)  # low_veg, med_veg, high_veg
_LIKELIHOOD_FLOOR = 1e-38


def absolute_loss_by_strata(pred_pl: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, 4), (B, 4) -> (3,) per-stratum smoothed MAE."""
    # column by column: indexing with a list would copy it to the device
    d = torch.stack([pred_pl[:, i] - gt[:, i] for i in STRATA_IDX], dim=1)
    return torch.mean(torch.sqrt(d * d + EPS), dim=0)


def absolute_loss(pred_pl: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(absolute_loss_by_strata(pred_pl, gt))


def entropy_terms(proba_pointwise: torch.Tensor) -> torch.Tensor:
    """(..., 4) class probabilities -> (..., 2) p log p + (1 - p) log(1 - p)
    on channels 2:; the entropy loss is minus their mean."""
    p = proba_pointwise[..., 2:]
    return p * torch.log(p + EPS) + (1 - p) * torch.log(1 - p + EPS)


def entropy_loss(proba_pointwise: torch.Tensor) -> torch.Tensor:
    """(..., 4) class probabilities -> scalar binary entropy on channels 2:."""
    return -torch.mean(entropy_terms(proba_pointwise))


def nll_loss(
    proba_pointwise: torch.Tensor,
    z_meters: torch.Tensor,
    kde_grid: torch.Tensor,
    kde_pdfs: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """KDE-mixture NLL of (..., 4) probabilities at (...) altitudes in
    metres, under the prior's (G,) grid and (3, G) pdfs. Returns (loss,
    (p_all (..., 3), pdf_all (..., 3)))."""
    log_likelihood, aux = nll_terms(proba_pointwise, z_meters, kde_grid, kde_pdfs)
    return -torch.mean(log_likelihood), aux


def nll_terms(
    proba_pointwise: torch.Tensor,
    z_meters: torch.Tensor,
    kde_grid: torch.Tensor,
    kde_pdfs: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The (...) floored log-likelihoods whose mean `nll_loss` negates, and
    (p_all, pdf_all)."""
    grid_n = kde_grid.shape[0]
    table = torch.cat([kde_pdfs.T, torch.roll(kde_pdfs.T, -1, dims=0)], dim=1)  # (G, 6)
    dz = kde_grid[1] - kde_grid[0]
    t = (z_meters - kde_grid[0]) / dz
    i = torch.clamp(torch.floor(t).int(), 0, grid_n - 2)
    frac = torch.clamp(t - i.to(z_meters.dtype), 0.0, 1.0)
    rows = table[i.long()]  # (..., 6): [g, m, h] at i, then at i + 1
    pdf_all = rows[..., :3] + (rows[..., 3:] - rows[..., :3]) * frac[..., None]
    p_ground = proba_pointwise[..., 0] + proba_pointwise[..., 1]
    p_all = torch.stack([p_ground, proba_pointwise[..., 2], proba_pointwise[..., 3]], dim=-1)
    likelihood = torch.sum(p_all * pdf_all, dim=-1)
    likelihood = torch.maximum(likelihood, likelihood.new_full((), _LIKELIHOOD_FLOOR))
    return torch.log(likelihood), (p_all, pdf_all)


def total_loss(
    pred_pl: torch.Tensor,
    gt: torch.Tensor,
    proba_pointwise: torch.Tensor,
    z_meters: torch.Tensor,
    kde_grid: torch.Tensor,
    kde_pdfs: torch.Tensor,
    m: float,
    e: float,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]]:
    """abs + m*NLL + e*entropy. Returns (loss, (components, nll aux))."""
    l_abs = absolute_loss(pred_pl, gt)
    l_nll, aux = nll_loss(proba_pointwise, z_meters, kde_grid, kde_pdfs)
    l_e = entropy_loss(proba_pointwise)
    loss = l_abs + m * l_nll + e * l_e
    comps = {"total_loss": loss, "MAE_loss": l_abs, "log_loss": l_nll, "entropy_loss": l_e}
    return loss, (comps, aux)
