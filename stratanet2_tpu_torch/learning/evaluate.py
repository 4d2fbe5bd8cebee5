"""Evaluation loop (counterpart of `stratanet2_tpu/learning/evaluate.py`,
reference learning/test.py:25-132).

Runs the eval step over ordered batches (padding-aware), aggregates per-plot
losses, builds the per-plot prediction summary rows consumed by
cross-validation analytics, and triggers interpretation figures and
confusion matrices on the reference's schedule. An eval that draws no
figure runs over the val plots on the card when the caller gives their
device-resident eval (`device_eval`, JAX's fast path, evaluate.py:68-121).

Figures never stop training: pandas, matplotlib and sklearn are imported
inside the guarded blocks that draw them, so a machine without them logs a
warning and goes on (the DataFrame of the confusion matrices included,
which JAX builds outside its guard).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data.loader import PlotLoader
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning import metrics as M
from stratanet2_tpu_torch.learning.kde import KdeMixture

logger = logging.getLogger("stratanet2_tpu_torch")

LOSS_KEYS = ("total_loss", "MAE_loss", "log_loss", "MAE_veg_b", "MAE_veg_moy", "MAE_veg_h")
WINDOW = 4  # eval batches kept in flight beyond the one being read


def get_cloud_prediction_summary(
    plot_name: str, pred_pl: np.ndarray, gt: np.ndarray, n_points: int
) -> Dict:
    """Per-plot summary row (learning/test.py:135-149)."""
    return {
        "pl_id": plot_name,
        "pl_N_points": n_points,
        "pred_veg_b": float(pred_pl[0]),
        "pred_sol_nu": float(pred_pl[1]),
        "pred_veg_moy": float(pred_pl[2]),
        "pred_veg_h": float(pred_pl[3]),
        "vt_veg_b": float(gt[0]),
        "vt_sol_nu": float(gt[1]),
        "vt_veg_moy": float(gt[2]),
        "vt_veg_h": float(gt[3]),
    }


def evaluate(
    model,
    dataset: Dict,
    val_ids,
    cfg: Config,
    kde: KdeMixture,
    eval_step,
    stats_path: str,
    sink,
    fold_id: int = 0,
    epoch: int = 0,
    last_epoch: bool = False,
    device_eval=None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Dict[str, float], List[Dict]]:
    """The mean loss parts over the valid plots of `val_ids` and their
    summary rows. `eval_step` is `make_eval_step(cfg, kde, device)`, and
    `model` is on `device` (default CUDA). `device_eval`, (run, dd_val) of
    `data/device_dataset.make_device_eval` and `build_device_dataset` over
    `val_ids`, runs the eval on the card where it draws no figure: not the
    last epoch's, and no plot of `cfg.plot_name_to_visualize_during_training`
    in `val_ids`."""
    dev = resolve_device(device)
    sums = {k: 0.0 for k in LOSS_KEYS}
    n = 0
    summaries: List[Dict] = []
    embeddings: List[np.ndarray] = []
    embedding_names: List[str] = []

    tracked_in_fold = any(pid in cfg.plot_name_to_visualize_during_training for pid in val_ids)
    if device_eval is not None and not last_epoch and not tracked_in_fold:
        from stratanet2_tpu_torch.data.device_dataset import eval_index_table

        run, dd_val = device_eval
        idx, valid = eval_index_table(len(dd_val.plot_ids), cfg.train.batch_size)
        # a generator fixed a fold: every eval of the fold subsamples alike,
        # so the early-stopping signal carries no selection noise
        gen = torch.Generator(device=dev).manual_seed(fold_id)
        preds, comps = run(model, dd_val, torch.from_numpy(idx).to(dev), gen)
        # one read of the card: predictions and loss parts of every plot
        table = torch.cat(
            [preds.reshape(-1, 4), torch.stack([comps[k].reshape(-1) for k in LOSS_KEYS], 1)], 1
        ).cpu().numpy()
        for j in np.flatnonzero(valid):
            pid = dd_val.plot_ids[j]
            for i, k in enumerate(LOSS_KEYS):
                sums[k] += float(table[j, 4 + i])
            n += 1
            cd = dataset[pid]
            summaries.append(get_cloud_prediction_summary(
                pid, table[j, :4], np.asarray(cd["coverages"]),
                int(cd.get("N_points_in_cloud", cd["cloud"].shape[1])),
            ))
        return _finalize_evaluate(
            cfg, sums, n, summaries, embeddings, embedding_names,
            stats_path, sink, fold_id, epoch, last_epoch,
        )

    loader = PlotLoader(dataset, cfg, plot_ids=val_ids, train=False)

    # The card runs ahead of the host: up to WINDOW + 1 batches are queued
    # before the oldest one is read, so its outputs (per-point tensors) stay
    # bounded in device memory.
    def _drain(pending_item):
        nonlocal n
        batch, (pred_pl, cov, proba, comps, aux, g) = pending_item
        if cfg.log_embeddings and last_epoch:
            g = g.cpu().numpy()
            for i in np.where(batch["valid"])[0]:
                embeddings.append(g[i])
                embedding_names.append(batch["plot_id"][i])
        # one read of the card a batch: predictions and loss parts together
        table = torch.cat(
            [pred_pl, torch.stack([comps[k] for k in LOSS_KEYS], dim=1)], dim=1
        ).cpu().numpy()
        for i in np.where(batch["valid"])[0]:
            for j, k in enumerate(LOSS_KEYS):
                sums[k] += float(table[i, 4 + j])
            n += 1
            plot_name = batch["plot_id"][i]
            summaries.append(
                get_cloud_prediction_summary(
                    plot_name,
                    table[i, :4],
                    batch["coverages"][i],
                    int(batch["N_points_in_cloud"][i]),
                )
            )
            if last_epoch or plot_name in cfg.plot_name_to_visualize_during_training:
                _maybe_visualize(
                    batch, i, table[i, :4], cov, aux, cfg, stats_path, fold_id, dev
                )

    pending: List = []
    for batch in loader:
        outs = eval_step(model, batch["cloud"], batch["xyz"], batch["coverages"])
        pending.append((batch, outs))
        if len(pending) > WINDOW:
            _drain(pending.pop(0))
    for item in pending:
        _drain(item)

    return _finalize_evaluate(
        cfg, sums, n, summaries, embeddings, embedding_names,
        stats_path, sink, fold_id, epoch, last_epoch,
    )


def _finalize_evaluate(
    cfg, sums, n, summaries, embeddings, embedding_names,
    stats_path, sink, fold_id, epoch, last_epoch,
) -> Tuple[Dict[str, float], List[Dict]]:
    """Means, embedding exports, histograms and confusion matrices."""
    means = {k: sums[k] / max(n, 1) for k in LOSS_KEYS}

    if embeddings:
        # global SA3 feature per plot (reference `last_G_tensor`, logged to
        # the Comet embedding projector at learning/test.py:152-163)
        emb_path = os.path.join(stats_path, f"embeddings_fold_{fold_id}.npz")
        emb = np.stack(embeddings)
        np.savez(emb_path, embeddings=emb, plot_ids=np.array(embedding_names))
        sink.log_metrics({"embeddings": emb_path})
        from stratanet2_tpu_torch.utils.tboard import write_projector_embedding

        write_projector_embedding(
            os.path.join(stats_path, "tb"),
            f"sa3_global_fold_{fold_id}",
            emb,
            embedding_names,
        )

    if last_epoch and summaries:
        log_mae_histograms(summaries, stats_path, sink, fold_id, epoch)

    freq = cfg.log_confusion_matrix_frequency
    if last_epoch or (freq > 0 and epoch % freq == 0):
        out_dir = os.path.join(stats_path, "img", "confusion_matrices")
        try:
            import pandas as pd

            M.log_confusion_matrices(
                pd.DataFrame(summaries), out_dir, normalize=cfg.normalize_cm,
                fold_id=fold_id, epoch=epoch, qualified=True,
            )
        except Exception as err:  # figures must never kill training
            logger.warning("confusion matrix logging failed: %s", err)

    return means, summaries


def log_mae_histograms(
    summaries: List[Dict], stats_path: str, sink, fold_id: int, epoch: int
) -> None:
    """Per-stratum |pred - gt| histograms on the last eval epoch (reference
    learning/test.py:166-193, Comet log_histogram_3d): one PNG with the three
    distributions plus MetricSink records of the binned counts."""
    names = [
        ("val_MAE_veg_b", "pred_veg_b", "vt_veg_b"),
        ("val_MAE_veg_moy", "pred_veg_moy", "vt_veg_moy"),
        ("val_MAE_veg_h", "pred_veg_h", "vt_veg_h"),
    ]
    errors = {
        name: np.array([abs(s[p] - s[v]) for s in summaries])
        for name, p, v in names
    }
    hist_bins = np.linspace(0.0, 1.0, 21)  # fixed edges: comparable
    for name, err in errors.items():       # across folds + match the PNG
        sink.log_histogram(name, err, epoch=epoch, step=fold_id, bins=hist_bins)
        sink.log_metrics(
            {f"{name}_mean": float(err.mean())}, epoch=epoch, step=fold_id
        )
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 3.5), sharey=True)
        for ax, (name, err) in zip(axes, errors.items()):
            ax.hist(err, bins=hist_bins, color="tab:green", edgecolor="black")
            ax.set_title(f"{name} (mean {err.mean():.3f})")
            ax.set_xlabel("|pred - gt|")
        axes[0].set_ylabel("plots")
        out_dir = os.path.join(stats_path, "img")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"mae_histograms_fold_{fold_id}.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        sink.log_image(out)
    except Exception as err:  # figures must never kill training
        logger.warning("MAE histogram figure failed: %s", err)


def _maybe_visualize(batch, i, pred_pl, cov, aux, cfg, stats_path, fold_id, device):
    try:
        from stratanet2_tpu_torch.utils.visualize import create_predictions_interpretations

        p_all, pdf_all = aux
        create_predictions_interpretations(
            pred_pl=pred_pl,
            gt=batch["coverages"][i],
            coverages_pointwise=cov[i].cpu().numpy(),
            cloud=batch["cloud"][i],
            p_all=p_all[i].cpu().numpy(),
            pdf_all=pdf_all[i].cpu().numpy(),
            plot_name=batch["plot_id"][i],
            plot_center=batch["plot_center"][i],
            cfg=cfg,
            stats_path=stats_path,
            fold_id=fold_id,
            device=device,
        )
    except Exception as err:  # figures must never kill training
        logger.warning("interpretation figure failed for %s: %s", batch["plot_id"][i], err)
