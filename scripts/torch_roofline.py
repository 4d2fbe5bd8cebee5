"""Roofline of the port's hand-written kernels on an H100 at the steps' call
sites (counterpart of `scripts/roofline.py`, which models a v5e's padded
MXU work; here the card and the work are the port's own).

One function per kernel of PERF.md section 6 (rows 1-12) returns the bytes
and the operations its call needs, from its shapes and, where the work
depends on the data, from what these inputs need (the picks within the
radius, the pairs a cell-grid path must score): each input byte read once,
each output byte written once, and the operations these inputs need. The
bound is the larger of bytes / 3.35 TB/s and float32 operations / 67
TFLOP/s (the H100 SXM data sheet's HBM rate and float32 rate outside the
tensor cores, at 700 W), and names which of the two binds. These counts
and this bound are the only ones in the repo: `chip_smoke.py`'s site
checks call them for every kernel line they print.

The sites are those of one eager body of each step, recorded as
`chip_smoke.py`'s phases 3 and 9 record them: the serve step
(`inference/predict.make_predict_step`: rows 1, 2, 5, 6), the train step
(`learning/train.make_train_step`: rows 3, 4, 7-11) and the serve step on
the nearest selection (row 12), at PROD (B=20 x N=10000) or at
`--batch/--subsample/--diam_pix` (the dense plots: `--subsample 65536
--diam_pix 100`, where the long-shape paths run), weights and batches
from seeds as the smoke draws them. On the card each site is timed by CUDA events (20 launches after a
warm-up) and each kernel's line has its ms a step, its bound, the share
bound / ms, each of its sites on a line below with its shape, bound and
ms, and the card's name and power limit heads the table. On the CPU
(`--device cpu`) the counts and bounds are printed and every time is "not
measured".

Usage:
  python3 scripts/torch_roofline.py [--batch 20] [--subsample 10000]
  python3 scripts/torch_roofline.py --device cpu --batch 2 --subsample 512
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, 700 W
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
REPS = 20  # timed launches a site


class Counts(NamedTuple):
    bytes: float
    ops: float

    def __add__(self, other):
        return Counts(self.bytes + other.bytes, self.ops + other.ops)


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """(the least ms the card could take to move `nbytes` and do `ops`
    float32 operations, "bytes" or "operations": which of the two binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# one function per kernel (PERF.md section 6's rows)
# ---------------------------------------------------------------------------


def fps_counts(rows: int, n: int, s: int) -> Counts:
    """Row 1: FPS of `rows` rows of n points, s picks each: positions and
    starts read, picks written; 10 operations a point and pick after the
    first (distance, min, argmax)."""
    return Counts(rows * n * 12 + rows * 4 + rows * s * 4, 10.0 * (s - 1) * rows * n)


def knn_interpolate_counts(b: int, s: int, t: int, f: int, scored: Optional[float] = None
                           ) -> Counts:
    """Row 2: exact 3-NN of t targets among s sources carrying f features:
    sources and targets read, features, indices and weights written; 11
    operations a pair scored (all b t s pairs on the whole-cloud path, the
    cell grid's own on its path) and 5 f + 12 a target (weights, blend)."""
    scored = float(b * t * s) if scored is None else scored
    return Counts(4.0 * (b * s * (f + 3) + b * t * 3 + b * t * f + 2 * b * 3 * t),
                  11.0 * scored + b * t * (5 * f + 12))


def knn_scatter_counts(b: int, k: int, t: int, s: int, f: int, weighted: bool) -> Counts:
    """Row 3: the kNN (and gather) backward, k picks of t targets into s
    rows of f: ids (and weights) and the gradient read, the sums written;
    a multiply-add a pick and channel (an add unweighted)."""
    w = 2 if weighted else 1
    return Counts(4.0 * (b * k * t * w + b * t * f + b * s * f), float(b * k * t * f * w))


def ball_query_counts(b: int, c: int, n: int, k: int, pairs: Optional[float] = None) -> Counts:
    """Row 4: the grouped ball query of c centroids among n points, k
    groups: positions read, int32 idx and bool mask written; 10 operations
    a pair scored (all b c n pairs whole, the pairs within the radius on
    the cell grid)."""
    pairs = float(b * c * n) if pairs is None else pairs
    return Counts(12.0 * b * (c + n) + 5.0 * b * c * k, 10.0 * pairs)


def sa_fused_eval_counts(b: int, n: int, c: int, k: int, ch1: int, ch2: int, two: bool,
                         valid: float, pairs: Optional[float] = None) -> Counts:
    """Row 5: the fused SA eval, its selection (as row 4's, `pairs`) and,
    over the `valid` picks, layer 1's affine and ReLU, layer 2 with its
    affine and ReLU, and the max: q, positions, centroids and cterm read,
    the (b, c, ch2) maxima written."""
    pairs = float(b * c * n) if pairs is None else pairs
    edge = 4 * ch1 + (2 * ch1 * ch2 + 4 * ch2 if two else 0) + ch2
    return Counts(4.0 * (b * n * (ch1 + 3) + b * c * (3 + ch1) + b * c * ch2),
                  10.0 * pairs + valid * edge)


def pixel_max_counts(b: int, n: int, c: int, n_pix: int) -> Counts:
    """Row 6: per-pixel max and argmax of c channels: pixel ids and values
    read, float maxima and int32 argmaxes written; a compare a value."""
    return Counts(4.0 * b * n + 4.0 * b * n * c + 8.0 * b * n_pix * c, float(b * n * c))


def pixel_max_bwd_counts(b: int, n: int, c: int, n_pix: int) -> Counts:
    """Row 7: the pixel max's gradient routed to its argmax: ids, argmaxes
    and the gradient read, the points' gradient written; no arithmetic."""
    return Counts(4.0 * b * n + 8.0 * b * n_pix * c + 4.0 * b * n * c, 0.0)


def _sa_train_base(b, n, c, k, ch1, ch2, two, aff_width):
    nbytes = 4.0 * (b * n * ch1 + b * c * ch1 + b * c * k) + b * c * k + 4.0 * 15 * aff_width
    nbytes += 4.0 * ch1 * ch2 if two else 0.0
    fwd = 2 * ch1 + (2 * ch1 + 2 * ch1 * ch2 + 2 * ch2 if two else 0)
    return nbytes, fwd


def sa_train_stats_counts(b, n, c, k, ch1, valid, aff_width=None) -> Counts:
    """Row 8: BN1's one-pass statistics over the valid edges: q, cterm,
    idx, mask and the table read, two sums written; 6 operations an edge
    and channel."""
    nbytes, _ = _sa_train_base(b, n, c, k, ch1, ch1, False, aff_width or ch1)
    return Counts(nbytes + 8.0 * ch1, valid * ch1 * 6)


def sa_train_main_counts(b, n, c, k, ch1, ch2, two, valid, aff_width=None) -> Counts:
    """Row 9: the forward over the valid edges and the last BN's sums and
    the max and min with their winners: (b, c, ch2) x 4 written."""
    nbytes, fwd = _sa_train_base(b, n, c, k, ch1, ch2, two, aff_width or max(ch1, ch2))
    return Counts(nbytes + 16.0 * b * c * ch2 + 8.0 * ch2, valid * (fwd + 6 * ch2))


def sa_train_bwd1_counts(b, n, c, k, ch1, ch2, valid, aff_width=None) -> Counts:
    """Row 10: layer 2's backward sums (S1, S2, db2, dW2) over the valid
    edges: the winners' gradients read."""
    nbytes, fwd = _sa_train_base(b, n, c, k, ch1, ch2, True, aff_width or max(ch1, ch2))
    return Counts(nbytes + 8.0 * b * c * ch2 + 4.0 * (3 * ch1 + ch1 * ch2),
                  valid * (fwd + 10 * ch2 + 4 * ch1 * ch2 + 5 * ch1))


def sa_train_bwd2_counts(b, n, c, k, ch1, ch2, two, valid, aff_width=None) -> Counts:
    """Row 11: dq (b, n, ch1) and dcterm (b, c, ch1) written from the
    winners' gradients: the forward, BN2's backward and the transposed
    product, BN1's backward, dcterm's and dq's adds an edge. Its edge
    buffer is a cost of the design, not of the function."""
    nbytes, fwd = _sa_train_base(b, n, c, k, ch1, ch2, two, aff_width or max(ch1, ch2))
    back = (11 * ch2 + 2 * ch1 * ch2) if two else ch1
    return Counts(nbytes + 8.0 * b * c * ch2 + 4.0 * (b * n * ch1 + b * c * ch1),
                  valid * (fwd + back + 10 * ch1))


def ball_query_nearest_counts(b: int, c: int, n: int, k: int, in_radius: float) -> Counts:
    """Row 12: the k nearest in-radius points: positions read, int32 idx
    and bool mask written; 10 operations a pair within the radius."""
    return Counts(4.0 * (b * n * 3 + b * c * 3) + 5.0 * b * c * k, 10.0 * in_radius)


# PERF.md section 6's row of each wrapper, and the step whose sites it takes
ROWS = {"fps": ("1", "serve"), "knn_interpolate": ("2", "serve"), "knn_scatter": ("3", "train"),
        "ball_query": ("4", "train"), "sa_fused_eval": ("5", "serve"),
        "pixel_max": ("6", "serve"), "pixel_max_bwd": ("7", "train"),
        "sa_train_stats": ("8", "train"), "sa_train_main": ("9", "train"),
        "sa_train_bwd1": ("10", "train"), "sa_train_bwd2": ("11", "train"),
        "ball_query_nearest": ("12", "nearest")}


# ---------------------------------------------------------------------------
# the counts of a recorded call
# ---------------------------------------------------------------------------


def in_radius_pairs(cent: torch.Tensor, pts: torch.Tensor, radius: float) -> float:
    """Pairs (centroid, point) within the radius, in the selection's own
    rounding (`ops/distance.expanded_d2`, in the plain selection's tiles):
    the pairs any exact selection must score."""
    from stratanet2_tpu_torch.ops.ballquery import _CHUNK, radius_sq
    from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3, tile_rows

    pts = pts.float()
    r2, pts_sq, total = radius_sq(radius), sq_norm3(pts), 0
    chunk = tile_rows(pts.device, pts.shape[0], pts.shape[1], _CHUNK)
    for c0 in range(0, cent.shape[1], chunk):
        cc = cent[:, c0:c0 + chunk].float()
        total += int((expanded_d2(cc, sq_norm3(cc), pts, pts_sq) <= r2).sum())
    return float(total)


def site_counts(name: str, args: Sequence) -> Tuple[Counts, str]:
    """(counts, shape) of one recorded call of wrapper `name`."""
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped

    if name == "fps":
        xyz, s, _ = args
        r, n, _ = xyz.shape
        return fps_counts(r, n, s), f"rows={r} N={n} S={s}"
    if name == "knn_interpolate":
        x, ps, pt = args
        b, s, f = x.shape
        t = pt.shape[1]
        scored = None
        if ck.knn_path(s, t) == "grid":
            scored = float(ck.knn_interpolate_grid(*args)[3].double().sum())
        return (knn_interpolate_counts(b, s, t, f, scored),
                f"B={b} S={s} T={t} F={f} path={ck.knn_path(s, t)}")
    if name == "knn_scatter":
        idx, w, g, s = args
        b, k, t = idx.shape
        return (knn_scatter_counts(b, k, t, s, g.shape[2], w is not None),
                f"B={b} k={k} T={t} S={s} F={g.shape[2]}")
    if name in ("ball_query", "ball_query_nearest"):
        cent, pts, radius, k = args
        b, c, _ = cent.shape
        n = pts.shape[1]
        if name == "ball_query_nearest":
            inr = in_radius_pairs(cent, pts, radius)
            return (ball_query_nearest_counts(b, c, n, k, inr),
                    f"B={b} C={c} N={n} K={k} in_radius={int(inr)}")
        path = ck.sel_path(-(-n // k), ck.BQ_MAX_G)
        pairs = in_radius_pairs(cent, pts, radius) if path == "grid" else None
        return ball_query_counts(b, c, n, k, pairs), f"B={b} C={c} N={n} K={k} path={path}"
    if name == "sa_fused_eval":
        q, xyz, cent, cterm, _a1, _c1, w2, _b2, _a2, _c2, radius, k = args
        b, n, ch1 = q.shape
        c = cent.shape[1]
        two = w2 is not None
        ch2 = w2.shape[1] if two else ch1
        valid = float(ball_query_grouped(cent, xyz, radius, k)[1].sum())
        path = ck.sel_path(-(-n // k), ck.sa_fused_eval_max_g(ch1, ch2, two, k))
        pairs = in_radius_pairs(cent, xyz, radius) if path == "grid" else None
        return (sa_fused_eval_counts(b, n, c, k, ch1, ch2, two, valid, pairs),
                f"B={b} N={n} C={c} K={k} C1={ch1} C2={ch2} valid_picks={int(valid)} "
                f"path={path}")
    if name in ("pixel_max", "pixel_max_bwd"):
        if name == "pixel_max":
            pix, vals, n_pix = args
            b, n, c = vals.shape
            return pixel_max_counts(b, n, c, n_pix), f"B={b} N={n} C={c} P2={n_pix}"
        pix, amax, g = args
        b, p2, c = g.shape
        n = pix.shape[1]
        return pixel_max_bwd_counts(b, n, c, p2), f"B={b} N={n} C={c} P2={p2}"
    # the SA train passes: (q, cterm, idx, mask, aff[, w2, awin, gt])
    q, _cterm, idx, mask, aff = args[:5]
    w2 = args[5] if len(args) > 5 else None
    b, n, ch1 = q.shape
    c, k = idx.shape[1:]
    two = w2 is not None
    ch2 = w2.shape[1] if two else ch1
    valid, width = float(mask.sum()), aff.shape[1]
    shape = f"B={b} N={n} C={c} K={k} C1={ch1} C2={ch2} valid_edges={int(valid)}"
    if name == "sa_train_stats":
        return sa_train_stats_counts(b, n, c, k, ch1, valid, width), shape
    if name == "sa_train_main":
        return sa_train_main_counts(b, n, c, k, ch1, ch2, two, valid, width), shape
    if name == "sa_train_bwd1":
        return sa_train_bwd1_counts(b, n, c, k, ch1, ch2, valid, width), shape
    return sa_train_bwd2_counts(b, n, c, k, ch1, ch2, two, valid, width), shape


# ---------------------------------------------------------------------------
# the steps' call sites
# ---------------------------------------------------------------------------


def step_sites(cfg, device) -> Dict[str, List[tuple]]:
    """Every kernel's call sites in one eager body of the serve step, the
    train step and the nearest route's serve step at `cfg`'s geometry: the
    serve batch and weights from seed 0, the train batch from seed 1 and
    weights from seed 0 with BN at its init, as `chip_smoke.py` draws
    them."""
    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.profiling import record_calls
    from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch, train_batch

    b, n = cfg.train.batch_size, cfg.model.subsample_size
    names = {step: [k for k, (_, s) in ROWS.items() if s == step]
             for step in ("serve", "train", "nearest")}
    cloud, xyz = serve_batch(b, n, torch.Generator(device=device).manual_seed(0), device)
    model = random_model(cfg.model, 0, device)
    serve = make_predict_step(cfg, device=device)
    sites = record_calls(ck, names["serve"], lambda: serve.body(model, cloud, xyz))
    ncfg = replace(cfg, model=replace(cfg.model, ball_query_method="nearest"))
    nmodel = random_model(ncfg.model, 0, device)
    nearest = make_predict_step(ncfg, device=device)
    sites.update(record_calls(ck, names["nearest"], lambda: nearest.body(nmodel, cloud, xyz)))
    cloud, xyz, gt = train_batch(b, n, torch.Generator(device=device).manual_seed(1), device)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).cpu().numpy())
    tmodel = random_model(cfg.model, 0, device, running_stats=False)
    opt, _ = make_optimizer(cfg, tmodel, 5)
    step = make_train_step(cfg, kde, device=device)
    sites.update(record_calls(ck, names["train"], lambda: step.body(tmodel, opt, cloud, xyz, gt)))
    return sites


def roofline(cfg, device) -> List[dict]:
    """A row for each kernel: its PERF.md row, launches a step, bytes,
    operations, bound ms and what binds, and on the card its ms a step (the
    sum of its sites' CUDA-event means) and the share bound / ms ("not
    measured" on the CPU); each site's own line under "sites"."""
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.profiling import time_ms

    dev = torch.device(device)
    sites = step_sites(cfg, dev)
    rows = []
    with torch.inference_mode():
        for name, (row, step) in ROWS.items():
            total, ms, lines = Counts(0.0, 0.0), 0.0, []
            for args in sites[name]:
                counts, shape = site_counts(name, args)
                total = total + counts
                site = {"shape": shape, "bytes": counts.bytes, "ops": counts.ops,
                        "bound_ms": bound_ms(*counts)[0]}
                if dev.type == "cuda":
                    site["ms"] = time_ms(lambda: getattr(ck, name)(*args), REPS, dev)
                    ms += site["ms"]
                lines.append(site)
            b_ms, by = bound_ms(*total)
            measured = dev.type == "cuda" and bool(lines)
            rows.append({"row": row, "kernel": name, "step": step, "launches": len(lines),
                         "bytes": total.bytes, "ops": total.ops, "bound_ms": b_ms,
                         "bound_by": by, "ms": ms if measured else "not measured",
                         "share": b_ms / ms if measured else "not measured", "sites": lines})
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=0, help="override batch_size (PROD 20)")
    ap.add_argument("--subsample", type=int, default=0,
                    help="override subsample_size (PROD 10000)")
    ap.add_argument("--diam_pix", type=int, default=0,
                    help="override diam_pix (PROD 20; the dense plots' 100)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    cfg = default_config()
    if ns.subsample:
        cfg = replace(cfg, model=replace(cfg.model, subsample_size=ns.subsample))
    if ns.diam_pix:
        cfg = replace(cfg, model=replace(cfg.model, diam_pix=ns.diam_pix))
    if ns.batch:
        cfg = replace(cfg, train=replace(cfg.train, batch_size=ns.batch))
    card = card_name(dev)
    print(f"device: {card}; peaks {FP32_OPS_PER_S / 1e12:g} TFLOP/s float32, "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s (H100 SXM at 700 W)")
    rows = roofline(cfg, dev)
    b, n = cfg.train.batch_size, cfg.model.subsample_size
    print(f"B={b} x N={n} diam_pix={cfg.model.diam_pix}, per step "
          "(serve: rows 1 2 5 6; train: 3 4 7-11; nearest serve: 12)")
    print(f"{'row':>3s} {'kernel':20s} {'launches':>8s} {'bytes':>11s} {'ops':>11s} "
          f"{'bound ms':>9s} {'by':10s} {'ms':>12s} {'share':>12s}")
    for r in rows:
        ms = r["ms"] if isinstance(r["ms"], str) else f"{r['ms']:.5f}"
        share = r["share"] if isinstance(r["share"], str) else f"{r['share']:.4f}"
        print(f"{r['row']:>3s} {r['kernel']:20s} {r['launches']:8d} {r['bytes']:11.4g} "
              f"{r['ops']:11.4g} {r['bound_ms']:9.5f} {r['bound_by']:10s} {ms:>12s} "
              f"{share:>12s}")
        for site in r["sites"]:
            site_ms = f", {site['ms']:.5f} ms" if "ms" in site else ""
            print(f"      {site['shape']}: bound {site['bound_ms']:.4g} ms{site_ms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
