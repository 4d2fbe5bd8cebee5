"""Theoretical quantification-error study (copy of
`stratanet2_tpu/metascripts/quantification_errors.py`, reference
metascripts/quantification_errors.py): the error induced by discretizing
continuous vegetation coverage onto the 8-class grid, under a Gaussian
measurement-uncertainty hypothesis.

Three analyses, mirrored from the reference and vectorized:
1. quantification error under a uniform coverage distribution, overall and
   per class, plus the realized error on a result file's GT distribution
   (:70-126);
2. P(|e| > t) tables for several measurement-error stdevs (:129-156);
3. expected MAE / MAE2 / acc / acc2 under Gaussian measurement error via
   numerical integration over the imprecision distribution (:158-243).

All values in percent, like the reference. pandas and scipy are imported
inside the functions. `main` always asks for the figure of analysis 1; where
matplotlib is missing the figure is skipped with a warning and the tables
are still written (JAX's `main` stops there with an ImportError).
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser
from typing import TYPE_CHECKING, Callable, Dict

import numpy as np

# percent-scale class system (quantification_errors.py:33-46) — derived
# from the single 0-1-scale definition in learning/metrics.py so the class
# grid and its half-up border rounding cannot drift between the two
from stratanet2_tpu_torch.learning import metrics as _M

if TYPE_CHECKING:
    import pandas as pd

logger = logging.getLogger("stratanet2_tpu_torch")

bins_centers = np.round(_M.bins_centers * 100).astype(int)
bins_borders = np.round(_M.bins_borders * 100).astype(int)
center_to_border = {
    int(c): (int(round(lo * 100)), int(round(hi * 100)))
    for c, lo, hi in zip(bins_centers, _M.CLASS_LOWER, _M.CLASS_UPPER)
}


def _closest_center_idx(y: float) -> int:
    return int(np.argmin(np.abs(bins_centers - y)))


# percent-scale wrappers over the single 0-1-scale indicator definitions in
# learning/metrics.py (one source of truth for the inclusive-border logic)
def mae_pc(y_pred: float, y: float) -> float:
    return abs(y_pred - y)


def mae2_pc(y_pred: float, y: float) -> float:
    return float(_M.mae2(y_pred / 100.0, y / 100.0)) * 100.0


def acc_pc(y_pred: float, y: float) -> float:
    return float(_M.accuracy(y_pred / 100.0, y / 100.0))


def acc2_pc(y_pred: float, y: float, margin: float = 10.0) -> float:
    return float(_M.accuracy2(y_pred / 100.0, y / 100.0, margin=margin / 100.0))


ERROR_FUNCS: Dict[str, Callable] = {
    "mae": mae_pc, "acc": acc_pc, "mae2": mae2_pc, "acc2": acc2_pc
}


def study_quantification_error_1(df: "pd.DataFrame" = None, output_fig_path: str = ""):
    """Uniform-distribution quantification error + per-class breakdown
    (:70-126). Returns {class_center: mean_error}."""
    x = np.linspace(0, 100, 2001)
    y_classes = np.digitize(x, bins_borders)
    y_quant = bins_centers[y_classes]
    error = np.abs(x - y_quant)
    print(f"Quantification error #1 = {error.mean().round(2)}%")

    errors_by_class = np.array(
        [error[y_classes == i].mean() for i in range(len(bins_centers))]
    ).round(2)
    mapper = dict(zip(bins_centers.tolist(), errors_by_class.tolist()))
    print(list(zip(bins_centers, errors_by_class)))

    if df is not None:
        g = df[["vt_veg_b", "vt_veg_moy", "vt_veg_h"]].astype(float).copy()
        if g.values.max() <= 1:
            g *= 100
        vals = g.values.ravel()
        rounded = np.round(vals)
        on_grid = np.isin(rounded, bins_centers)
        if on_grid.all():
            # GTs are class centers: report each class's expected error
            # under the uniform hypothesis (the reference's computation)
            realized = np.array([mapper[int(v)] for v in rounded]).mean()
            print(f"Actual error due to quantization: {realized}")
        else:
            # continuous GTs (predictions_analysis supports these): the
            # center-keyed mapper does not apply — report the direct
            # per-value quantization error instead of silently averaging
            # raw unmapped percentages
            quant = bins_centers[np.digitize(vals, bins_borders)]
            realized = np.abs(vals - quant).mean()
            print(
                f"Actual error due to quantization: {realized.round(2)} "
                f"({(~on_grid).sum()}/{vals.size} GT values are continuous; "
                "computed as |gt - quantized(gt)|)"
            )

    if output_fig_path:
        try:
            import matplotlib
        except ImportError as err:
            logger.warning("quantification figure %s skipped: %s", output_fig_path, err)
            return mapper

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.title("Quantification error depends on the coverage value")
        plt.plot(x, y_quant, label="coverage (discretized, %)")
        plt.plot(x, x, label="coverage (continuous, %)")
        plt.plot(x, error, label="quantification error (pp)")
        plt.xlabel("coverage (%)")
        plt.legend()
        plt.tight_layout()
        os.makedirs(os.path.dirname(output_fig_path) or ".", exist_ok=True)
        plt.savefig(output_fig_path, dpi=150, transparent=True)
        plt.close()
    return mapper


def describe_possible_measurement_error_distribution(
    stdev_list=(1e-7, 5, 10, 12.5, 15, 20),
    above_list=(2.5, 5, 7.5, 10, 12.5, 15, 20, 25, 30, 50),
    out_path: str = "",
) -> "pd.DataFrame":
    """P(|e| > t) table over stdevs (:129-156)."""
    import pandas as pd
    from scipy.stats import norm

    rows = np.empty((len(above_list), len(stdev_list)))
    for j, s in enumerate(stdev_list):
        dist = norm(0, s)
        for i, t in enumerate(above_list):
            rows[i, j] = 1 - (dist.cdf(t) - dist.cdf(-t))
    df = pd.DataFrame(
        rows,
        index=[f"|e|>{t}" for t in above_list],
        columns=[f"sigma={s:.1f}" for s in stdev_list],
    ).round(2)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        df.to_csv(out_path)
    return df


def expected_error_under_measurement_noise(
    stdev: float = 10.0, error_func: Callable = mae_pc
) -> float:
    """Expected indicator under Gaussian measurement error, integrating over
    true coverages per class and imprecision values (:158-217). The assigned
    GT label is the class of the (clipped) noisy measurement."""
    from scipy.stats import norm

    dist = norm(0, stdev)
    deltas = np.arange(-50, 50, 0.05)
    w = dist.pdf(deltas)
    W = w.sum()
    all_errors = []
    for center, (lo, hi) in center_to_border.items():
        for real in np.arange(lo, hi + 0.1, 0.25):
            measured = np.clip(real + deltas, 0, 100)
            inside = (lo <= measured) & (measured <= hi)
            # label assigned when the noisy measurement leaves the class:
            # the *second*-closest center to the measurement (:200-207).
            # error_func only sees the 8 possible centers — evaluate it
            # once per center and gather, instead of per delta
            second = np.argsort(
                np.abs(bins_centers[None, :] - measured[:, None]), axis=1
            )[:, 1]
            err_by_center = np.array(
                [error_func(real, int(c)) for c in bins_centers]
            )
            err = np.where(
                inside, error_func(real, center), err_by_center[second]
            )
            all_errors.append(float((w * err).sum() / W))
    return float(np.round(np.mean(all_errors), 2))


def all_expected_errors(
    stdev_list=(1e-7, 5, 10, 12.5, 15, 20), out_path: str = ""
) -> "pd.DataFrame":
    """(:220-243)"""
    import pandas as pd

    rows = {
        name: [
            expected_error_under_measurement_noise(s, fn) for s in stdev_list
        ]
        for name, fn in ERROR_FUNCS.items()
    }
    df = pd.DataFrame(
        rows, index=[f"sigma={s:.1f}" for s in stdev_list]
    ).T.round(2)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        df.to_csv(out_path)
    return df


def main(argv=None):
    p = ArgumentParser(description="quantification_errors")
    p.add_argument("--results_file", default="")
    p.add_argument("--out_dir", default="experiments/analyses")
    ns, _ = p.parse_known_args(argv)
    import pandas as pd

    df = pd.read_csv(ns.results_file) if ns.results_file else None
    study_quantification_error_1(
        df, os.path.join(ns.out_dir, "quantification_error_1.png")
    )
    describe_possible_measurement_error_distribution(
        out_path=os.path.join(ns.out_dir, "msrt_error_description.csv")
    )
    all_expected_errors(
        out_path=os.path.join(ns.out_dir, "expected_errors_under_gaussian_msrt_error.csv")
    )


if __name__ == "__main__":
    main()
