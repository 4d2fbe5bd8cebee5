"""Configuration for the port: a copy of the pieces of `stratanet2_tpu.config`
that the port's modules read, with the same defaults: ModelConfig,
TrainConfig, the DataConfig fields of the host data layer and of parcel
predict, and Config's mode with the DEV profile (`as_dev`,
`default_config(mode)`), and the CLIs' flag parser (`parse_config`).

The port keeps its own copy rather than importing the JAX package's module:
the port must import nothing of `stratanet2_tpu`.

The opt-ins of the JAX ModelConfig keep its defaults and names:
`ball_query_method` ("grouped" or "nearest"), `use_pallas` (with "grouped",
SA1 and SA2 take the fused route; `models/pointnet2.fused_eligible`) and
`compute_dtype` ("float32" or "bfloat16", the operands of the MLP matmuls;
`models/nn.Linear`). `knn_chunk` has no counterpart: no kernel of the port
tiles centroids or targets by it. `drop` is the head's dropout rate: 0.0 in
PROD, where the dropout is the identity; above 0 the train-mode forward
draws its masks from a `torch.Generator` the caller passes.
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

FEATURE_NAMES: Tuple[str, ...] = (
    "x",
    "y",
    "z_flat",
    "red",
    "green",
    "blue",
    "near_infrared",
    "intensity",
    "return_num",
    "num_returns",
)


BALL_QUERY_METHODS = ("grouped", "nearest")
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class ModelConfig:
    """PointNet2 architecture hyperparameters (reference model/point_net2.py:70-104)."""

    n_class: int = 4
    n_input_feats: int = len(FEATURE_NAMES)  # x,y dropped inside the model
    subsample_size: int = 10000
    diam_meters: int = 20
    diam_pix: int = 20
    drop: float = 0.0
    ratio1: float = 0.25
    r1: float = math.sqrt(2.0)
    ratio2: float = 0.25
    r2: float = math.sqrt(8.0)
    z_max: float = 24.24
    # head bias init (model/point_net2.py:97-99)
    head_bias_init: Tuple[float, ...] = (0.733, 0.266, 0.235, 0.358, 0.500)
    # fixed-K padded neighbourhoods: k groups of ceil(N/k) points per
    # centroid (grouped ball query)
    k1: int = 32
    k2: int = 64
    # partitioned FPS (ops/fps.py): applied only when each of the parts
    # selects at least fps_min_part_samples points
    fps_parts: int = 2
    fps_min_part_samples: int = 256
    # "grouped": the nearest in-radius point of each of k groups of ceil(N/k)
    # consecutive points; "nearest": the k nearest in-radius points, exact
    # float32, ties to the lowest index (ops/ballquery.py)
    ball_query_method: str = "grouped"
    use_pallas: bool = True  # the fused SA route, where the selection is "grouped"
    compute_dtype: str = "float32"  # the MLP matmuls' operands: "float32" or "bfloat16"

    def __post_init__(self):
        if self.ball_query_method not in BALL_QUERY_METHODS:
            raise ValueError(f"ball_query_method must be one of {BALL_QUERY_METHODS}, "
                             f"not {self.ball_query_method!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"not {self.compute_dtype!r}")

    @property
    def n_centroids1(self) -> int:
        return int(self.subsample_size * self.ratio1)

    @property
    def n_centroids2(self) -> int:
        return int(self.n_centroids1 * self.ratio2)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference config.py:83-97)."""

    folds: int = 5
    wd: float = 1e-3  # coupled L2 (torch Adam weight_decay)
    batch_size: int = 20
    n_epoch: int = 300
    n_epoch_test: int = 10
    epoch_to_start_early_stop: int = 250
    use_early_stopping: bool = False
    patience_in_epochs: int = 30
    lr: float = 1e-3
    step_size: int = 1  # epochs between LR decays (staircase)
    lr_decay: float = 0.985
    m: float = 0.10  # NLL loss weight (config.py:70)
    e: float = 0.2 / 5  # entropy loss weight (config.py:71)
    seed: int = 42


@dataclass(frozen=True)
class DataConfig:
    """Host data-pipeline parameters (reference utils/load_data.py,
    data_loader/loader.py): the fields that `data/` and `inference/` read."""

    data_path: str = "data"
    las_plots_folder_path: str = "data/placettes_dataset/las_classes"
    plots_pickled_dataset_path: str = "data/placettes_dataset/prepared/plots_dataset.pkl"
    gt_file_path: str = "data/placettes_dataset/placettes_metadata.csv"
    corrected_gt_file_path: str = (
        "data/placettes_dataset_correction/placettes_metadata_correction.csv"
    )
    las_parcels_folder_path: str = "data/parcelles_dataset_20m"
    parcel_shapefile_path: str = "data/parcelles_dataset_20m/input/parcels.shp"
    znorm_radius_in_meters: float = 1.5
    min_points_per_plot: int = 50  # parcel tiling keeps plots with at least this many
    min_points_for_pseudo_labelling: int = 2000  # and pseudo-labels those with more
    prefetch_batches: int = 2
    loader_workers: int = 2
    # dtype of the cloud/xyz batches the loader hands over: "float32"
    # (exact) or "float16" (half the bytes to the card; the features are
    # [0, 1]-rescaled and xyz spans +-10 m, so ~1e-3 relative)
    transfer_dtype: str = "float32"
    # upload a fold's plots to the card once and draw each batch's
    # augmentation and subsample there (data/device_dataset.py): "auto"
    # does so when the estimated footprint of the train and val plots is
    # under device_resident_max_bytes (`learning/train.use_device_resident`),
    # "true" / "false" force it
    device_resident: str = "auto"
    device_resident_max_bytes: int = 2_000_000_000
    # parcel predict (inference/predict.py): batches whose outputs stay on
    # the device and are read with one copy; the result is the same for any
    # value, 1 reads each batch alone. The last chain may be shorter.
    predict_chain: int = 8
    # also write each plot's GeoTIFF beside the merged parcel tif (the
    # merge itself takes the tiles from memory)
    keep_plot_tiffs: bool = False


@dataclass(frozen=True)
class Config:
    mode: str = "PROD"  # DEV shrinks everything for smoke tests (config.py:5-12)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    experiments_path: str = "experiments"
    plot_geotiff_file: bool = False
    log_embeddings: bool = False
    normalize_cm: str = "true"
    log_confusion_matrix_frequency: int = 10
    # plots kept in the DEV subset (data/dataset.py) and drawn at every eval
    plot_name_to_visualize_during_training: Tuple[str, ...] = (
        "Releve_Lidar_F68",
        "2021_POINT_OBS66",
        "2021_POINT_OBS7",
        "POINT_OBS106",
    )

    def as_dev(self) -> "Config":
        """DEV profile: 2 epochs, eval every epoch (reference config.py:88-92)."""
        return replace(
            self,
            mode="DEV",
            train=replace(
                self.train,
                n_epoch=2,
                n_epoch_test=1,
                epoch_to_start_early_stop=1,
                patience_in_epochs=1,
            ),
            log_confusion_matrix_frequency=1,
        )


def default_config(mode: str = "PROD") -> Config:
    cfg = Config()
    if mode.upper() == "DEV":
        cfg = cfg.as_dev()
    return cfg


def _add_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", default="PROD", type=str, help="DEV or PROD")
    p.add_argument("--n_epoch", type=int)
    p.add_argument("--n_epoch_test", type=int)
    p.add_argument("--epoch_to_start_early_stop", type=int)
    p.add_argument("--patience_in_epochs", type=int)
    p.add_argument("--use_early_stopping", action="store_true", default=None)
    p.add_argument("--lr", type=float)
    p.add_argument("--lr_decay", type=float)
    p.add_argument("--step_size", type=int)
    p.add_argument("--wd", type=float)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--folds", type=int)
    p.add_argument("--m", type=float)
    p.add_argument("--e", type=float)
    p.add_argument("--subsample_size", type=int)
    p.add_argument("--diam_pix", type=int)
    p.add_argument("--diam_meters", type=int)
    p.add_argument("--data_path", type=str)
    p.add_argument("--las_plots_folder_path", type=str)
    p.add_argument("--gt_file_path", type=str)
    p.add_argument("--corrected_gt_file_path", type=str)
    p.add_argument("--las_parcels_folder_path", type=str)
    p.add_argument("--parcel_shapefile_path", type=str)
    p.add_argument("--plots_pickled_dataset_path", type=str)
    p.add_argument("--experiments_path", type=str)
    p.add_argument("--PT_model_id", type=str, default="")
    p.add_argument("--inference_model_id", type=str, default="")
    p.add_argument("--plot_geotiff_file", action="store_true", default=None)
    p.add_argument("--log_embeddings", action="store_true", default=None)
    p.add_argument("--use_pallas", type=lambda s: s.lower() in ("1", "true"), default=None)
    p.add_argument("--transfer_dtype", choices=["float32", "float16"])
    p.add_argument(
        "--device_resident",
        choices=["auto", "true", "false"],
        default=None,
    )
    p.add_argument("--predict_chain", type=int, default=None)
    p.add_argument(
        "--keep_plot_tiffs", action="store_const", const=True, default=None
    )
    p.add_argument("--min_points_for_pseudo_labelling", type=int, default=None)
    p.add_argument("--point_sharded", action="store_true")
    # namespace-only: the device the CLIs run on (`device.resolve_device`;
    # a bare "cuda" is cuda:LOCAL_RANK in a group of several ranks) and the
    # backend of that group (`parallel/multihost.initialize`)
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:<index> or cpu")
    p.add_argument("--dist_backend", choices=["gloo", "nccl"], default=None,
                   help="torch.distributed backend when launched as several ranks: nccl "
                        "for ranks on distinct cards, gloo for the CPU or a shared card")


def parse_config(argv: Optional[list] = None) -> Tuple[Config, argparse.Namespace]:
    """Build a Config from CLI flags, mirroring the reference's two-stage parse
    (config.py:5-12): --mode first selects the profile, then overrides apply."""
    p = argparse.ArgumentParser(description="stratanet2_tpu_torch")
    _add_flags(p)
    ns, _ = p.parse_known_args(argv)
    cfg = default_config(ns.mode)

    def _ov(dc, names):
        kw = {n: getattr(ns, n) for n in names if getattr(ns, n) is not None}
        return replace(dc, **kw) if kw else dc

    cfg = replace(
        cfg,
        model=_ov(cfg.model, ["subsample_size", "diam_pix", "diam_meters", "use_pallas"]),
        train=_ov(
            cfg.train,
            [
                "folds", "wd", "batch_size", "n_epoch", "n_epoch_test",
                "epoch_to_start_early_stop", "use_early_stopping",
                "patience_in_epochs", "lr", "step_size", "lr_decay", "m", "e",
            ],
        ),
        data=_ov(
            cfg.data,
            [
                "data_path", "las_plots_folder_path", "gt_file_path",
                "corrected_gt_file_path", "las_parcels_folder_path",
                "parcel_shapefile_path", "plots_pickled_dataset_path",
                "transfer_dtype", "device_resident", "predict_chain",
                "keep_plot_tiffs", "min_points_for_pseudo_labelling",
            ],
        ),
    )
    if ns.experiments_path:
        cfg = replace(cfg, experiments_path=ns.experiments_path)
    if ns.plot_geotiff_file is not None:
        cfg = replace(cfg, plot_geotiff_file=ns.plot_geotiff_file)
    if ns.log_embeddings is not None:
        cfg = replace(cfg, log_embeddings=ns.log_embeddings)
    return cfg, ns
