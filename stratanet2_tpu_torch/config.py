"""Configuration for the port: a copy of the pieces of `stratanet2_tpu.config`
that the serve and train steps read (ModelConfig and the optimisation
fields of TrainConfig), with the same defaults.

The port keeps its own copy rather than importing the JAX package's module:
the port must import nothing of `stratanet2_tpu`.

Fields of the JAX ModelConfig that select between TPU paths
(`use_pallas`, `ball_query_method`, `compute_dtype`, `knn_chunk`) have no
counterpart: the port has one path per device, the grouped ball query, and
float32 compute. `drop` has none either: PROD trains with drop=0.0, where
the JAX head's dropout is the identity, so the port's train step takes no
random generator (dropout for drop > 0 is not ported yet).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

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


@dataclass(frozen=True)
class ModelConfig:
    """PointNet2 architecture hyperparameters (reference model/point_net2.py:70-104)."""

    n_class: int = 4
    n_input_feats: int = len(FEATURE_NAMES)  # x,y dropped inside the model
    subsample_size: int = 10000
    diam_meters: int = 20
    diam_pix: int = 20
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

    @property
    def n_centroids1(self) -> int:
        return int(self.subsample_size * self.ratio1)

    @property
    def n_centroids2(self) -> int:
        return int(self.n_centroids1 * self.ratio2)


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX TrainConfig that the serve and train steps and
    the optimizer read (reference config.py:83-97)."""

    batch_size: int = 20
    lr: float = 1e-3
    wd: float = 1e-3  # coupled L2 (torch Adam weight_decay)
    lr_decay: float = 0.985  # staircase, every `step_size` epochs
    step_size: int = 1
    m: float = 0.10  # NLL loss weight (config.py:70)
    e: float = 0.2 / 5  # entropy loss weight (config.py:71)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def default_config() -> Config:
    return Config()
