"""The constants of the rig DAG, of tracking and of training — the part of
morig_tpu/core/config.py's `Config` tree that `RigPredictor`, the
trackers and the training stages read, with the same names and defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    corr_output_feature: int = 64      # CorrNet embedding width
    tau_nce: float = 0.07              # CorrNet's initial infoNCE temperature
    num_interp: int = 5                # DeformNet's voting and completion neighbours
    num_keyframes: int = 5             # keyframe flows per rig/skin sample
    motion_dim: int = 32               # per-keyframe motion embedding width
    aggr_method: str = "attn"          # temporal aggregation: attn, mean or max
    nearest_bone: int = 5              # bones per vertex in the skin descriptor
    use_Dg: bool = False               # skin descriptor carries 1/distance per bone
    use_Lf: bool = False               # skin descriptor carries isleaf per bone


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and schedule defaults of the training stages."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    schedule: Sequence[int] = (200,)   # MultiStepLR milestones, in epochs
    gamma: float = 0.1
    vis_branch_start_epoch: int = 100  # CorrPoseStage trains the vismask head from here


@dataclasses.dataclass(frozen=True)
class JointExtractConfig:
    bandwidth_quantile: float = 0.04
    attn_threshold: float = 0.1
    density_threshold: float = 0.02
    attn_nms_threshold: float = 0.7
    meanshift_max_iter: int = 30
    bandwidth_sample_rows: int = 1024  # strided row sample of the bandwidth estimate


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking and IK constants."""

    ik_iters_stage1: int = 200
    ik_iters_stage2: int = 400
    ik_lr_stage1: float = 5e-2
    ik_lr_stage2: float = 1e-3
    ik_weight_decay: float = 1e-4
    vismask_threshold: float = 0.3
    corr_sim_threshold: float = 0.5    # correspondence gate: embedding similarity
    corr_l2_threshold: float = 1e-2    # and squared distance to the posed vertex


@dataclasses.dataclass(frozen=True)
class SkinPostConfig:
    prune_ratio_rig: float = 0.35
    post_filter_rings: int = 1
    # volumetric skin distances (geometry/geodesic.py): strided min-plus
    # anchors, line-of-sight samples per ray, rays per vertex (its nearest
    # bones) once the padded bone axis is wider than that
    geo_anchors: int = 512
    geo_los_samples: int = 16
    geo_candidates: int = 10


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    joints: JointExtractConfig = dataclasses.field(default_factory=JointExtractConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    skin_post: SkinPostConfig = dataclasses.field(default_factory=SkinPostConfig)


DEFAULT_CONFIG = Config()
