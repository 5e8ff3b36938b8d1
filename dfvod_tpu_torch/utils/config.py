"""Model and run configuration: the port's own copy of the ``ModelConfig``
and ``Config`` dataclasses of ``dfvod_tpu/utils/config.py``.

The dataclasses take every value the JAX package takes, so one
configuration describes both. What this slice of the port can build is
narrower: ``check_supported`` raises ``NotImplementedError`` for the rest and
names the slice it waits for.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

FUSION_TYPES = ("Baseline", "LateFusion", "Backbone_CrossFusion",
                "Encoder_CrossFusion")
TEMPORAL_MODES = ("none", "transvod", "transvod_pp")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model architecture configuration (reference defaults from
    ``configs/training/*.sh`` + ``main.py:31-194``)."""
    num_classes: int = 3
    num_queries: int = 300
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    dropout: float = 0.1
    num_feature_levels: int = 1
    dec_n_points: int = 4
    enc_n_points: int = 4
    dpth_n_points: int = 4
    backbone: str = "resnet50"
    depth_backbone_type: str = "dformer"  # dformer | resnet18
    dformer_weights: str = ""
    dilation: bool = True
    position_embedding: str = "sine"
    with_box_refine: bool = True
    two_stage: bool = False
    aux_loss: bool = True
    use_depth: bool = False
    fusion_type: str = "Baseline"
    # temporal (video) head
    temporal_mode: str = "none"         # none | transvod | transvod_pp
    num_ref_frames: int = 3
    n_temporal_decoder_layers: int = 1
    use_tdam: bool = False
    interval1: int = 20
    interval2: int = 60
    fixed_pretrained_model: bool = False
    # segmentation head
    masks: bool = False
    frozen_weights: str = ""
    # compute. In the JAX package 'bfloat16' runs bf16 matmul passes on f32
    # parameters. The port's precision is the dtype its parameters are cast
    # to (``serve.Server(dtype=...)``); an f32 model runs f32 matmuls.
    compute_dtype: str = "float32"      # float32 | bfloat16
    remat: bool = False                 # activation recompute (training)

    def __post_init__(self):
        if self.fusion_type not in FUSION_TYPES:
            raise ValueError(f"fusion_type {self.fusion_type!r} not in "
                             f"{FUSION_TYPES}")
        if self.temporal_mode not in TEMPORAL_MODES:
            raise ValueError(f"temporal_mode {self.temporal_mode!r} not in "
                             f"{TEMPORAL_MODES}")
        if self.fusion_type != "Baseline":
            object.__setattr__(self, "use_depth", True)

    @property
    def transformer_fusion(self) -> str:
        return {"Baseline": "none", "LateFusion": "late",
                "Backbone_CrossFusion": "none",
                "Encoder_CrossFusion": "encoder_cf"}[self.fusion_type]

    @property
    def backbone_stages(self) -> Tuple[int, ...]:
        # layer2/3/4 for multi-level, layer4 only otherwise
        return (2, 3, 4) if self.num_feature_levels > 1 else (4,)


@dataclasses.dataclass(frozen=True)
class Config:
    """The run configuration. This slice has the model part only; the
    loss, train and data parts of the JAX ``Config`` come with the training
    slice."""
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)


def check_supported(m: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice cannot build,
    naming the slice it waits for."""
    waits = []
    if m.fusion_type not in ("Baseline", "LateFusion"):
        waits.append(f"fusion_type={m.fusion_type!r} waits for the "
                     "other-fusion-modes slice")
    if m.temporal_mode != "none":
        waits.append(f"temporal_mode={m.temporal_mode!r} waits for the "
                     "TransVOD/TransVOD++ slice")
    if m.two_stage:
        waits.append("two_stage=True waits for the other-fusion-modes "
                     "slice (two-stage proposals)")
    if m.masks:
        waits.append("masks=True waits for the segmentation slice")
    if m.num_feature_levels != 1:
        waits.append(f"num_feature_levels={m.num_feature_levels} waits for "
                     "the multi-level slice")
    if m.backbone != "resnet50":
        waits.append(f"backbone={m.backbone!r}: only resnet50 exists")
    if m.use_depth and m.depth_backbone_type != "dformer":
        waits.append(f"depth_backbone_type={m.depth_backbone_type!r} "
                     "waits for the research-modules slice")
    if m.position_embedding != "sine":
        waits.append(f"position_embedding={m.position_embedding!r}: only "
                     "sine is wired in the model")
    if waits:
        raise NotImplementedError("; ".join(waits))
