"""Model and run configuration: the port's own copy of the ``ModelConfig``,
``LossConfig``, ``TrainConfig``, ``DataConfig`` and ``Config`` dataclasses
of ``dfvod_tpu/utils/config.py``.

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
        if self.masks and self.fusion_type == "Backbone_CrossFusion":
            raise ValueError("the mask head needs the raw backbone stage "
                             "outputs, which Backbone_CrossFusion fuses")

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
class LossConfig:
    """Criterion weights (reference ``main.py`` loss coef flags)."""
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    mask_loss_coef: float = 1.0
    dice_loss_coef: float = 1.0
    focal_alpha: float = 0.25
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule config (``main.py:311-435``). ``batch_size``,
    ``num_devices``, ``profile_dir`` and ``eval_every`` are read by the CLI
    (``cli/main.py``), not by the train step, which takes the batch it is
    given, on one device."""
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    lr_linear_proj_mult: float = 0.1
    weight_decay: float = 2e-5
    clip_max_norm: float = 0.1
    epochs: int = 20
    batch_size: int = 4
    seed: int = 42
    sgd: bool = False
    cosine_eta_min_mult: float = 0.1    # CosineAnnealingLR eta_min = 0.1*lr
    num_devices: int = 0
    # 'bfloat16': mixed-precision training. In the port: autocast to bf16
    # around the forward, f32 master parameters and optimizer state
    train_dtype: str = "float32"
    profile_dir: str = ""
    eval_every: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset config (``datasets/vid_single.py`` / ``vid_multi.py``)."""
    coco_path: str = ""
    coco_panoptic_path: str = ""
    dataset_file: str = "vid_single"
    use_depth: bool = False
    num_ref_frames: int = 3
    max_boxes: int = 64                  # static padding for targets
    train_short_sides: Tuple[int, ...] = (480, 512, 544, 576, 608, 640,
                                          672, 704, 736, 768, 800)
    max_size: int = 1333
    eval_short_side: int = 600
    rgb_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    rgb_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    depth_mean: float = 0.48
    depth_std: float = 0.28
    device_preprocess: bool = False
    pack_s2d: bool = False
    cache_mode: bool = False
    num_workers: int = 0
    strong_aug: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    """The run configuration. The data part is read by the datasets,
    transforms and loader (``data/dataset.py``, ``data/loader.py``) that
    the CLI builds; the loader ships uint8 frames and the train step
    normalizes them on the device, whether or not ``device_preprocess``
    is set."""
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    output_dir: str = ""

    def __post_init__(self):
        # a depth-fusion model forces the data pipeline's use_depth
        if self.model.use_depth and not self.data.use_depth:
            object.__setattr__(self, "data", dataclasses.replace(
                self.data, use_depth=True))
        if self.model.temporal_mode != "none" and \
                self.data.num_ref_frames != self.model.num_ref_frames:
            object.__setattr__(self, "data", dataclasses.replace(
                self.data, num_ref_frames=self.model.num_ref_frames))

    @staticmethod
    def from_flat(**kw) -> "Config":
        """Build from flat argparse-style keywords."""
        def pick(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return {k: v for k, v in kw.items() if k in names and
                    v is not None}
        return Config(
            model=ModelConfig(**pick(ModelConfig)),
            loss=LossConfig(**pick(LossConfig)),
            train=TrainConfig(**pick(TrainConfig)),
            data=DataConfig(**pick(DataConfig)),
            output_dir=kw.get("output_dir", "") or "",
        )


def check_supported(m: ModelConfig, training: bool = False) -> None:
    """Raise ``NotImplementedError`` for what this slice cannot build (or,
    with ``training``, train), naming the slice it waits for. Every
    configuration that serves also trains (``remat`` recomputes only
    training activations)."""
    waits = []
    if m.two_stage:
        waits.append("two_stage=True waits for the two-stage proposals "
                     "slice (ROADMAP.md Queue 1 item 12b)")
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
