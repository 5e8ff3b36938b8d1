"""Command-line flags of the training CLI (the port's copy of
``dfvod_tpu/cli/flags.py``): every flag with the JAX package's name,
``dest`` and default, so that a recipe's argument list
(``configs/training/*.sh``) parses the same, and ``config_from_args``,
which maps them onto the port's ``Config``. Flags whose feature waits for
a later slice parse, and the CLI (``cli/main.py``) refuses them with the
slice's name.
"""
from __future__ import annotations

import argparse

from dfvod_tpu_torch.utils.config import Config


def get_args_parser(video: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dfvod_tpu_torch", add_help=False)
    # optimizer / schedule (``main.py:33-60``)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=2e-5, type=float)
    p.add_argument("--lr_linear_proj_mult", default=0.1, type=float)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--weight_decay", default=2e-5, type=float)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--sgd", action="store_true")
    p.add_argument("--num_devices", default=0, type=int,
                   help="local devices to train on (0 = all), one "
                        "process each; clip-parallel serving in "
                        "cli.inference")
    # model (``main.py:62-118``)
    p.add_argument("--backbone", default="resnet50", type=str)
    p.add_argument("--dilation", action="store_true")
    p.add_argument("--position_embedding", default="sine", type=str)
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_queries", default=300, type=int)
    p.add_argument("--num_feature_levels", default=4, type=int)
    p.add_argument("--dec_n_points", default=4, type=int)
    p.add_argument("--enc_n_points", default=4, type=int)
    p.add_argument("--dpth_n_points", default=4, type=int)
    p.add_argument("--two_stage", action="store_true")
    p.add_argument("--masks", action="store_true",
                   help="train segmentation head (``main.py:110``)")
    p.add_argument("--frozen_weights", default="", type=str)
    p.add_argument("--with_box_refine", action="store_true")
    p.add_argument("--num_classes", default=3, type=int)
    # losses (``main.py:120-140``)
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--cls_loss_coef", default=2.0, type=float)
    p.add_argument("--bbox_loss_coef", default=5.0, type=float)
    p.add_argument("--giou_loss_coef", default=2.0, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)
    p.add_argument("--set_cost_class", default=2.0, type=float)
    p.add_argument("--set_cost_bbox", default=5.0, type=float)
    p.add_argument("--set_cost_giou", default=2.0, type=float)
    # depth fusion
    p.add_argument("--use_depth", action="store_true")
    p.add_argument("--fusion_type", default="Baseline",
                   choices=["Baseline", "LateFusion", "Backbone_CrossFusion",
                            "Encoder_CrossFusion"],
                   help="Backbone_CrossFusion implements the INTENDED "
                        "fusion semantics — the reference's released "
                        "graph never executes its fusion module (see "
                        "README 'Compatibility contract' + PARITY.md "
                        "defects #1/#2); reference checkpoints load but "
                        "their cf weights were trained dead")
    p.add_argument("--dformer_backbone", action="store_true",
                   help="DFormer depth backbone for LateFusion/Encoder_CF "
                        "(without it they fall back to the R18 research "
                        "backbone, ``deformable_detr_single.py:657-662``)")
    p.add_argument("--dformer_weights", default="", type=str,
                   help="DFormer pretrain .pth; implies --dformer_backbone "
                        "(``main.py:213-214``)")
    # dataset (``main.py:142-156``)
    p.add_argument("--dataset_file", default="vid_single", type=str)
    p.add_argument("--coco_path", default="", type=str)
    p.add_argument("--coco_panoptic_path", default="", type=str)
    p.add_argument("--output_dir", default="", type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--auto_resume", action="store_true",
                   help="if output_dir already holds a checkpoint, restore "
                        "the FULL train state (params + optimizer + epoch + "
                        "best-mAP metadata) and continue — the durability "
                        "hook the supervisor (scripts/supervise.py) relies "
                        "on after killing a hung run; goes beyond the "
                        "reference's weights-only --resume "
                        "(``main.py:522-540``)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--max_boxes", default=64, type=int)
    p.add_argument("--train_short_sides", default=None, type=int,
                   nargs="+",
                   help="multi-scale train resize short sides (reference "
                        "hard-codes 480..800, ``vid_single.py:148``)")
    p.add_argument("--eval_short_side", default=600, type=int,
                   help="eval resize short side (``vid_single.py:155``)")
    p.add_argument("--max_size", default=1333, type=int,
                   help="resize long-side cap (``vid_single.py:148``)")
    p.add_argument("--device_preprocess", action="store_true",
                   help="ship uint8 frames; normalize on device")
    p.add_argument("--pack_s2d", action="store_true",
                   help="pack 2x2 space-to-depth on host (uint8) so the "
                        "stems skip the on-device relayout; implies "
                        "--device_preprocess semantics on the batch")
    p.add_argument("--train_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: mixed-precision training (f32 master "
                        "params, the forward under bf16 autocast)")
    p.add_argument("--strong_aug", action="store_true",
                   help="photometric distortion + MinIoURandomCrop in "
                        "training (the reference's transforms_multi.py:"
                        "254-398 extras); for tiny training sets")
    p.add_argument("--eval_every", default=0, type=int,
                   help="COCO-eval every N epochs and keep the best-"
                        "mAP@0.5 checkpoint under output_dir/best "
                        "(reference evaluates every epoch, main.py:"
                        "587-600); 0 = end of run only")
    p.add_argument("--cache_mode", action="store_true",
                   help="cache the dataset's image files in RAM "
                        "(``main.py:158``)")
    p.add_argument("--num_workers", default=0, type=int,
                   help="loader worker threads for batch fetch/decode/"
                        "augment (``main.py:156``); 0 = single prefetch "
                        "thread")
    p.add_argument("--profile_dir", default="", type=str,
                   help="capture a torch.profiler trace of train steps "
                        "2-11 into this directory")
    p.add_argument("--remat", action="store_true",
                   help="recompute the encoder layers in the backward "
                        "(less memory, ~1 extra forward in backward)")
    p.add_argument("--del_class_weights", action="store_true")
    p.add_argument("--no_wandb", action="store_true", default=True)
    p.add_argument("--wandb", dest="no_wandb", action="store_false")
    # video (``main_multi.py:28-177``)
    if video:
        p.add_argument("--num_ref_frames", default=3, type=int)
        p.add_argument("--n_temporal_decoder_layers", default=1, type=int)
        p.add_argument("--fixed_pretrained_model", action="store_true")
        p.add_argument("--transvod_temporal_weights", default="", type=str)
        p.add_argument("--spatial_weights", default="", type=str)
    return p


def config_from_args(args, video: bool = False) -> Config:
    kw = dict(vars(args))
    if video:
        mode = ("transvod_pp" if "plusplus" in kw.get("dataset_file", "")
                else "transvod")
        kw["temporal_mode"] = mode
    if kw.get("fusion_type", "Baseline") != "Baseline":
        kw["use_depth"] = True
    # ``main.py:213-214``: --dformer_weights implies --dformer_backbone;
    # without either, LateFusion/Encoder_CF select the R18 research depth
    # backbone (``deformable_detr_single.py:657-662``). Backbone
    # CrossFusion is always DFormer-based (``:649-655``).
    if kw.pop("dformer_backbone", False) or kw.get("dformer_weights"):
        kw["depth_backbone_type"] = "dformer"
    elif kw.get("fusion_type") in ("LateFusion", "Encoder_CrossFusion"):
        kw["depth_backbone_type"] = "resnet18"
    return Config.from_flat(**kw)
