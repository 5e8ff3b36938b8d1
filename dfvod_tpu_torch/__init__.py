"""dfvod_tpu_torch — the PyTorch/CUDA port of ``dfvod_tpu`` for NVIDIA
Hopper (H100).

It mirrors the JAX package's module layout and names
(``dfvod_tpu_torch/models/transformer.py`` is the counterpart of
``dfvod_tpu/models/transformer.py``) and keeps its public layouts:
channels-last images ``(B, H, W, C)``, tokens ``(B, S, C)`` and MSDA values
``(B, S, M, D)``. It imports neither JAX nor anything of ``dfvod_tpu``.

Layout
------
- ``ops``      : MSDA (plain PyTorch forward and backward + hand-written
                 CUDA kernels in ``csrc/``, joined as an autograd
                 Function), the bilinear sampling under RoIAlign (plain
                 version + CUDA kernel) and RoIAlign, and the kernel build.
- ``models``   : backbones, transformer trunk, LateFusion adapter, heads,
                 the TransVOD / TransVOD++ temporal heads, postprocess,
                 matcher, criterion.
- ``train``    : the grouped optimizer, the train step and the COCO
                 evaluation loop.
- ``data``     : the JPEG decoder and resize (host C++ in ``csrc/*.cpp``),
                 the RGB-D COCO datasets, transforms and loader, on-device
                 uint8 normalization, the COCO / CocoVID index and the bbox
                 mAP evaluator.
- ``cli``      : the training CLI (``python -m dfvod_tpu_torch.cli.main``
                 / ``cli.main_multi``) with the JAX CLI's flags.
- ``utils``    : box ops, config, weight conversion from the JAX package,
                 checkpoints (key surgery, save and resume, the ResNet-50
                 and DFormer converters), the reference-checkpoint
                 converter, device choice, metric logging.
- ``serve``    : the serving entry point (single frames or clips).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
