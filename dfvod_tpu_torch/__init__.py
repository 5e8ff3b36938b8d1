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
                 Function) and the kernel build.
- ``models``   : backbones, transformer trunk, LateFusion adapter, heads,
                 postprocess, matcher, criterion.
- ``train``    : the grouped optimizer and the train step.
- ``data``     : on-device uint8 normalization.
- ``utils``    : box ops, config, weight conversion from the JAX package,
                 device choice.
- ``serve``    : the serving entry point.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
