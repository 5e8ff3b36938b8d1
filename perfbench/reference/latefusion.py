"""The default plain reference: the LateFusion Deformable DETR and its
TransVOD++ head (``model.py``) with their train step (``train.py``).

A configuration file without a ``reference`` key is judged by this module.
It is the first implementation of the contract in
``perfbench/README.md``; it imports nothing of the port.
"""
from perfbench.reference.model import (  # noqa: F401
    PRIOR_PROB,
    WH_BIAS,
    MSDeformAttn,
    build,
    normalize,
    postprocess,
    ring_bias,
    roi_align,
)
from perfbench.reference.train import (  # noqa: F401
    DataParallelStep,
    TrainStep,
    first_moment_grads,
    group_label,
    leaf_gaps,
    leaf_norms,
)
