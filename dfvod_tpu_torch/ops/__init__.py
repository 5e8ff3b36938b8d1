from dfvod_tpu_torch.ops.msda import (  # noqa: F401
    ms_deform_attn,
    ms_deform_attn_plain,
)
