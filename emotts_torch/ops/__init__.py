from emotts_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd_plain,
    fused_attention_plain,
    philox_keep_mask,
)
from emotts_torch.ops.mrf import fused_mrf_stage, fused_mrf_stage_plain
from emotts_torch.ops.resblock import fused_resblock1, fused_resblock1_plain

__all__ = [
    "fused_attention",
    "fused_attention_bwd_plain",
    "fused_attention_plain",
    "philox_keep_mask",
    "fused_mrf_stage",
    "fused_mrf_stage_plain",
    "fused_resblock1",
    "fused_resblock1_plain",
]
