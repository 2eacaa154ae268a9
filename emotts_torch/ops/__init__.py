from emotts_torch.ops.attention import fused_attention, fused_attention_plain
from emotts_torch.ops.mrf import fused_mrf_stage, fused_mrf_stage_plain
from emotts_torch.ops.resblock import fused_resblock1, fused_resblock1_plain

__all__ = [
    "fused_attention",
    "fused_attention_plain",
    "fused_mrf_stage",
    "fused_mrf_stage_plain",
    "fused_resblock1",
    "fused_resblock1_plain",
]
