from emotts_torch.losses.fs2 import fs2_loss, ssim_loss
from emotts_torch.losses.rank import rank_loss

__all__ = ["fs2_loss", "rank_loss", "ssim_loss"]
