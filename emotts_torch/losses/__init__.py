from emotts_torch.losses.fs2 import fs2_loss, ssim_loss
from emotts_torch.losses.gan import (discriminator_loss, feature_matching_loss,
                                     generator_adversarial_loss, mel_l1_loss)
from emotts_torch.losses.rank import rank_loss

__all__ = ["discriminator_loss", "feature_matching_loss", "fs2_loss",
           "generator_adversarial_loss", "mel_l1_loss", "rank_loss", "ssim_loss"]
