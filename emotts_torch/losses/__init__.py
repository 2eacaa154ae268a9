from emotts_torch.losses.rank import rank_loss

__all__ = ["rank_loss"]
