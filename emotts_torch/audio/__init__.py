from emotts_torch.audio.wavio import write_wav

__all__ = ["write_wav"]
