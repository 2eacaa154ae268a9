from emotts_torch.infer.server import TTSService, make_server
from emotts_torch.infer.synthesize import Synthesizer, pick_bucket, resolve_name

__all__ = ["Synthesizer", "TTSService", "make_server", "pick_bucket",
           "resolve_name"]
