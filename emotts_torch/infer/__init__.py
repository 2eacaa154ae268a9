from emotts_torch.infer.bucketize import bucketize, compute_intensity_prototypes
from emotts_torch.infer.server import TTSService, make_server
from emotts_torch.infer.synthesize import Synthesizer, pick_bucket, resolve_name

__all__ = ["Synthesizer", "TTSService", "bucketize",
           "compute_intensity_prototypes", "make_server", "pick_bucket",
           "resolve_name"]
