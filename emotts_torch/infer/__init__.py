from emotts_torch.infer.bucketize import bucketize, compute_intensity_prototypes
from emotts_torch.infer.server import TTSService, make_server
from emotts_torch.infer.streaming import (generator_halo_frames, stream_text,
                                          vocode_streaming)
from emotts_torch.infer.synthesize import (Synthesizer, load_synthesizer,
                                           maybe_load_vocoder, pick_bucket,
                                           resolve_name)

__all__ = ["Synthesizer", "TTSService", "bucketize",
           "compute_intensity_prototypes", "generator_halo_frames",
           "load_synthesizer", "make_server", "maybe_load_vocoder",
           "pick_bucket", "resolve_name", "stream_text", "vocode_streaming"]
