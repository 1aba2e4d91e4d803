"""Real-time serving: streaming (chunk-in / chunk-out) enhancement with a
fixed algorithmic latency (counterpart of speech_enhancement_tpu/serve)."""

from speech_enhancement_torch.serve.streaming import CRNStreamer, DCCRNStreamer

__all__ = ["CRNStreamer", "DCCRNStreamer"]
