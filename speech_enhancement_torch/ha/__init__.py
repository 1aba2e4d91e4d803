"""Hearing-aid processing chain (Clarity challenge): NAL-R EQ + compressor
(counterpart of speech_enhancement_tpu/ha). Scoring is ``ha.scoring``."""

from speech_enhancement_torch.ha.amplifier import NALR  # noqa: F401
from speech_enhancement_torch.ha.audio import amplify, convert_audio_channels  # noqa: F401
from speech_enhancement_torch.ha.compressor import Compressor  # noqa: F401
