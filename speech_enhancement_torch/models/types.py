"""Model capability declaration (counterpart of speech_enhancement_tpu/models/types.py).

Every model declares a ``SignalSpec`` and the engine dispatches on it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """What a model consumes and produces.

    domain: "stft" (input [B, C, F, T, 2]) or "wav" (input [B, C, T]).
    multi_speaker: output carries a speaker axis [B, S, C, ...].
    monarch: monaural model; the engine squeezes a singleton speaker axis
             of the output.
    """

    domain: str = "wav"
    multi_speaker: bool = False
    monarch: bool = True

    def __post_init__(self):
        if self.domain not in ("stft", "wav"):
            raise ValueError(f"unknown signal domain {self.domain!r}")
        if self.multi_speaker and self.monarch:
            raise ValueError("a multi-speaker model cannot be monaural")


WAV_MONO = SignalSpec(domain="wav", multi_speaker=False, monarch=True)
STFT_MONO = SignalSpec(domain="stft", multi_speaker=False, monarch=True)
STFT_MULTI = SignalSpec(domain="stft", multi_speaker=True, monarch=False)
WAV_MULTI = SignalSpec(domain="wav", multi_speaker=True, monarch=False)
