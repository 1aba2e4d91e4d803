"""Host-side data layer: WAV I/O, datasets, fixed-shape batching
(counterpart of speech_enhancement_tpu/data)."""

from speech_enhancement_torch.data.dataset import ClarityWavDataset, WavDataset  # noqa: F401
from speech_enhancement_torch.data.loader import (  # noqa: F401
    SegmentLoader,
    get_dataloader,
    get_train_wav_dataset,
)
from speech_enhancement_torch.data.wav_io import read_wav, write_wav  # noqa: F401
