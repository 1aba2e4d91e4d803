"""WAV file I/O without libsndfile (counterpart of speech_enhancement_tpu/data/wav_io.py).

The reference reads audio with ``soundfile`` (libsndfile C bindings,
src/dataset.py:100-101); that wheel is not in this image, so PCM16/24/32 and
float32 WAVs are decoded here with scipy.io.wavfile plus a small fallback
for 24-bit files. Layout contract: arrays are channel-first ``[C, T]``
float32 in [-1, 1], the framework's internal convention.
"""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [C, T], sample_rate).

    Uses the native C decoder (native/wavio.cpp) when built — the loader's
    hot path — falling back to scipy. Set SE_TPU_NO_NATIVE=1 to disable.
    """
    if not os.environ.get("SE_TPU_NO_NATIVE"):
        from speech_enhancement_torch.data import native

        if native.available():
            return native.read_wav(path)
    try:
        sr, data = wavfile.read(path)
    except ValueError:
        return _read_wav_24bit(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:  # scipy gives [T, C]
        data = np.ascontiguousarray(data.T)
    return data, int(sr)


def _read_wav_24bit(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as handle:
        n_channels = handle.getnchannels()
        width = handle.getsampwidth()
        sr = handle.getframerate()
        raw = handle.readframes(handle.getnframes())
    if width != 3:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    buf = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    ints = (
        buf[:, 0].astype(np.int32)
        | (buf[:, 1].astype(np.int32) << 8)
        | (buf[:, 2].astype(np.int32) << 16)
    )
    ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
    data = (ints.astype(np.float32) / float(1 << 23)).reshape(-1, n_channels)
    return np.ascontiguousarray(data.T), int(sr)


def write_wav(path: str, data: np.ndarray, sample_rate: int, dtype: str = "float32") -> None:
    """Write [C, T] or [T] float audio to a WAV file."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T  # scipy expects [T, C]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if dtype == "int16":
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    else:
        data = data.astype(np.float32)
    wavfile.write(path, sample_rate, data)


def find_wav_files(root: str) -> list:
    """Sorted recursive list of .wav paths (librosa.util.find_files equivalent,
    reference src/dataset.py:56-61)."""
    hits = []
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith(".wav"):
                hits.append(os.path.join(dirpath, name))
    return sorted(hits)
