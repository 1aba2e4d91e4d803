"""ctypes bindings for the native host data path (native/wavio.cpp; counterpart
of speech_enhancement_tpu/data/native.py).

Provides C-speed WAV decode, polyphase resample, and z-score normalization
for the loader's hot path. The library is optional: ``load_library()``
builds it on demand with make if a compiler is present, and every caller
falls back to the numpy/scipy implementations when unavailable
(data/wav_io.py, data/dataset.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cdll(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:  # absent, or built for another host
        return None


# the Makefile's variable that names each library's output file
_MAKE_VARS = {"libseio.so": "TARGET", "libpesq.so": "PESQ"}


def open_native(name: str, build: bool = True) -> Optional[ctypes.CDLL]:
    """``native/{name}`` as a CDLL; None if it cannot be had.

    A library that is absent, or present but built for another host (the
    repository commits ``libpesq.so``), is rebuilt once with ``make -C
    native`` when ``build`` and a compiler allow. The build writes a file of
    this process's own and renames it into place, so another process never
    loads a half-written library.
    """
    path = os.path.join(_NATIVE_DIR, name)
    lib = _cdll(path)
    if lib is None and build and os.path.isdir(_NATIVE_DIR):
        partial = f"{name}.{os.getpid()}.partial"
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s", f"{_MAKE_VARS[name]}={partial}",
                            partial], check=True, capture_output=True, timeout=120)
            os.replace(os.path.join(_NATIVE_DIR, partial), path)
        except (OSError, subprocess.SubprocessError):
            return None
        lib = _cdll(path)
    return lib


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or (_tried and not build):
        return _lib
    _tried = True
    lib = open_native("libseio.so", build)
    if lib is None:
        return None
    lib.wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
    ]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
    ]
    lib.wav_read_f32.restype = ctypes.c_long
    lib.resample_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
    ]
    lib.resample_f32.restype = ctypes.c_long
    lib.normalize_zscore_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.normalize_zscore_f32.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 [C, T], sample_rate) via the C library."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    channels = ctypes.c_int()
    sr = ctypes.c_int()
    frames = ctypes.c_long()
    rc = lib.wav_info(path.encode(), ctypes.byref(channels),
                      ctypes.byref(sr), ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    out = np.empty((channels.value, frames.value), np.float32)
    got = lib.wav_read_f32(path.encode(), _fptr(out), frames.value)
    if got < 0:
        raise IOError(f"wav_read_f32 failed ({got}) for {path}")
    return out[:, :got], sr.value


def resample(x: np.ndarray, old_sr: int, new_sr: int, zeros: int = 24,
             rolloff: float = 0.945) -> np.ndarray:
    """Polyphase windowed-sinc resample of [C, T] float32."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if old_sr == new_sr:
        return x
    g = np.gcd(old_sr, new_sr)
    up, down = new_sr // g, old_sr // g
    x = np.ascontiguousarray(x, np.float32)
    channels, in_frames = x.shape
    out_frames = -(-in_frames * up // down)
    out = np.empty((channels, out_frames), np.float32)
    got = lib.resample_f32(_fptr(x), in_frames, channels, _fptr(out),
                           up, down, zeros, rolloff)
    return out[:, :got]


def normalize_zscore(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """In-place per-channel z-score; returns (x, means[C,1], stds[C,1])."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float32)
    channels, frames = x.shape
    means = np.empty(channels, np.float32)
    stds = np.empty(channels, np.float32)
    lib.normalize_zscore_f32(_fptr(x), channels, frames, _fptr(means), _fptr(stds))
    return x, means[:, None], stds[:, None]
