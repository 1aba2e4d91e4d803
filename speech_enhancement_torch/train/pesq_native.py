"""ctypes binding for the native PESQ implementation (native/pesq.cpp;
counterpart of speech_enhancement_tpu/train/pesq_native.py).

The reference scores PESQ through the ``pesq`` wheel's compiled ITU P.862
C code (reference src/metric.py:3,147-175). This image ships neither the
wheel nor the ITU source, so ``native/pesq.cpp`` re-implements the
published P.862/P.862.2 perceptual model from the spec (deviations
documented there and in PARITY.md). :mod:`train.metrics` prefers the
conformant wheel when installed and falls back to this binding, so the
``pesq_*`` results.csv columns fill either way.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from speech_enhancement_torch.data.native import open_native

_lib: Optional[ctypes.CDLL] = None
_tried = False


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building on demand) the native PESQ library; None if absent."""
    global _lib, _tried
    if _lib is not None or (_tried and not build):
        return _lib
    _tried = True
    lib = open_native("libpesq.so", build)
    if lib is None:
        return None
    lib.pesq_mos.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.pesq_mos.restype = ctypes.c_double
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def pesq_native(fs: int, ref: np.ndarray, deg: np.ndarray,
                mode: str = "wb") -> float:
    """MOS-LQO via the native P.862-class model.

    Same call contract as ``pesq.pesq`` (the wheel): raises ValueError on
    bad inputs so callers' per-utterance error tolerance (reference
    metric.py:160-171) behaves identically.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native PESQ library unavailable")
    ref = np.ascontiguousarray(np.asarray(ref, dtype=np.float32).ravel())
    deg = np.ascontiguousarray(np.asarray(deg, dtype=np.float32).ravel())
    n = min(ref.size, deg.size)
    score = lib.pesq_mos(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, int(fs), 1 if mode == "wb" else 0,
    )
    if score < 0:
        raise ValueError(f"pesq_mos failed (code {score}): fs={fs} n={n}")
    return float(score)
