"""Evaluation metrics (counterpart of speech_enhancement_tpu/train/metrics.py;
reference: src/metric.py).

SI-SDR here is host-side numpy, bit-matching the reference's
metric.py:92-123 convention — note it does *not* zero-mean; ``si_sdr_torch``
is the same convention on the tensors' device (the loss module's
``si_snr`` is the zero-meaned loss). STOI is a
native numpy implementation (:mod:`.stoi`). PESQ prefers the conformant
ITU ``pesq`` / ``pypesq`` wheels when installed (the reference's path,
src/metric.py:3,147-196) and otherwise falls back to the in-repo native
P.862-class implementation (native/pesq.cpp), so the metric runs even in
wheel-less images. SDR implements BSS Eval's 512-tap
time-invariant distortion filter (the single-source core of museval's
``bss_eval``, src/metric.py:65-89).
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from scipy.linalg import solve_toeplitz
from scipy.signal import fftconvolve

from speech_enhancement_torch.train import pesq_native
from speech_enhancement_torch.train.stoi import stoi as _stoi



@functools.lru_cache(maxsize=None)
def pesq_backend() -> Tuple[Optional[Callable], Optional[Callable], Optional[str]]:
    """(wide-band fn, narrow-band fn, name of the wide-band implementation).

    The conformant ITU ``pesq`` wheel (and ``pypesq`` for narrow band) when
    importable, as in the reference (src/metric.py:3,147-196); otherwise the
    in-repo native P.862-class library (native/pesq.cpp via
    train/pesq_native.py), so the metric runs in wheel-less images. None
    where neither is to be had. Resolved on first use, not at import, since
    the native library may have to be built.
    """
    native = pesq_native.available()
    try:
        from pesq import pesq as wb  # type: ignore

        name = "itu-wheel"
    except ImportError:
        wb, name = None, None
        if native:
            def wb(sr, ref, deg, mode="wb"):  # same signature as pesq.pesq
                return pesq_native.pesq_native(sr, ref, deg, mode)

            name = "native"
    try:
        from pypesq import pesq as nb  # type: ignore
    except ImportError:
        nb = None
        if native:
            def nb(ref, deg, sr):  # pypesq argument order
                return pesq_native.pesq_native(sr, ref, deg, "nb")
    return wb, nb, name


_EPS = np.finfo(np.float64).eps


def si_sdr_numpy(reference: np.ndarray, estimation: np.ndarray) -> float:
    """Reference SI-SDR over [..., T] (src/metric.py:92-123; no zero-mean)."""
    reference = np.asarray(reference, dtype=np.float64)
    estimation = np.asarray(estimation, dtype=np.float64)
    ref_energy = np.sum(reference**2, axis=-1, keepdims=True)
    scaling = np.sum(estimation * reference, axis=-1, keepdims=True) / (ref_energy + _EPS)
    projection = scaling * reference
    noise = estimation - projection
    ratio = np.sum(projection**2, axis=-1) / (np.sum(noise**2, axis=-1) + _EPS)
    return float(10 * np.log10(np.mean(ratio) + _EPS))


def si_sdr_torch(reference: torch.Tensor, estimation: torch.Tensor) -> torch.Tensor:
    """SI-SDR over [..., T] on the tensors' device (JAX ``si_sdr_jax``'s
    convention: not zero-meaned, eps 1e-12); a 0-dim tensor."""
    ref_energy = torch.sum(reference**2, dim=-1, keepdim=True)
    scaling = torch.sum(estimation * reference, dim=-1, keepdim=True) / (ref_energy + 1e-12)
    projection = scaling * reference
    noise = estimation - projection
    ratio = torch.sum(projection**2, dim=-1) / (torch.sum(noise**2, dim=-1) + 1e-12)
    return 10.0 * torch.log10(torch.mean(ratio) + 1e-12)


def sdr(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000, n_taps: int = 512) -> float:
    """BSS Eval SDR with a time-invariant 512-tap allowed distortion filter.

    Single-source core of bss_eval (Vincent et al. 2006), matching the
    reference's museval usage over [B, C, T] (src/metric.py:65-89).
    """
    reference = np.atleast_2d(np.asarray(reference, dtype=np.float64))
    estimation = np.atleast_2d(np.asarray(estimation, dtype=np.float64))
    flat_ref = reference.reshape(-1, reference.shape[-1])
    flat_est = estimation.reshape(-1, estimation.shape[-1])
    scores = []
    for ref, est in zip(flat_ref, flat_est):
        n = len(ref)
        taps = min(n_taps, n)
        # Least-squares FIR projecting est onto ref's delayed copies.
        full_corr = fftconvolve(ref, est[::-1])
        # r[lag] = sum_k est[k + lag] * ref[k] lives at index n - 1 - lag.
        cross = full_corr[n - taps : n][::-1]
        auto_full = fftconvolve(ref, ref[::-1])
        auto = auto_full[n - 1 : n - 1 + taps]
        auto = auto.copy()
        auto[0] += 1e-10 * (auto[0] if auto[0] > 0 else 1.0)
        h = solve_toeplitz(auto, cross)
        s_target = fftconvolve(h, ref)[:n]
        e_total = est - s_target
        num = np.sum(s_target**2)
        den = np.sum(e_total**2)
        scores.append(10 * np.log10((num + _EPS) / (den + _EPS)))
    return float(np.mean(scores))


def _proj_filters(sources: np.ndarray, estimate: np.ndarray, taps: int) -> np.ndarray:
    """Least-squares projection of ``estimate`` onto the span of ``taps``
    delayed copies of every source. Returns the [S, taps] filter block.

    The block-Toeplitz Gram system of BSS Eval (Vincent et al. 2006 §III);
    mirrors museval/mir_eval's ``_project`` numerically.
    """
    n_src, n = sources.shape
    gram = np.zeros((n_src * taps, n_src * taps))
    for i in range(n_src):
        for j in range(i, n_src):
            from scipy.linalg import toeplitz

            full = fftconvolve(sources[i], sources[j][::-1])
            # block[a, b] = full[n - 1 + b - a] (cross-corr at lag b - a)
            block = toeplitz(full[n - 1 - np.arange(taps)],
                             full[n - 1 + np.arange(taps)])
            gram[i * taps:(i + 1) * taps, j * taps:(j + 1) * taps] = block
            if i != j:
                gram[j * taps:(j + 1) * taps, i * taps:(i + 1) * taps] = block.T
    rhs = np.empty(n_src * taps)
    for i in range(n_src):
        full = fftconvolve(sources[i], estimate[::-1])
        rhs[i * taps:(i + 1) * taps] = full[n - taps:n][::-1]
    gram += 1e-10 * np.eye(len(gram)) * max(np.trace(gram) / len(gram), 1.0)
    return np.linalg.solve(gram, rhs).reshape(n_src, taps)


def bss_eval_sources(reference: np.ndarray, estimation: np.ndarray,
                     n_taps: int = 512) -> Dict[str, np.ndarray]:
    """Multi-source BSS Eval (SDR/SIR/SAR per source + best permutation).

    The multi-source counterpart of :func:`sdr` — what the reference's
    ``SDR`` delegates to museval's ``bss_eval`` over [B, S, C, T]
    (reference src/metric.py:65-89): each estimate is decomposed against
    the 512-tap delayed span of ALL reference sources into
    s_target / e_interf / e_artif, and the estimate->source permutation
    maximizing mean SIR is chosen (Vincent et al. 2006). Inputs are
    [S, T] or [S, C, T] (channels flattened into time per museval's
    framewise aggregation). Returns {"sdr", "sir", "sar", "perm"} with
    per-source arrays ordered by reference source.
    """
    import itertools

    reference = np.asarray(reference, dtype=np.float64)
    estimation = np.asarray(estimation, dtype=np.float64)
    if reference.ndim == 3:  # [S, C, T] -> [S, C*T]
        reference = reference.reshape(reference.shape[0], -1)
        estimation = estimation.reshape(estimation.shape[0], -1)
    n_src, n = reference.shape
    taps = min(n_taps, n)

    sdr_m = np.empty((n_src, n_src))
    sir_m = np.empty((n_src, n_src))
    sar_m = np.empty((n_src, n_src))
    for je in range(n_src):  # estimate index
        filters = _proj_filters(reference, estimation[je], taps)
        parts = np.stack([
            fftconvolve(filters[js], reference[js])[:n] for js in range(n_src)
        ])
        p_all = parts.sum(axis=0)
        e_artif = estimation[je] - p_all
        for js in range(n_src):  # candidate true source
            s_target = parts[js]
            e_interf = p_all - s_target
            pt = np.sum(s_target**2)
            sdr_m[je, js] = 10 * np.log10(
                (pt + _EPS) / (np.sum((e_interf + e_artif) ** 2) + _EPS))
            sir_m[je, js] = 10 * np.log10((pt + _EPS) / (np.sum(e_interf**2) + _EPS))
            sar_m[je, js] = 10 * np.log10(
                (np.sum((s_target + e_interf) ** 2) + _EPS) / (np.sum(e_artif**2) + _EPS))

    best, best_perm = -np.inf, tuple(range(n_src))
    for perm in itertools.permutations(range(n_src)):
        mean_sir = np.mean([sir_m[je, js] for je, js in enumerate(perm)])
        if mean_sir > best:
            best, best_perm = mean_sir, perm
    idx_est = np.empty(n_src, dtype=int)  # estimate assigned to source js
    for je, js in enumerate(best_perm):
        idx_est[js] = je
    return {
        "sdr": np.array([sdr_m[idx_est[js], js] for js in range(n_src)]),
        "sir": np.array([sir_m[idx_est[js], js] for js in range(n_src)]),
        "sar": np.array([sar_m[idx_est[js], js] for js in range(n_src)]),
        "perm": idx_est,
    }


def stoi_score(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000,
               extended: bool = False) -> float:
    """Mean STOI over [B, C, T] (reference: src/metric.py:126-144)."""
    reference = np.asarray(reference)
    estimation = np.asarray(estimation)
    flat_ref = reference.reshape(-1, reference.shape[-1])
    flat_est = estimation.reshape(-1, estimation.shape[-1])
    return float(np.mean([_stoi(r, e, sr, extended=extended) for r, e in zip(flat_ref, flat_est)]))


def wb_pesq(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000) -> Optional[float]:
    """Wide-band PESQ via the C library if present, else None.

    The reference tolerates and counts NoUtterancesError (metric.py:147-175);
    we do the same.
    """
    pesq_fn = pesq_backend()[0]
    if pesq_fn is None:
        return None
    reference = np.asarray(reference)
    estimation = np.asarray(estimation)
    flat_ref = reference.reshape(-1, reference.shape[-1])
    flat_est = estimation.reshape(-1, estimation.shape[-1])
    scores = []
    for r, e in zip(flat_ref, flat_est):
        try:
            scores.append(pesq_fn(sr, r, e, mode="wb"))
        except Exception:
            continue
    return float(np.mean(scores)) if scores else 0.0


def nb_pesq(reference: np.ndarray, estimation: np.ndarray, sr: int = 16000) -> Optional[float]:
    """Narrow-band PESQ via pypesq if present, else None (reference:
    src/metric.py:178-196 NB_PESQ — same flatten-and-mean shape contract,
    errors per utterance tolerated and skipped like WB)."""
    nb_fn = pesq_backend()[1]
    if nb_fn is None:
        return None
    reference = np.asarray(reference)
    estimation = np.asarray(estimation)
    flat_ref = reference.reshape(-1, reference.shape[-1])
    flat_est = estimation.reshape(-1, estimation.shape[-1])
    scores = []
    for r, e in zip(flat_ref, flat_est):
        try:
            scores.append(nb_fn(r, e, sr))
        except Exception:
            continue
    return float(np.mean(scores)) if scores else 0.0


def compute_metrics(
    clean: np.ndarray,
    estimate: np.ndarray,
    sr: int = 16000,
    include: tuple = ("sisdr", "stoi", "pesq"),
) -> Dict[str, Optional[float]]:
    """Metric bundle for one utterance batch [B, C, T] (solver.py:704-721)."""
    out: Dict[str, Optional[float]] = {}
    if "sisdr" in include:
        out["sisdr"] = si_sdr_numpy(clean, estimate)
    if "stoi" in include:
        out["stoi"] = stoi_score(clean, estimate, sr)
    if "pesq" in include:
        out["pesq"] = wb_pesq(clean, estimate, sr)
    if "nb-pesq" in include:
        out["nb-pesq"] = nb_pesq(clean, estimate, sr)
    if "sdr" in include:
        out["sdr"] = sdr(clean, estimate, sr)
    return out


class SpeechMetricResultsFile:
    """CSV results writer (reference: src/metric.py:8-63)."""

    COLUMNS = [
        "scene", "pesq_enhance", "pesq_mixture", "stoi_enhance", "stoi_mixture",
        "sisdr_enhance", "sisdr_mixture", "haspi_enhance", "haspi_mixture",
        "hasqi_enhance", "hasqi_mixture",
    ]

    def __init__(self, path: str):
        self.path = path

    def clear(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as handle:
            csv.writer(handle).writerow(self.COLUMNS)

    def add_result(self, scene: str, **scores) -> None:
        row = [scene] + [
            "" if scores.get(col) is None else str(scores.get(col, ""))
            for col in self.COLUMNS[1:]
        ]
        with open(self.path, "a", newline="") as handle:
            csv.writer(handle).writerow(row)
