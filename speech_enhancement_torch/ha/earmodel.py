"""Native HASPI v1 / HASQI v2 (Kates & Arehart hearing-aid metrics).

The port's own copy of speech_enhancement_tpu/ha/earmodel.py (numpy and
scipy on the host, no JAX in either), unchanged in arithmetic.

The reference computes HASPI/HASQI through the external ``clarity`` package
(src/solver.py:723-746 gated on the import at src/solver.py:82-89); that
package is not available in this image, so the metrics are implemented here
from the published papers:

  J. M. Kates, K. H. Arehart, "The Hearing-Aid Speech Perception Index
  (HASPI)", Speech Communication 65, 2014.
  J. M. Kates, K. H. Arehart, "The Hearing-Aid Speech Quality Index
  (HASQI) Version 2", J. Audio Eng. Soc. 62(3), 2014.
  J. M. Kates, "An auditory model for intelligibility and quality
  predictions", POMA 19, 2013 (the shared front-end both indices use).

Pipeline (shared auditory model): resample to 24 kHz -> level alignment to
a 65 dB SPL reference -> middle-ear bandpass -> 32-band ERB-spaced
gammatone filterbank with hearing-loss-broadened bandwidths -> control-path
envelope -> outer-hair-cell dynamic-range compression with audiogram-split
OHC/IHC attenuation -> rapid/short-term envelope adaptation -> band
envelopes in dB SL + basilar-membrane vibration signals.

HASPI v1: 16-ms smoothed envelopes -> half-cosine cepstral-correlation
(bases 2..6) + three level-banded BM coherence terms -> logistic combine.
HASQI v2: nonlinear term (8-ms cepstral correlation cubed + high-level BM
coherence cubed) x linear term (long-term spectral loudness/slope match).

Conformance caveats (documented in PARITY.md): the inner-hair-cell
adaptation stage uses a first-order overshoot network rather than the ITU-
unpublished RC-charge analog of the original MATLAB release, and band group
delays are equalised from the analytic gammatone peak delay. Both signals
pass through identical stages, so the correlation-based terms see matched
processing; golden tests pin identical-signal anchors, SNR monotonicity,
and audiogram sensitivity rather than third-party score equality.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import butter, lfilter, resample_poly

FS_MODEL = 24000  # auditory model internal rate (Hz)
NCHAN = 32  # gammatone bands
LEVEL1 = 65.0  # dB SPL that an RMS-1 signal maps to
AUD_FREQ = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0])
_EARQ = 9.26449  # Glasberg & Moore ERB constants
_MINBW = 24.7
_SMALL = 1e-30


# ---------------------------------------------------------------------------
# Shared auditory front-end
# ---------------------------------------------------------------------------

def center_frequencies(nchan: int = NCHAN, low: float = 80.0,
                       high: float = 8000.0) -> np.ndarray:
    """ERB-spaced gammatone center frequencies, low->high."""
    i = np.arange(nchan, dtype=float)
    cf = -(_EARQ * _MINBW) + np.exp(
        (nchan - 1 - i) * (-np.log(high + _EARQ * _MINBW)
                           + np.log(low + _EARQ * _MINBW)) / (nchan - 1)
    ) * (high + _EARQ * _MINBW)
    return cf  # ascending: the (nchan-1-i) exponent maps i=0 -> low


def _erb(cf: np.ndarray) -> np.ndarray:
    return _MINBW + cf / _EARQ


def loss_parameters(hearing_loss: np.ndarray, cfreq: np.ndarray):
    """Audiogram -> per-band OHC/IHC attenuation, compression, bandwidth.

    ``hearing_loss``: dB HL at AUD_FREQ. The loss is split 80/20 between
    outer and inner hair cells up to the theoretical maximum OHC loss
    (HASQI v2 paper, Sec. 2.2); excess is assigned to the IHC. Compression
    ratio runs 1.25 (apex) to 3.5 (base); OHC loss broadens the control
    bandwidth and raises the compression knee.
    """
    loss = np.interp(np.log10(cfreq), np.log10(AUD_FREQ),
                     np.asarray(hearing_loss, dtype=float))
    loss = np.maximum(loss, 0.0)
    nchan = len(cfreq)
    compression_ratio = 1.25 + 2.25 * np.arange(nchan) / (nchan - 1)
    max_ohc = 70.0 * (1.0 - 1.0 / compression_ratio)
    theoretical_ohc = 1.25 * max_ohc
    attn_ohc = np.where(loss < theoretical_ohc, 0.8 * loss,
                        0.8 * theoretical_ohc)
    attn_ihc = np.where(loss < theoretical_ohc, 0.2 * loss,
                        0.2 * theoretical_ohc + (loss - theoretical_ohc))
    # loss-adjusted compression: full loss removes compression entirely
    ratio = 1.0 + (compression_ratio - 1.0) * (1.0 - attn_ohc
                                               / np.maximum(max_ohc, _SMALL))
    ratio = np.maximum(ratio, 1.0)
    bandwidth = 1.0 + attn_ohc / 50.0 + 2.0 * (attn_ohc / 50.0) ** 6
    knee_low = attn_ohc + 30.0
    return attn_ohc, attn_ihc, ratio, bandwidth, knee_low


def _middle_ear(x: np.ndarray, fs: float) -> np.ndarray:
    bl, al = butter(1, 5000.0 / (0.5 * fs), btype="low")
    bh, ah = butter(2, 350.0 / (0.5 * fs), btype="high")
    return lfilter(bh, ah, lfilter(bl, al, x))


def _gammatone_env_bm(x: np.ndarray, bw_factor: float, fs: float,
                      cf: float):
    """4th-order gammatone via complex demodulation (Kates 2013 front-end).

    Returns (envelope, basilar-membrane vibration) for one band. The
    one-pole cascade applied to the demodulated signal realises the
    gammatone envelope; remodulation restores the carrier for the BM
    signal.
    """
    bw_hz = bw_factor * 1.019 * _erb(np.array([cf]))[0]
    a = np.exp(-2.0 * np.pi * bw_hz / fs)
    gain = (1.0 - a) ** 4  # unity DC gain through the 4-pole cascade
    n = np.arange(len(x))
    phase = 2.0 * np.pi * cf * n / fs
    cosw, sinw = np.cos(phase), np.sin(phase)
    ureal = lfilter([1.0], [1.0, -a], x * cosw)
    uimag = lfilter([1.0], [1.0, -a], x * sinw)
    for _ in range(3):
        ureal = lfilter([1.0], [1.0, -a], ureal)
        uimag = lfilter([1.0], [1.0, -a], uimag)
    ureal *= gain
    uimag *= gain
    env = 2.0 * np.sqrt(ureal ** 2 + uimag ** 2)
    bm = 2.0 * (ureal * cosw + uimag * sinw)
    return env, bm


def _group_delay_samples(bw_factor: np.ndarray, cfreq: np.ndarray,
                         fs: float) -> np.ndarray:
    """Envelope peak delay of the 4th-order gammatone: 3 / (2 pi b)."""
    bw_hz = bw_factor * 1.019 * _erb(cfreq)
    return np.round(fs * 3.0 / (2.0 * np.pi * bw_hz)).astype(int)


def _env_compress(env: np.ndarray, bm: np.ndarray, control: np.ndarray,
                  attn_ohc: float, knee_low: float, ratio: float,
                  fs: float):
    """OHC dynamic-range compression steered by the control envelope.

    Gain in dB: -attn_ohc - (control_dB - knee_low) * (1 - 1/ratio),
    with control_dB clipped to [knee_low, 100]. The gain track is smoothed
    with the control-path bandwidth so the instantaneous gain cannot
    introduce spectral splatter.
    """
    control_db = LEVEL1 + 20.0 * np.log10(control + _SMALL)
    control_db = np.clip(control_db, knee_low, 100.0)
    gain_db = -attn_ohc - (control_db - knee_low) * (1.0 - 1.0 / ratio)
    gain = 10.0 ** (gain_db / 20.0)
    blp, alp = butter(1, 800.0 / (0.5 * fs), btype="low")
    gain = lfilter(blp, alp, gain)
    return gain * env, gain * bm


def _ihc_adapt(env_db: np.ndarray, fs: float, delta: float = 2.0):
    """Rapid + short-term adaptation as a first-order overshoot network.

    Documented deviation from the original RC-charge analog: the dB
    envelope is emphasised by delta x its 2-ms highpass component plus a
    60-ms component, normalised so a static input is unchanged.
    """
    out = env_db
    for tau_ms, weight in ((2.0, delta - 1.0), (60.0, 0.5)):
        a = np.exp(-1.0 / (tau_ms * 1e-3 * fs))
        low = lfilter([1.0 - a], [1.0, -a], env_db)
        out = out + weight * (env_db - low)
    return np.maximum(out / (1.0 + (delta - 1.0) + 0.5), 0.0)


def ear_model(reference: np.ndarray, processed: np.ndarray, fs: float,
              hearing_loss, equalisation: int, level1: float = LEVEL1):
    """Shared auditory model for both signals.

    ``equalisation`` = 0: reference heard by a NORMAL ear (HASPI
    intelligibility convention); = 1: reference passes through the same
    impaired ear (HASQI quality convention). Returns
    ``(ref_db, ref_bm, proc_db, proc_bm, cfreq, fs_model)`` with
    ``*_db`` = [nchan, T] envelopes in dB SL and ``*_bm`` the compressed
    BM vibration signals.
    """
    reference = np.asarray(reference, dtype=float).ravel()
    processed = np.asarray(processed, dtype=float).ravel()
    n = min(len(reference), len(processed))
    reference, processed = reference[:n], processed[:n]
    if fs != FS_MODEL:
        g = np.gcd(int(fs), FS_MODEL)
        reference = resample_poly(reference, FS_MODEL // g, int(fs) // g)
        processed = resample_poly(processed, FS_MODEL // g, int(fs) // g)
    fs = FS_MODEL

    # level alignment: reference RMS -> level1 dB SPL; the SAME factor is
    # applied to the processed signal so gain differences survive.
    ref_rms = np.sqrt(np.mean(reference ** 2)) + _SMALL
    scale = 1.0 / ref_rms
    reference = reference * scale
    processed = processed * scale

    reference = _middle_ear(reference, fs)
    processed = _middle_ear(processed, fs)

    cfreq = center_frequencies()
    hl = np.asarray(hearing_loss, dtype=float)
    attn_ohc_p, attn_ihc_p, ratio_p, bw_p, knee_p = loss_parameters(hl, cfreq)
    if equalisation == 0:
        attn_ohc_r, attn_ihc_r, ratio_r, bw_r, knee_r = loss_parameters(
            np.zeros_like(AUD_FREQ), cfreq)
    else:
        attn_ohc_r, attn_ihc_r, ratio_r, bw_r, knee_r = (
            attn_ohc_p, attn_ihc_p, ratio_p, bw_p, knee_p)
    # control path: maximally-broadened bandwidth (100 dB loss), shared
    _, _, _, bw_ctl, _ = loss_parameters(np.full_like(AUD_FREQ, 100.0), cfreq)

    # matched analysis bandwidth for cross-correlation stability
    bw_x = np.maximum(bw_r, bw_p)

    t = len(reference)
    ref_db = np.zeros((NCHAN, t))
    proc_db = np.zeros((NCHAN, t))
    ref_bm = np.zeros((NCHAN, t))
    proc_bm = np.zeros((NCHAN, t))
    for k in range(NCHAN):
        ctl_r, _ = _gammatone_env_bm(reference, bw_ctl[k], fs, cfreq[k])
        ctl_p, _ = _gammatone_env_bm(processed, bw_ctl[k], fs, cfreq[k])
        env_r, bm_r = _gammatone_env_bm(reference, bw_x[k], fs, cfreq[k])
        env_p, bm_p = _gammatone_env_bm(processed, bw_x[k], fs, cfreq[k])
        env_r, bm_r = _env_compress(env_r, bm_r, ctl_r, attn_ohc_r[k],
                                    knee_r[k], ratio_r[k], fs)
        env_p, bm_p = _env_compress(env_p, bm_p, ctl_p, attn_ohc_p[k],
                                    knee_p[k], ratio_p[k], fs)
        # dB SL with IHC attenuation, then adaptation
        db_r = np.maximum(
            level1 - attn_ihc_r[k] + 20.0 * np.log10(env_r + _SMALL), 0.0)
        db_p = np.maximum(
            level1 - attn_ihc_p[k] + 20.0 * np.log10(env_p + _SMALL), 0.0)
        ref_db[k] = _ihc_adapt(db_r, fs)
        proc_db[k] = _ihc_adapt(db_p, fs)
        ref_bm[k] = bm_r
        proc_bm[k] = bm_p

    # group-delay equalisation across bands
    gd = _group_delay_samples(bw_x, cfreq, fs)
    lead = gd.max() - gd
    for k in range(NCHAN):
        if lead[k]:
            ref_db[k] = np.concatenate([np.zeros(lead[k]), ref_db[k][: -lead[k]]])
            proc_db[k] = np.concatenate([np.zeros(lead[k]), proc_db[k][: -lead[k]]])
            ref_bm[k] = np.concatenate([np.zeros(lead[k]), ref_bm[k][: -lead[k]]])
            proc_bm[k] = np.concatenate([np.zeros(lead[k]), proc_bm[k][: -lead[k]]])
    return ref_db, ref_bm, proc_db, proc_bm, cfreq, fs


# ---------------------------------------------------------------------------
# Envelope segmentation + correlation machinery
# ---------------------------------------------------------------------------

def _env_smooth(env_db: np.ndarray, seg_ms: float, fs: float) -> np.ndarray:
    """Hann-weighted segment means, 50% overlap -> [nchan, nseg]."""
    seg = int(round(seg_ms * 1e-3 * fs))
    seg += seg % 2  # even
    hop = seg // 2
    win = np.hanning(seg + 2)[1:-1]
    wsum = win.sum()
    nseg = max((env_db.shape[1] - seg) // hop + 1, 0)
    out = np.zeros((env_db.shape[0], nseg))
    for s in range(nseg):
        out[:, s] = env_db[:, s * hop: s * hop + seg] @ win / wsum
    return out


def cepstral_correlation(ref_seg: np.ndarray, proc_seg: np.ndarray,
                         thr: float = 2.5, nbasis: int = 6):
    """Half-cosine cepstral correlation (HASPI paper Sec. 2.3).

    Projects each segment's band spectrum onto half-cosine bases 0..5,
    correlates the ref/proc time sequences per basis, and averages bases
    2..6. Silent segments (reference mean below ``thr`` dB SL) are removed.
    """
    keep = ref_seg.mean(axis=0) > thr
    if keep.sum() < 2:
        return 0.0, 0
    r = ref_seg[:, keep]
    p = proc_seg[:, keep]
    nchan = r.shape[0]
    j = np.arange(nchan)
    basis = np.stack([np.cos(k * np.pi * j / (nchan - 1))
                      for k in range(nbasis)])  # [nbasis, nchan]
    rc = basis @ r  # [nbasis, nseg]
    pc = basis @ p
    corr = np.zeros(nbasis)
    for k in range(1, nbasis):
        a = rc[k] - rc[k].mean()
        b = pc[k] - pc[k].mean()
        denom = np.sqrt((a ** 2).sum() * (b ** 2).sum()) + _SMALL
        corr[k] = max(float((a * b).sum() / denom), 0.0)
    return float(corr[1:].mean()), int(keep.sum())


def bm_coherence(ref_bm: np.ndarray, proc_bm: np.ndarray, fs: float,
                 seg_ms: float = 16.0):
    """Level-banded basilar-membrane coherence (low/mid/high thirds).

    Short-time normalized cross-correlation of the BM vibration, averaged
    over bands; segments are split into level thirds by reference RMS and
    the mean coherence of each third is returned.
    """
    seg = int(round(seg_ms * 1e-3 * fs))
    seg += seg % 2
    hop = seg // 2
    win = np.hanning(seg + 2)[1:-1]
    nseg = max((ref_bm.shape[1] - seg) // hop + 1, 0)
    if nseg < 3:
        return 0.0, 0.0, 0.0
    coh = np.zeros(nseg)
    lev = np.zeros(nseg)
    for s in range(nseg):
        sl = slice(s * hop, s * hop + seg)
        r = ref_bm[:, sl] * win
        p = proc_bm[:, sl] * win
        rp = (r * p).sum(axis=1)
        rr = (r * r).sum(axis=1)
        pp = (p * p).sum(axis=1)
        denom = np.sqrt(rr * pp) + _SMALL
        coh[s] = np.clip(rp / denom, 0.0, 1.0).mean()
        lev[s] = rr.sum()
    # silence gate, then level thirds
    order = np.argsort(lev)
    alive = order[lev[order] > lev.max() * 1e-6]
    if len(alive) < 3:
        return 0.0, 0.0, 0.0
    third = len(alive) // 3
    low = coh[alive[:third]].mean() if third else 0.0
    mid = coh[alive[third: 2 * third]].mean() if third else 0.0
    high = coh[alive[2 * third:]].mean()
    return float(low), float(mid), float(high)


def _spectral_diff(ref_seg: np.ndarray, proc_seg: np.ndarray,
                   thr: float = 2.5):
    """HASQI linear term: long-term spectral loudness + slope differences."""
    keep = ref_seg.mean(axis=0) > thr
    if keep.sum() < 1:
        return 1.0, 1.0
    r = ref_seg[:, keep].mean(axis=1)
    p = proc_seg[:, keep].mean(axis=1)
    r = r / (r.sum() + _SMALL)
    p = p / (p.sum() + _SMALL)
    d_loud = float(np.abs(p - r).sum())
    d_slope = float(np.abs(np.diff(p) - np.diff(r)).sum())
    return d_loud, d_slope


# ---------------------------------------------------------------------------
# The two indices
# ---------------------------------------------------------------------------

def haspi_v1(reference: np.ndarray, processed: np.ndarray, fs: float,
             hearing_loss, level1: float = LEVEL1) -> float:
    """HASPI v1 intelligibility index in [0, 1] (Kates & Arehart 2014).

    p = -9.047 + 14.817 c + 0 a_low + 0 a_mid + 4.616 a_high;
    HASPI = 1 / (1 + exp(-p))  (paper Eq. 2 coefficients).
    """
    ref_db, ref_bm, proc_db, proc_bm, _, fsm = ear_model(
        reference, processed, fs, hearing_loss, equalisation=0,
        level1=level1)
    ref_seg = _env_smooth(ref_db, 16.0, fsm)
    proc_seg = _env_smooth(proc_db, 16.0, fsm)
    cep, _ = cepstral_correlation(ref_seg, proc_seg)
    _, _, a_high = bm_coherence(ref_bm, proc_bm, fsm)
    p = -9.047 + 14.817 * cep + 4.616 * a_high
    return float(1.0 / (1.0 + np.exp(-p)))


def hasqi_v2(reference: np.ndarray, processed: np.ndarray, fs: float,
             hearing_loss, level1: float = LEVEL1) -> float:
    """HASQI v2 quality index in [0, 1] (Kates & Arehart 2014).

    Nonlinear term 0.754 m^3 + 0.246 c_high^3 (8-ms cepstral correlation m,
    high-level BM coherence c_high); linear term 0.329 d_loud + 0.671
    d_slope on clipped complements of the long-term spectral differences;
    HASQI = nonlinear x linear (paper Eqs. 9-11 coefficients).
    """
    ref_db, ref_bm, proc_db, proc_bm, _, fsm = ear_model(
        reference, processed, fs, hearing_loss, equalisation=1,
        level1=level1)
    ref_seg = _env_smooth(ref_db, 8.0, fsm)
    proc_seg = _env_smooth(proc_db, 8.0, fsm)
    m1, _ = cepstral_correlation(ref_seg, proc_seg)
    _, _, c_high = bm_coherence(ref_bm, proc_bm, fsm)
    nonlinear = 0.754 * m1 ** 3 + 0.246 * c_high ** 3
    d_loud, d_slope = _spectral_diff(ref_seg, proc_seg)
    q_loud = np.clip(1.0 - d_loud / 2.5, 0.0, 1.0)
    q_slope = np.clip(1.0 - d_slope, 0.0, 1.0)
    linear = 0.329 * q_loud + 0.671 * q_slope
    return float(np.clip(nonlinear * linear, 0.0, 1.0))


def _interp_audiogram(levels, cfs) -> np.ndarray:
    """Listener audiogram (any cfs grid) -> dB HL at AUD_FREQ."""
    levels = np.asarray(levels, dtype=float)
    cfs = np.asarray(cfs, dtype=float)
    return np.interp(np.log10(AUD_FREQ), np.log10(cfs), levels)


def haspi_v1_better_ear(ref_left, ref_right, proc_left, proc_right, fs,
                        audiogram_left, audiogram_right, audiogram_cfs):
    """Better-ear HASPI (max over ears), Clarity-style call shape."""
    left = haspi_v1(ref_left, proc_left, fs,
                    _interp_audiogram(audiogram_left, audiogram_cfs))
    right = haspi_v1(ref_right, proc_right, fs,
                     _interp_audiogram(audiogram_right, audiogram_cfs))
    return max(left, right)


def hasqi_v2_better_ear(ref_left, ref_right, proc_left, proc_right, fs,
                        audiogram_left, audiogram_right, audiogram_cfs):
    """Better-ear HASQI (max over ears), Clarity-style call shape."""
    left = hasqi_v2(ref_left, proc_left, fs,
                    _interp_audiogram(audiogram_left, audiogram_cfs))
    right = hasqi_v2(ref_right, proc_right, fs,
                     _interp_audiogram(audiogram_right, audiogram_cfs))
    return max(left, right)
