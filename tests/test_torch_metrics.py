"""The port's scoring vs the JAX package's, on the CPU.

SI-SDR, BSS Eval SDR (one source and several), STOI and ESTOI, and the
native wide- and narrow-band PESQ of the same seeded arrays must equal the
JAX functions' to rtol 1e-6 (the code is the same numpy and the same
library, so they come out equal); ``compute_metrics`` must give the same
bundle and ``SpeechMetricResultsFile`` the same CSV.
"""

import numpy as np
import pytest

from speech_enhancement_torch.train import metrics as port_metrics
from speech_enhancement_torch.train import pesq_native as port_pesq
from speech_enhancement_torch.train import stoi as port_stoi
from speech_enhancement_tpu.train import metrics as jax_metrics
from speech_enhancement_tpu.train import pesq_native as jax_pesq
from speech_enhancement_tpu.train import stoi as jax_stoi

RTOL = 1e-6


def _speechlike(rng, n, sr=16000):
    t = np.arange(n) / sr
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 4) * t))
    f0 = rng.uniform(110, 220)
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3, 5))
    return (0.3 * env * sig).astype(np.float32)


@pytest.fixture(scope="module")
def signals():
    """Clean [B=2, C=1, 2 s], a noisy and a filtered estimate of it."""
    rng = np.random.default_rng(31)
    clean = np.stack([_speechlike(rng, 32000) for _ in range(2)])[:, None]
    noisy = clean + 0.05 * rng.standard_normal(clean.shape).astype(np.float32)
    filtered = 0.8 * np.roll(clean, 3, axis=-1) + 0.02 * rng.standard_normal(
        clean.shape).astype(np.float32)
    return clean, noisy.astype(np.float32), filtered.astype(np.float32)


def test_si_sdr_and_sdr_match(signals):
    clean, noisy, filtered = signals
    for est in (noisy, filtered):
        np.testing.assert_allclose(port_metrics.si_sdr_numpy(clean, est),
                                   jax_metrics.si_sdr_numpy(clean, est), rtol=RTOL)
        np.testing.assert_allclose(port_metrics.sdr(clean, est),
                                   jax_metrics.sdr(clean, est), rtol=RTOL)


@pytest.mark.parametrize("shape", ["sources", "sources_channels"])
def test_bss_eval_sources_matches(signals, shape):
    clean, noisy, filtered = signals
    refs = np.concatenate([clean, filtered], axis=1)  # [2 sources, 2 rows, T]
    refs = refs[:, 0] if shape == "sources" else refs
    ests = refs[::-1] + 0.1 * refs
    got = port_metrics.bss_eval_sources(refs[..., :6000], ests[..., :6000], n_taps=64)
    want = jax_metrics.bss_eval_sources(refs[..., :6000], ests[..., :6000], n_taps=64)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["perm"], want["perm"])
    for key in ("sdr", "sir", "sar"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches(signals, extended):
    clean, noisy, filtered = signals
    for est in (noisy, filtered):
        got = port_metrics.stoi_score(clean, est, 16000, extended=extended)
        want = jax_metrics.stoi_score(clean, est, 16000, extended=extended)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert 0.0 < got <= 1.0
    # the bare function at another rate, as the 10 kHz resampler sees it
    np.testing.assert_allclose(
        port_stoi.stoi(clean[0, 0, :16000], noisy[0, 0, :16000], 8000, extended),
        jax_stoi.stoi(clean[0, 0, :16000], noisy[0, 0, :16000], 8000, extended), rtol=RTOL)


def test_native_pesq_matches(signals):
    assert port_pesq.available() and jax_pesq.available()
    wb, nb, name = port_metrics.pesq_backend()
    assert name == jax_metrics.PESQ_IMPL  # the wheel where it imports, else "native"
    clean, noisy, filtered = signals
    for est in (noisy, filtered):
        for mode in ("wb", "nb"):
            np.testing.assert_allclose(
                port_pesq.pesq_native(16000, clean[0, 0], est[0, 0], mode),
                jax_pesq.pesq_native(16000, clean[0, 0], est[0, 0], mode), rtol=RTOL)
        np.testing.assert_allclose(port_metrics.wb_pesq(clean, est),
                                   jax_metrics.wb_pesq(clean, est), rtol=RTOL)
        np.testing.assert_allclose(port_metrics.nb_pesq(clean, est),
                                   jax_metrics.nb_pesq(clean, est), rtol=RTOL)
    with pytest.raises(ValueError):  # the wheel's error contract
        port_pesq.pesq_native(16000, clean[0, 0, :100], clean[0, 0, :100])


def test_bundle_and_results_csv_match(signals, tmp_path):
    clean, noisy, _ = signals
    include = ("sisdr", "stoi", "pesq", "nb-pesq", "sdr")
    got = port_metrics.compute_metrics(clean, noisy, 16000, include)
    want = jax_metrics.compute_metrics(clean, noisy, 16000, include)
    assert sorted(got) == sorted(want) == sorted(include)
    for key in include:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    files = []
    for pkg, name in ((port_metrics, "port.csv"), (jax_metrics, "jax.csv")):
        results = pkg.SpeechMetricResultsFile(str(tmp_path / "run" / name))
        results.clear()
        results.add_result("S00001", sisdr_enhance=1.5, sisdr_mixture=-0.25, pesq_enhance=None,
                           stoi_enhance=np.float64(0.875), haspi_enhance="gated")
        results.add_result("p000_001", **{f"{k}_enhance": v for k, v in got.items()
                                          if k in ("sisdr", "stoi", "pesq")})
        files.append((tmp_path / "run" / name).read_text())
    assert files[0] == files[1] and files[0].count("\n") == 3
