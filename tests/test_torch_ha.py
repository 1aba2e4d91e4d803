"""The port's hearing-aid chain (``speech_enhancement_torch/ha``) vs the JAX
package's, on the CPU.

Inputs are made from a seed with numpy; each test states its tolerance.
The compressor is also held against the literal per-sample loop of the
reference (``tests/test_ha.py``'s), at 4000 samples and past 2^16.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from speech_enhancement_tpu import ha as jax_ha
from speech_enhancement_tpu.data.synthetic import make_ha_config as jax_make_ha_config
from speech_enhancement_tpu.ha import earmodel as jax_earmodel
from speech_enhancement_tpu.ha.scoring import ClarityScorer as JaxClarityScorer
from speech_enhancement_torch import ha
from speech_enhancement_torch.data.synthetic import make_ha_config
from speech_enhancement_torch.ha import earmodel
from speech_enhancement_torch.ha.compressor import linear_scan
from speech_enhancement_torch.ha.scoring import ClarityScorer, _resolve, load_ha_config

AUDIOGRAM = {
    "audiogram_cfs": [250, 500, 1000, 2000, 3000, 4000, 6000, 8000],
    "audiogram_levels_l": [25, 40, 55, 65, 65, 70, 65, 60],
    "audiogram_levels_r": [20, 30, 55, 65, 65, 75, 60, 50],
}
SHIPPED = dict(fs=44100, threshold=0.35, attenuation=0.1, attack=50, release=1000,
               rms_buffer_size=0.064)  # configs/ha_clarity.yaml


def _rms(comp, sig: np.ndarray) -> np.ndarray:
    """The sliding RMS with a (win - 1) left zero pad, in f64."""
    win = comp.win_len
    padded = np.concatenate([np.zeros(win - 1), sig.astype(np.float64)])
    return np.sqrt(np.convolve(padded**2, np.ones(win), mode="valid") / win + 1e-8)


def _reference_loop(comp, sig: np.ndarray, rms: np.ndarray, coeff_dtype=None) -> np.ndarray:
    """The reference's recurrence, one Python step a sample (compressor.py:85-104),
    carried in f64. With ``coeff_dtype`` each step's coefficients are first
    rounded to it, as an implementation in that dtype rounds them."""
    cast = (lambda v: float(coeff_dtype(v))) if coeff_dtype else float
    keep_att, keep_rel = cast(1 - comp.attack), cast(1 - comp.release)
    release = cast(comp.release)
    curr = 1.0
    want = np.empty(len(rms))
    for t, r in enumerate(rms.astype(np.float64)):
        if r > comp.threshold:
            temp = r * comp.attenuation + (1 - comp.attenuation) * comp.threshold
            curr = curr * keep_att + cast(temp * comp.attack)
        else:
            curr = release + curr * keep_rel
        want[t] = curr
    return sig * want


@pytest.mark.parametrize("nfir,fs", [(220, 44100), (128, 16000)])
def test_nalr_build_equals_jax(nfir, fs):
    cfs = np.asarray(AUDIOGRAM["audiogram_cfs"], float)
    for levels in (AUDIOGRAM["audiogram_levels_l"], AUDIOGRAM["audiogram_levels_r"],
                   np.zeros(8)):
        got = ha.NALR(nfir, fs).build(levels, cfs)
        want = jax_ha.NALR(nfir, fs).build(levels, cfs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ha.NALR(nfir, fs).nalr_gains_db(np.full(6, 60.0)),
                                  jax_ha.NALR(nfir, fs).nalr_gains_db(np.full(6, 60.0)))


def test_nalr_apply_matches_jax(rng):
    """f32 full-padding FIR, within 1e-6 of the output's peak."""
    taps = ha.NALR(220, 44100).build(AUDIOGRAM["audiogram_levels_l"],
                                     np.asarray(AUDIOGRAM["audiogram_cfs"], float))
    wav = (0.3 * rng.standard_normal((2, 3, 5000))).astype(np.float32)
    want = np.asarray(jax_ha.NALR.apply(jnp.asarray(taps), jnp.asarray(wav)))
    got = ha.NALR.apply(taps, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 3, 5000 + 220)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_linear_scan_is_the_recurrence(rng):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 1000)))
    b = torch.from_numpy(rng.standard_normal((3, 1000)))
    want, c = [], torch.zeros(3, dtype=torch.float64)
    for t in range(1000):
        c = a[:, t] * c + b[:, t]
        want.append(c)
    torch.testing.assert_close(linear_scan(a, b), torch.stack(want, -1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["fs8000_4000", "shipped_70000"])
def test_compressor_matches_reference_loop_and_jax(rng, case):
    """atol 1e-4 (tests/test_ha.py's bound) against the reference loop and
    against the JAX Compressor.

    At fs 8000 / attack 5 ms (tests/test_ha.py's case, the loop as it
    stands there) the product of the attack coefficients falls below f32's
    smallest normal within the signal; it is also run with subnormals
    flushed to zero, as a card may flush them. The shipped chain (44.1 kHz,
    attack 50 ms, release 1 s) runs past 2^16 samples. There 1 - release
    rounds in f32 with a relative error of 1e-3 in the release rate, which
    moves the gain by up to 3e-4 from a loop with exact coefficients, for
    the JAX Compressor as for the port (which agree within 1e-5). So past
    2^16 the loop takes the f32-rounded coefficients and carries in f64:
    what is left is the smoother's own rounding, whose doubling scan takes
    another order than the loop and than XLA's tree.
    """
    if case == "fs8000_4000":
        kw = dict(fs=8000, attack=5, release=20, threshold=0.1, attenuation=0.0001,
                  rms_buffer_size=0.05)
        sig = (rng.standard_normal(4000) * 0.5).astype(np.float32)
    else:
        kw = SHIPPED
        t = np.arange(70000) / 44100.0
        envelope = 0.2 + 0.6 * (np.sin(2 * np.pi * 1.5 * t) > 0)  # loud and quiet passages
        sig = (envelope * rng.standard_normal(70000)).astype(np.float32)
    comp = ha.Compressor(**kw)
    rms = _rms(comp, sig)
    got = comp(torch.from_numpy(sig)[None, None])[0, 0].numpy()
    jax_got = np.asarray(jax_ha.Compressor(**kw)(jnp.asarray(sig)[None, None]))[0, 0]
    np.testing.assert_allclose(got, jax_got, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, _reference_loop(comp, sig, rms, np.float32), rtol=0,
                               atol=1e-4)
    if case == "fs8000_4000":
        want = _reference_loop(comp, sig, rms)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        over = rms > comp.threshold
        a = np.where(over, 1.0 - comp.attack, 1.0 - comp.release).astype(np.float32)
        assert np.cumprod(a, dtype=np.float32)[-1] < np.finfo(np.float32).tiny
        assert torch.set_flush_denormal(True)
        try:
            flushed = comp(torch.from_numpy(sig)[None, None])[0, 0].numpy()
        finally:
            torch.set_flush_denormal(False)
        np.testing.assert_allclose(flushed, want, rtol=0, atol=1e-4)
    assert ha.Compressor.process is ha.Compressor.__call__


@pytest.mark.parametrize("bug", [False, True])
def test_amplify_matches_jax(rng, bug):
    """The chain [B, S, 2, T] within 1e-5 (outputs are tanh-clipped to
    [-1, 1]); with stereo_bug_compat the right ear takes the left FIR."""
    signal = (0.1 * rng.standard_normal((1, 2, 2, 6000))).astype(np.float32)
    args = dict(soft_clip=True, stereo_bug_compat=bug)
    want = np.asarray(jax_ha.amplify(jnp.asarray(signal), jax_ha.NALR(128, 16000),
                                     jax_ha.Compressor(fs=16000, rms_buffer_size=0.05),
                                     AUDIOGRAM, **args))
    got = ha.amplify(torch.from_numpy(signal), ha.NALR(128, 16000),
                     ha.Compressor(fs=16000, rms_buffer_size=0.05), AUDIOGRAM, **args).numpy()
    assert got.shape == want.shape == (1, 2, 2, 6000 + 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    fixed = ha.amplify(torch.from_numpy(signal), ha.NALR(128, 16000),
                       ha.Compressor(fs=16000, rms_buffer_size=0.05), AUDIOGRAM).numpy()
    assert np.allclose(got[:, :, 1], fixed[:, :, 1]) == (not bug)
    np.testing.assert_array_equal(got[:, :, 0], fixed[:, :, 0])


@pytest.mark.parametrize("src,channels", [(2, 2), (1, 2), (4, 2), (4, 1)])
def test_convert_audio_channels_matches_jax(rng, src, channels):
    wav = rng.standard_normal((2, src, 100)).astype(np.float32)
    want = np.asarray(jax_ha.convert_audio_channels(jnp.asarray(wav), channels))
    got = ha.convert_audio_channels(torch.from_numpy(wav), channels).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="not mono"):
        ha.convert_audio_channels(torch.zeros(2, 2, 10), 3)


def test_earmodel_copy_equals_jax(rng):
    """The port's ear model is a copy: HASPI and HASQI better-ear on one
    0.5 s pair are equal to the JAX package's bit for bit."""
    fs = 16000
    t = np.arange(fs // 2) / fs
    clean = 0.3 * np.sin(2 * np.pi * 440 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
    ref = np.stack([clean, 0.8 * clean])
    proc = ref + 0.05 * rng.standard_normal(ref.shape)
    args = (ref[0], ref[1], proc[0], proc[1], fs,
            np.asarray(AUDIOGRAM["audiogram_levels_l"], float),
            np.asarray(AUDIOGRAM["audiogram_levels_r"], float),
            np.asarray(AUDIOGRAM["audiogram_cfs"], float))
    for name in ("haspi_v1_better_ear", "hasqi_v2_better_ear"):
        got = getattr(earmodel, name)(*args)
        assert got == getattr(jax_earmodel, name)(*args), name
        assert 0.0 <= got <= 1.0


def test_load_ha_config_resolves_like_jax(tmp_path):
    path = make_ha_config(str(tmp_path / "port"), scenes=["S00001"], n_listeners=1)
    cfg = load_ha_config(path)
    assert cfg["path"]["listeners_file"] == str(tmp_path / "port" / "metadata" /
                                                "listeners.json")
    assert _resolve({"a": ["${b.c}x"]}, {"b": {"c": 3}}) == {"a": ["3x"]}


def test_missing_listeners_file_raises(tmp_path):
    ha_yaml = tmp_path / "ha.yaml"
    ha_yaml.write_text("path:\n  listeners_file: ./data/Clarity/metadata/listeners.json\n")
    with pytest.raises(FileNotFoundError, match="listeners.json"):
        ClarityScorer(str(ha_yaml), input_sr=16000, device="cpu")


def test_clarity_scorer_matches_jax(tmp_path, rng):
    """16 kHz in, a 44.1 kHz chain (so the resample runs): the amplified
    signals within 1e-5 (tanh-clipped, |x| <= 1); the four scores, which a
    speech-like input (a harmonic source at a syllable-rate envelope over a
    broadband floor) puts well inside (0, 1), within 1e-4 of JAX's
    relatively (and so within 1e-3)."""
    scenes = ["S00001", "S00002"]
    port_yaml = make_ha_config(str(tmp_path / "port"), scenes=scenes, n_listeners=2, fs=44100)
    jax_yaml = jax_make_ha_config(str(tmp_path / "jax"), scenes=scenes, n_listeners=2,
                                  fs=44100)
    port = ClarityScorer(port_yaml, input_sr=16000, device="cpu")
    ref = JaxClarityScorer(jax_yaml, input_sr=16000)
    assert port.listeners == ref.listeners and port.scene_listeners == ref.scene_listeners
    t = np.arange(12000) / 16000
    phase = 2 * np.pi * np.cumsum(120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    clean = 0.1 * (voiced * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                   + 0.5 * rng.standard_normal(t.shape))
    clean = np.stack([clean, 0.9 * clean]).astype(np.float32)
    mixture = (clean + 0.01 * rng.standard_normal(clean.shape)).astype(np.float32)
    enhanced = (clean + 0.002 * rng.standard_normal(clean.shape)).astype(np.float32)
    listener = port.listeners_for_scene("S00002")[0]
    np.testing.assert_allclose(
        port.amplify_for_listener(port._resample(enhanced), listener).numpy(),
        ref.amplify_for_listener(ref._resample(enhanced), listener), rtol=0, atol=1e-5)
    got = port.score(clean, mixture, enhanced, "S00002_mix_CH1")
    want = ref.score(clean, mixture, enhanced, "S00002_mix_CH1")
    np.testing.assert_allclose(got["amplified"], want["amplified"], rtol=0, atol=1e-5)
    for key in ("haspi_enhance", "hasqi_enhance", "haspi_mixture", "hasqi_mixture"):
        assert got[key] is not None and 0.05 <= got[key] <= 0.95, (key, got[key])
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got[key], want[key])
    assert got["amplify_s"] > 0 and got["ear_model_s"] > 0
