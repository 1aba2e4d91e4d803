"""The port's UNet and Wave-U-Net vs the JAX package's, on the CPU
(tests/zoo_parity.py's checks).

UNet at two layers (16, 32, 64 channels) over n_fft 128 frames, with
ConvTranspose and bilinear upsampling. Its dropout (0.5 in the deepest
Down block and the middle) is not a config key, so the parity runs hold
both sides at rate 0: the JAX model through a factory that builds its
DoubleConvs with ``dropout=0.0`` (the module itself unchanged), the port's
``nn.Dropout`` modules set to p 0; the dropout itself is checked by its
statistics. Wave-U-Net at three layers of 4-channel intervals on a length
no multiple of 2^3.
"""

import functools

import numpy as np
import pytest
import torch

from speech_enhancement_torch.compat import unet_state_from_jax, wav_unet_state_from_jax
from speech_enhancement_torch.models import unet as port_unet
from speech_enhancement_torch.models import wav_unet as port_wav_unet
from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.models import unet as jax_unet
from speech_enhancement_tpu.models import wav_unet as jax_wav_unet
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps)


def _jax_unet_without_dropout(**kwargs):
    """The JAX UNet whose DoubleConvs are built with dropout 0."""
    model = jax_unet.UNet(**kwargs)
    original = jax_unet._DoubleConv

    def double_conv(*args, **kw):
        return original(*args, **{**kw, "dropout": 0.0})

    class NoDropout(type(model)):
        def __call__(self, *args, **kw):
            jax_unet._DoubleConv = double_conv
            try:
                return super().__call__(*args, **kw)
            finally:
                jax_unet._DoubleConv = original

    return NoDropout(**kwargs)


class _PortUNetWithoutDropout(port_unet.UNet):
    SPEC = port_unet.UNet.SPEC

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        for module in self.modules():
            if isinstance(module, torch.nn.Dropout):
                module.p = 0.0


def _conv_bias_before_norm(key):
    return key.endswith(("main.0.bias", "middle.0.bias"))


UNET = Family(
    name="unet", jax_cls=jax_unet.UNet, port_cls=_PortUNetWithoutDropout,
    kwargs=dict(unet_layer=2), to_port=unet_state_from_jax, domain="stft", channels=1,
    samples=1504, seed=7, jax_factory=_jax_unet_without_dropout)
WAV_UNET = Family(
    name="wav-unet", jax_cls=jax_wav_unet.WavUNet, port_cls=port_wav_unet.WavUNet,
    kwargs=dict(unet_nlayers=3, channels_interval=4), to_port=wav_unet_state_from_jax,
    domain="wav", channels=1, samples=1001, seed=8, zero_grad=_conv_bias_before_norm)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_weights_round_trip_through_the_jax_importer(bilinear):
    fam = UNET.variant(bilinear=bilinear)
    check_round_trip(fam, functools.partial(jax_compat.unet_from_torch_state, unet_layer=2,
                                            bilinear=bilinear))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_eval_matches_jax(rng, bilinear, dtype):
    check_eval(UNET.variant(bilinear=bilinear), rng, dtype=dtype)


def test_unet_train_forward_updates_batch_norm_as_flax(rng):
    check_train_forward(UNET, rng)


def test_unet_two_train_steps_match_jax():
    check_two_train_steps(UNET)


def test_unet_evaluate_utterance_matches_jax(rng):
    check_evaluate(UNET, rng, window=1504)


def test_unet_dropout_by_its_statistics():
    """The shipped rate 0.5 in train(): about half of a DoubleConv's output
    zeroed and the rest doubled; eval() drops nothing."""
    torch.manual_seed(0)
    model = port_unet.UNet(unet_layer=2)
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(drops) == 2 and all(m.p == 0.5 for m in drops)
    model.train()
    x = torch.rand(4, 64, 32, 32) + 0.1
    y = model.middle.dropout(x)
    kept = y != 0
    assert 0.47 < kept.float().mean().item() < 0.53
    torch.testing.assert_close(y[kept], 2 * x[kept])
    spec = torch.randn(1, 1, 65, 40, 2)
    with torch.no_grad():
        assert not torch.equal(model(spec), model(spec))
        model.eval()
        assert torch.equal(model(spec), model(spec))


def test_wav_unet_weights_round_trip_through_the_jax_importer():
    check_round_trip(WAV_UNET, functools.partial(jax_compat.wav_unet_from_torch_state,
                                                 unet_nlayers=3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav_unet_eval_matches_jax(rng, dtype):
    check_eval(WAV_UNET, rng, dtype=dtype)


def test_wav_unet_train_forward_updates_batch_norm_as_flax(rng):
    check_train_forward(WAV_UNET, rng)


def test_wav_unet_two_train_steps_match_jax():
    check_two_train_steps(WAV_UNET)


def test_wav_unet_evaluate_utterance_matches_jax(rng):
    check_evaluate(WAV_UNET, rng, window=1024)


def test_linear_upsample_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32)
    want = np.asarray(jax_wav_unet._linear_upsample2(x.transpose(0, 2, 1))).transpose(0, 2, 1)
    got = torch.nn.functional.interpolate(torch.from_numpy(x), scale_factor=2, mode="linear",
                                          align_corners=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
