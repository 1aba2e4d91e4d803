"""The port's Conv-TasNet vs the JAX package's, on the CPU (tests/zoo_parity.py's
checks), stereo with two speakers at N 16, L 8, B 8, H 16, three blocks of
two repeats; gLN and cLN, causal pads, the skip path and the softmax mask;
si-sdr with PIT in the train steps."""

import functools

import pytest
import torch

from speech_enhancement_torch.compat import conv_tasnet_state_from_jax
from speech_enhancement_torch.models import conv_tasnet as port_tasnet
from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.models import conv_tasnet as jax_tasnet
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps)

FAMILY = Family(
    name="conv-tasnet", jax_cls=jax_tasnet.ConvTasNet, port_cls=port_tasnet.ConvTasNet,
    kwargs=dict(sources=("target", "interferer"), N=16, L=8, B=8, H=16, P=3, X=3, R=2,
                audio_channels=2),
    to_port=lambda params, stats: conv_tasnet_state_from_jax(params), domain="wav",
    channels=2, samples=1000, loss="si-sdr", pit=True, n_src=2, seed=13)
VARIANTS = [{"norm_type": "cLN"}, {"causal": True}, {"skip": True},
            {"mask_nonlinear": "softmax", "norm_type": "cLN", "causal": True, "skip": True}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("skip", [False, True])
def test_conv_tasnet_weights_round_trip_through_the_jax_importer(skip):
    check_round_trip(FAMILY.variant(skip=skip), functools.partial(
        jax_compat.conv_tasnet_from_torch_state, R=2, X=3, skip=skip))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_tasnet_eval_matches_jax(rng, dtype):
    check_eval(FAMILY, rng, dtype=dtype)


@pytest.mark.parametrize("options", VARIANTS)
def test_conv_tasnet_options_match_jax(rng, options):
    check_eval(FAMILY.variant(**options), rng)


def test_conv_tasnet_train_forward_matches_jax(rng):
    check_train_forward(FAMILY, rng)


def test_conv_tasnet_two_pit_train_steps_match_jax():
    check_two_train_steps(FAMILY)


def test_conv_tasnet_evaluate_utterance_matches_jax(rng):
    check_evaluate(FAMILY, rng, window=1000)
