"""The port's DilatedTCN vs the JAX package's, on the CPU (tests/zoo_parity.py's
checks), at 8 channels, hidden 16, three blocks of two repeats, stride 16
on a length no multiple of it (flax's "SAME" pads of the encoder and the
decoder). The reference has no TCN, so no importer: the round trip maps
the port's state_dict back by hand."""

import numpy as np
import pytest
import torch

from speech_enhancement_torch.compat import tcn_state_from_jax
from speech_enhancement_torch.models import tcn as port_tcn
from speech_enhancement_torch.ops.layers import same_pads, transpose_pads
from speech_enhancement_tpu.models import tcn as jax_tcn
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps)

FAMILY = Family(
    name="tcn", jax_cls=jax_tcn.DilatedTCN, port_cls=port_tcn.DilatedTCN,
    kwargs=dict(tcn_channels=8, tcn_hidden=16, tcn_kernel=3, tcn_blocks=3, tcn_repeats=2),
    to_port=lambda params, stats: tcn_state_from_jax(params), domain="wav", channels=1,
    samples=1000, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _by_hand(sd):
    """The port's keys onto the flax tree: Conv1d [out, in, k] -> [k, in, out],
    ConvTranspose1d [in, out, k] -> the flax kernel [k, in, out] unflipped,
    GroupNorm weight / bias -> scale / bias."""
    def conv(prefix):
        return {"kernel": sd[f"{prefix}.weight"].numpy().transpose(2, 1, 0),
                "bias": sd[f"{prefix}.bias"].numpy()}

    params = {"encoder": conv("encoder"),
              "decoder": {"kernel": sd["decoder.weight"].numpy()[:, :, ::-1].transpose(2, 0, 1),
                          "bias": sd["decoder.bias"].numpy()}}
    for r in range(2):
        for b in range(3):
            p = f"block_{r}_{b}"
            params[p] = {"dilated": conv(f"{p}.dilated"), "project": conv(f"{p}.project"),
                         "norm": {"scale": sd[f"{p}.norm.weight"].numpy(),
                                  "bias": sd[f"{p}.norm.bias"].numpy()}}
    return params


def test_tcn_weights_round_trip_by_hand():
    check_round_trip(FAMILY, _by_hand)


def test_flax_pads():
    """flax's "SAME" conv pads and lax.conv_transpose's pads."""
    assert same_pads(64000, 32, 16) == (8, 8)
    assert same_pads(1000, 32, 16) == (12, 12)
    assert same_pads(1001, 32, 16) == (11, 12)
    assert transpose_pads(32, 16, "SAME") == (23, 23)
    assert transpose_pads(3, 4, "SAME") == (2, 3)
    assert transpose_pads(8, 4, "VALID") == (7, 7)
    assert transpose_pads(2, 4, "VALID") == (1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tcn_eval_matches_jax(rng, dtype):
    check_eval(FAMILY, rng, dtype=dtype)


def test_tcn_train_forward_matches_jax(rng):
    check_train_forward(FAMILY, rng)


def test_tcn_two_train_steps_match_jax():
    check_two_train_steps(FAMILY)


def test_tcn_evaluate_utterance_matches_jax(rng):
    check_evaluate(FAMILY, rng, window=1000)


def test_tcn_odd_length_and_stride(rng):
    """Another stride and a length of no round size."""
    check_eval(FAMILY.variant(tcn_stride=8, tcn_kernel=5), np.random.default_rng(9))
