"""The port's DCUnet vs the JAX package's, on the CPU (tests/zoo_parity.py's
checks), at complexity 8 (5 and 10 channels on the complex path) over
n_fft 128 frames: depth 10 with masking modes E, C and R, the real path
(``data_type=False``), and depth 20."""

import functools

import pytest
import torch

from speech_enhancement_torch.compat import dcunet_state_from_jax
from speech_enhancement_torch.models import dcunet as port_dcunet
from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.models import dcunet as jax_dcunet
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps)

FAMILY = Family(
    name="dcunet", jax_cls=jax_dcunet.DCUnet, port_cls=port_dcunet.DCUnet,
    kwargs=dict(model_complexity=8), to_port=dcunet_state_from_jax, domain="stft",
    channels=1, samples=2016, seed=11,
    # every conv pair's bias is followed by a BatchNorm: its true gradient is zero
    zero_grad=lambda key: key.startswith(("encoder", "decoder")) and key.endswith(".bias")
    and ".bn." not in key)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dcunet_weights_round_trip_through_the_jax_importer():
    check_round_trip(FAMILY, functools.partial(jax_compat.dcunet_from_torch_state,
                                               model_depth=10))


@pytest.mark.parametrize("mode", ["E", "C", "R"])
def test_dcunet_eval_matches_jax(rng, mode):
    check_eval(FAMILY, rng, masking_mode=mode)


def test_dcunet_eval_matches_jax_in_bf16(rng):
    check_eval(FAMILY, rng, dtype="bfloat16")


def test_dcunet_real_path_matches_jax(rng):
    check_eval(FAMILY.variant(data_type=False, model_complexity=6), rng)


def test_dcunet_depth_20_matches_jax(rng):
    fam = FAMILY.variant(model_depth=20, model_complexity=6)
    check_eval(fam, rng)
    check_round_trip(fam, functools.partial(jax_compat.dcunet_from_torch_state,
                                            model_depth=20))


def test_dcunet_train_forward_updates_batch_norm_as_flax(rng):
    check_train_forward(FAMILY, rng)


def test_dcunet_two_train_steps_match_jax():
    check_two_train_steps(FAMILY)


def test_dcunet_evaluate_utterance_matches_jax(rng):
    check_evaluate(FAMILY, rng, window=2016)
