"""The port's DNN vs the JAX package's, on the CPU (tests/zoo_parity.py's
checks), at n_fft 128 with three Linear blocks of 64, with and without its
EMAs; dropout by its statistics."""

import pytest
import torch

from speech_enhancement_torch.compat import dnn_state_from_jax
from speech_enhancement_torch.models import dnn as port_dnn
from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.models import dnn as jax_dnn
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps)

FAMILY = Family(
    name="dnn", jax_cls=jax_dnn.DNN, port_cls=port_dnn.DNN,
    kwargs=dict(n_fft=128, n_layers=3, hidden_layer=64, drop_out=0.0),
    to_port=dnn_state_from_jax, domain="stft", channels=1, samples=2016, seed=3,
    # every Linear's bias is followed by BatchNorm: its true gradient is zero
    zero_grad=lambda key: key.endswith("model.0.bias"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dnn_weights_round_trip_through_the_jax_importer():
    check_round_trip(FAMILY, lambda sd: jax_compat.dnn_from_torch_state(sd, n_layers=3))


@pytest.mark.parametrize("options", [{}, {"dnn_method": "reconstruct", "activation": "tanh"},
                                     {"dnn_ema": False, "activation": "relu", "bias": False}])
def test_dnn_eval_matches_jax(rng, options):
    check_eval(FAMILY.variant(**options), rng)


def test_dnn_eval_matches_jax_in_bf16(rng):
    check_eval(FAMILY, rng, dtype="bfloat16")


def test_dnn_train_forward_updates_batch_norm_as_flax(rng):
    check_train_forward(FAMILY, rng)


def test_dnn_two_train_steps_match_jax():
    check_two_train_steps(FAMILY)


def test_dnn_evaluate_utterance_matches_jax(rng):
    check_evaluate(FAMILY, rng, window=2016)


def test_dnn_dropout_by_its_statistics():
    """drop_out 0.5 in train(): about half of each hidden activation is
    zeroed and the rest doubled; eval() drops nothing."""
    torch.manual_seed(0)
    model = port_dnn.DNN(n_fft=128, n_layers=2, hidden_layer=4096, drop_out=0.5, dnn_ema=False,
                         generator=torch.Generator().manual_seed(1))
    block = model.model[0].model
    x = torch.randn(64, 65)
    hidden = torch.nn.functional.leaky_relu(block[1](block[0](x)), 0.1)
    model.train()
    dropped = torch.nn.functional.dropout(hidden, 0.5, True)
    kept = dropped != 0
    assert 0.48 < kept.float().mean().item() < 0.52
    torch.testing.assert_close(dropped[kept], 2 * hidden[kept])
    spec = torch.randn(2, 1, 65, 30, 2)
    with torch.no_grad():
        a, b = model(spec), model(spec)
    assert not torch.equal(a, b)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(spec), model(spec))
