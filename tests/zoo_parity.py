"""Shared parity checks of the zoo's families against the JAX package, on the CPU.

Used by tests/test_torch_{dnn,unet,dcunet,tcn,conv_tasnet,demucs}.py. A
``Family`` names the JAX and port classes, a small configuration, the
weight converter and the JAX importer; the checks take the JAX model's
initial variables with biases, scales and BatchNorm statistics moved off
their initial values (numpy, from a seed), carry them into the port, and
hold:

* the weight round trip: the port's ``state_dict`` back through the JAX
  importer (or the test's own map) equals the JAX tree exactly;
* the eval forward: within ``F32`` of the output's peak in f32 and within
  ``BF16`` of it in bf16 (tests/test_torch_lstm.py's bf16 bound);
* the train-mode forward: within the JAX package's train-mode bounds
  (rtol 1e-3, atol 1e-4: batch statistics summed in another order), and
  the running statistics as flax moves them;
* two train steps through ``train_step`` against a jitted JAX step with
  the Solver's own loss: loss and grad norm within rtol 2e-3, each clipped
  gradient of the first step and each parameter after the second within
  2e-3 of its leaf's largest magnitude (the JAX package's fused-gradient
  bound, tests/test_dccrn_fused.py:97-113), the parameters plus 2 steps x
  2 lr (Adam moves an element by up to lr whatever its gradient's size).
  A gradient that is exactly zero in exact arithmetic (a conv bias that a
  norm follows) holds rounding residue on both sides and is held at the
  largest leaf's scale;
* ``evaluate_utterance`` on rows of two true lengths: rtol 1e-4 and the
  eval forward's ``F32`` of the peak.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.train import evaluate as port_eval
from speech_enhancement_torch.train.solver import get_optimizer, train_step
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.ops.stft import stft_custom as jax_stft_custom
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver

OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
F32 = 2e-4   # of the output's peak, f32
BF16 = 3e-2  # of the output's peak, bf16 (tests/test_torch_lstm.py)


def perturb(tree: Mapping, rng: np.random.Generator) -> Dict[str, Any]:
    """Numpy copy of a flax tree with biases, scales and statistics moved."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = perturb(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key in ("mean", "bias", "b_ih", "b_hh", "beta"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif key in ("scale", "gamma"):  # norms' scales, and Demucs's LayerScale
            a = rng.uniform(0.8, 1.2, a.shape)
        elif key == "alpha":
            a = rng.uniform(0.1, 0.4, a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


def flat(tree: Mapping) -> Dict[Any, np.ndarray]:
    return {path: np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_equal(got: Mapping, want: Mapping) -> None:
    got, want = flat(got), flat(want)
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@dataclasses.dataclass(eq=False)
class Family:
    """One family at a small size: ``jax_model(**kw)`` / ``port_model(**kw)``
    build it with ``kwargs`` updated by ``kw``; ``to_port(params, stats)``
    is the port's converter; ``domain`` "stft" or "wav"; the train step's
    batch is ``channels`` x ``samples`` with ``n_src`` sources."""

    name: str
    jax_cls: Any
    port_cls: Any
    kwargs: Dict[str, Any]
    to_port: Callable
    domain: str
    channels: int
    samples: int
    loss: str = "mse"
    pit: bool = False
    n_src: int = 1
    seed: int = 0
    jax_factory: Optional[Callable] = None  # builds the JAX model (default: jax_cls)
    zero_grad: Callable = staticmethod(lambda key: False)

    def jax_model(self, **kw):
        return (self.jax_factory or self.jax_cls)(**{**self.kwargs, **kw})

    def port_model(self, **kw):
        return self.port_cls(**{**self.kwargs, **kw})

    def wav(self, rng: np.random.Generator, batch: int, samples: Optional[int] = None):
        shape = (batch, self.channels, samples or self.samples)
        return (0.5 * rng.standard_normal(shape)).astype(np.float32)

    def inputs(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        wav = self.wav(rng, batch)
        if self.domain == "stft":
            return np.array(jax_stft_custom(jnp.asarray(wav), JaxConfig(STFT)))
        return wav

    @functools.cached_property
    def variables(self) -> Dict[str, Any]:
        x = jnp.asarray(self.inputs(np.random.default_rng(self.seed), 2))
        init = jax.jit(self.jax_model().init)(
            {"params": jax.random.PRNGKey(self.seed), "dropout": jax.random.PRNGKey(1)}, x)
        rng = np.random.default_rng(self.seed + 100)
        return {k: perturb(v, rng) for k, v in init.items()}

    @property
    def stats(self) -> Mapping:
        return self.variables.get("batch_stats", {})

    def variant(self, **kw) -> "Family":
        """The same family with ``kwargs`` updated (its own initial weights)."""
        return dataclasses.replace(self, kwargs={**self.kwargs, **kw})

    def pair(self, **kw):
        """(JAX model, port model in eval mode) with the perturbed weights."""
        port = self.port_model(**kw)
        port.load_state_dict(self.to_port(self.variables["params"], self.stats))
        return self.jax_model(**kw), port.eval()


def check_round_trip(fam: Family, importer: Callable) -> None:
    """The port's state_dict back through ``importer`` equals the JAX tree."""
    _, port = fam.pair()
    got = importer(port.state_dict())
    params, stats = got if isinstance(got, tuple) else (got, {})
    assert_trees_equal(params, fam.variables["params"])
    assert_trees_equal(stats, fam.stats)


def check_eval(fam: Family, rng: np.random.Generator, dtype: str = "float32", **kw) -> None:
    jax_model, port = fam.pair(dtype=dtype, **kw)
    x = fam.inputs(rng, 2)
    want = np.asarray(jax.jit(jax_model.apply)(fam.variables, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def check_train_forward(fam: Family, rng: np.random.Generator) -> None:
    jax_model, port = fam.pair()
    x = fam.inputs(rng, 2)
    apply = jax.jit(functools.partial(jax_model.apply, train=True, mutable=["batch_stats"]))
    want, updated = apply(fam.variables, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(2)})
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    state = fam.to_port(fam.variables["params"], updated.get("batch_stats", {}))
    before = fam.to_port(fam.variables["params"], fam.stats)
    moved = 0
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), state[key].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=key)
            moved += not np.allclose(value.numpy(), before[key].numpy())
    assert moved or not fam.stats


@functools.lru_cache(maxsize=None)
def _jax_step(fam: Family):
    model = fam.jax_model()
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    solver = types.SimpleNamespace(use_pit=fam.pit, loss_name=fam.loss, pit_discard_compat=False,
                                   loss_fn=jax_losses.get_loss_function(fam.loss))
    monarch = fam.jax_cls.SPEC.monarch

    @jax.jit
    def step(params, stats, opt_state, mixture, sources):
        target = sources[:, 0] if monarch else sources  # the Solver's _adapt
        inputs = mixture
        if fam.domain == "stft":
            inputs = jax_stft_custom(mixture, JaxConfig(STFT))
            target = jax_stft_custom(target, JaxConfig(STFT))

        def loss_of(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats}, inputs, train=True,
                                       mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(3)})
            return (jax_solver.Solver._compute_loss(solver, out, target, inputs),
                    mutated.get("batch_stats", {}))

        (loss, new_stats), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        clipped, _ = optax.clip_by_global_norm(OPTIM["clip_grad"]).update(grads, None)
        return (optax.apply_updates(params, updates), new_stats, opt_state, loss,
                optax.global_norm(grads), clipped)

    return optimizer, step


def assert_leaves_close(fam: Family, got: Mapping, want: Mapping, extra: float = 0.0) -> None:
    assert sorted(got) == sorted(want)
    scale = max(v.abs().max().item() for v in want.values())
    for key, value in want.items():
        err = (got[key].float() - value).abs().max().item()
        leaf = scale if fam.zero_grad(key) else max(value.abs().max().item(), 1e-8)
        bound = 2e-3 * leaf + extra
        assert err <= bound, (key, err, bound)


def check_two_train_steps(fam: Family) -> None:
    rng = np.random.default_rng(fam.seed + 41)
    sources = fam.wav(rng, 2 * fam.n_src).reshape(2, fam.n_src, fam.channels, fam.samples)
    mixture = (sources.sum(axis=1) + 0.05 * fam.wav(rng, 2)).astype(np.float32)
    optimizer, step = _jax_step(fam)
    params, stats = fam.variables["params"], fam.stats
    opt_state = optimizer.init(params)
    _, port = fam.pair()
    opt = get_optimizer(Config(OPTIM), port.parameters())
    model_config = Config(STFT) if fam.domain == "stft" else None
    for i in range(2):
        params, stats, opt_state, want_loss, want_norm, grads = step(
            params, stats, opt_state, jnp.asarray(mixture), jnp.asarray(sources))
        got_loss, got_norm = train_step(port, port.SPEC, opt, mixture, sources, fam.loss,
                                        use_pit=fam.pit, device="cpu", model_config=model_config)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-3)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=2e-3)
        if i == 0:
            got = {k: p.grad for k, p in port.named_parameters()}
            want = fam.to_port(grads, stats)
            assert_leaves_close(fam, got, {k: want[k] for k in got})
    assert port.training
    assert_leaves_close(fam, port.state_dict(), fam.to_port(params, stats),
                        extra=2 * 2 * OPTIM["lr"])


def check_evaluate(fam: Family, rng: np.random.Generator, window: int) -> None:
    """Windows of ``window`` samples at stride 128 over rows of two lengths."""
    jax_model, port = fam.pair()
    raw = {"model": {"name": fam.name, "segment": window / 16000, "sample_rate": 16000,
                     **STFT},
           "dset": {"sample_rate": 16000, "norm": "z-score", "audio_channels": fam.channels}}
    port_cfg, jax_cfg = with_defaults(Config(raw)), jax_with_defaults(JaxConfig(raw))
    length = 2 * window + 300
    wav = fam.wav(rng, 2, length)
    lengths = [length, length - 400]
    want = jax_eval.evaluate_utterance(wav, jax_model.apply, fam.variables, fam.jax_cls.SPEC,
                                       jax_cfg, lengths=lengths)
    got = port_eval.evaluate_utterance(wav, port, port.SPEC, port_cfg, lengths=lengths,
                                       device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=F32 * np.abs(want).max())
