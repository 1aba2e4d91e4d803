"""The port's fused attention vs the JAX package's Pallas kernel, on the CPU.

``kernels/attention.py``: ``fused_mha`` / ``fused_mha_packed`` (the
autograd Function ``FusedMHA``; on CPU tensors the wrappers run the
kernels' plain versions) against the JAX ``fused_mha`` /
``fused_mha_packed`` in interpret mode: outputs and the gradients of q, k
and v, in f32 and bf16, at a ragged length (L 50, D 16), at Sepformer's
inter-chunk length (L 66, D 32) and with an explicit scale. Inputs are
numpy-made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas import attention as jax_attention
from speech_enhancement_torch.kernels import attention as port_attention

# tests/test_pallas.py:194-223: forward atol 1e-5, rtol 1e-5; gradients
# atol 1e-5, rtol 1e-4. bf16: both sides compute in f32 from the same bf16
# inputs and round once, but sum in other orders, so a value may land one
# bf16 step (2^-8 relative) apart: rtol 2^-7 with atol 2^-9 near zero.
F32_FWD, F32_GRAD = (1e-5, 1e-5), (1e-5, 1e-4)
BF16 = (2.0**-9, 2.0**-7)

CASES = [  # (B, H, L, D, scale)
    (2, 3, 50, 16, 0.0),  # tests/test_pallas.py's shape: L and D off every tile
    (2, 2, 66, 32, 0.0),  # Sepformer's inter-chunk length and head depth
    (1, 2, 50, 8, 0.3),   # the small Sepformer's depth, an explicit scale
]


def _inputs(b, h, l, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(3)]


def _to(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)


def _jax_loss(q, k, v, scale):
    out = jax_attention.fused_mha(q, k, v, scale, True)
    return jnp.sum(jnp.sin(out.astype(jnp.float32))), out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,l,d,scale", CASES)
def test_fused_mha_and_gradients_match_jax(b, h, l, d, scale, dtype):
    jdt, tdt = _to(dtype)
    arrays = _inputs(b, h, l, d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    (_, want), grads = jax.value_and_grad(_jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv, scale)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays)
    got = port_attention.fused_mha(tq, tk, tv, scale)
    torch.sin(got.float()).sum().backward()
    assert got.dtype == tdt and tq.grad.dtype == tdt
    fwd, grad = (F32_FWD, F32_GRAD) if dtype == "float32" else (BF16, BF16)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=fwd[0], rtol=fwd[1])
    for name, t, j in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(j, np.float32),
                                   atol=grad[0], rtol=grad[1], err_msg=name)


@pytest.mark.parametrize("b,h,l,d,scale", CASES[:2])
def test_packed_functions_match_the_jax_kernel_calls(b, h, l, d, scale):
    """The packed plain versions against ``_mha_fwd_call`` / ``_mha_bwd_call``
    in interpret mode, with a random output cotangent."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((b, h * d, l)).astype(np.float32) for _ in range(4))
    jscale = scale or 1.0 / np.sqrt(d)
    want = jax_attention._mha_fwd_call(*(jnp.asarray(a) for a in (q, k, v)), h, jscale, True)
    want_grads = jax_attention._mha_bwd_call(*(jnp.asarray(a) for a in (q, k, v, g)), h,
                                             jscale, True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = port_attention.mha_fwd(tq, tk, tv, h, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the [B, H, L, D] plain adapter against the JAX adapter
    unpack = [np.ascontiguousarray(a.reshape(b, h, d, l).transpose(0, 1, 3, 2))
              for a in (q, k, v)]
    np.testing.assert_allclose(
        port_attention.fused_mha_plain(*(torch.from_numpy(a) for a in unpack), scale).numpy(),
        np.asarray(jax_attention.fused_mha(*(jnp.asarray(a) for a in unpack), scale, True)),
        atol=1e-5, rtol=1e-5)
    for got_g, want_g in zip(port_attention.mha_bwd(tq, tk, tv, tg, h, scale), want_grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-4)
    # the Function's gradients are the backward's, whatever the cotangent's layout
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port_attention.fused_mha_packed(tq, tk, tv, h, scale)
    out.backward(tg.transpose(1, 2).contiguous().transpose(1, 2))
    for t, want_g in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-4)


def test_wrappers_run_the_plain_versions_on_cpu_and_check_their_inputs():
    q = torch.zeros(2, 12, 5)
    before = (port_attention.mha_fwd.launches, port_attention.mha_bwd.launches)
    out = port_attention.mha_fwd(q, q, q, 3)
    grads = port_attention.mha_bwd(q, q, q, q, 3)
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads)
    assert (port_attention.mha_fwd.launches, port_attention.mha_bwd.launches) == before
    with pytest.raises(ValueError, match="packed"):
        port_attention.mha_fwd(q, q, q, 5)  # 12 channels are not 5 heads
    with pytest.raises(ValueError, match="shapes differ"):
        port_attention.mha_fwd(q, q, torch.zeros(2, 12, 6), 3)
    meta = torch.zeros(2, 12, 5, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attention.mha_fwd(meta, meta, meta, 3)
