"""The port's STFT and mask-E kernels: plain versions vs the JAX Pallas kernels.

On the CPU the Pallas kernels run in interpret mode and the port's wrappers
run their plain PyTorch versions (a CPU tensor selects them). The CUDA
kernels themselves build and run only on a card: tests/test_torch_cuda.py
holds them against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models.dccrn import _stft_bases
from speech_enhancement_tpu.ops.pallas.masking import apply_mask_e
from speech_enhancement_tpu.ops.pallas.stft import stft_pallas
from speech_enhancement_tpu.ops.stft import _rfft_basis, hann_window
from speech_enhancement_torch.kernels import _build
from speech_enhancement_torch.kernels.masking import mask_e_kernel, mask_e_plain
from speech_enhancement_torch.kernels.stft import stft_kernel, stft_plain


def _basis(win, fft):
    if win == 400:  # DCCRN: window folded into the ConvSTFT basis
        return _stft_bases(win, fft)[0]
    br, bi = _rfft_basis(fft)  # ops/stft.py geometry
    return (np.concatenate([br, bi], axis=1) * np.asarray(hann_window(win))[:, None]
            ).astype(np.float32)


@pytest.mark.parametrize("win,hop,fft,total", [
    (400, 100, 512, 16600),   # DCCRN geometry: 163 frames
    (512, 128, 512, 32000),   # ops/stft.py geometry: 247 frames
    (400, 100, 512, 7000),    # 67 frames, not a multiple of 128
])
def test_stft_plain_matches_pallas(rng, win, hop, fft, total):
    basis = _basis(win, fft)
    x = rng.standard_normal((2, total)).astype(np.float32) * 0.3
    want = np.asarray(stft_pallas(jnp.asarray(x), basis, hop, win, interpret=True))
    got = stft_plain(torch.from_numpy(x), torch.from_numpy(basis), hop, win).numpy()
    assert got.shape == want.shape == (2, (total - win) // hop + 1, basis.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)  # tests/test_pallas.py:22


def test_mask_e_plain_matches_pallas(rng):
    xr, xi, mr, mi = (rng.standard_normal((2, 257, 130)).astype(np.float32) for _ in range(4))
    want = apply_mask_e(*(jnp.asarray(a) for a in (xr, xi, mr, mi)), interpret=True)
    got = mask_e_plain(*(torch.from_numpy(a) for a in (xr, xi, mr, mi)))
    for g, w in zip(got, want):
        # same f32 formula, elementwise; |out| up to ~10
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)


def test_wrappers_take_plain_version_on_cpu_without_counting(rng):
    x = torch.from_numpy(rng.standard_normal((1, 2000)).astype(np.float32))
    basis = torch.from_numpy(_stft_bases(400, 512)[0])
    arrays = [torch.from_numpy(rng.standard_normal((1, 257, 9)).astype(np.float32))
              for _ in range(4)]
    before = (stft_kernel.launches, mask_e_kernel.launches)
    torch.testing.assert_close(stft_kernel(x, basis, 100, 400), stft_plain(x, basis, 100, 400))
    for g, w in zip(mask_e_kernel(*arrays), mask_e_plain(*arrays)):
        torch.testing.assert_close(g, w)
    assert (stft_kernel.launches, mask_e_kernel.launches) == before


def test_wrappers_reject_bad_inputs():
    basis = torch.zeros(400, 514)
    with pytest.raises(ValueError):
        stft_kernel(torch.zeros(2, 1000), torch.zeros(300, 514), 100, 400)  # basis rows
    with pytest.raises(ValueError):
        stft_kernel(torch.zeros(2, 300), basis, 100, 400)  # shorter than a frame
    with pytest.raises(ValueError):
        stft_kernel(torch.zeros(2, 1000, device="meta"), basis.to("meta"), 100, 400)
    with pytest.raises(ValueError):
        mask_e_kernel(*([torch.zeros(1, 3, 4)] * 3 + [torch.zeros(1, 3, 5)]))
    with pytest.raises(ValueError):
        mask_e_kernel(*([torch.zeros(1, 3, 4, device="meta")] * 4))


def test_build_lists_sources_and_hashes_them():
    srcs = _build.sources()
    assert set(srcs) == {"stft", "masking", "conv_block", "deconv_block", "conv_block_bwd",
                         "deconv_block_bwd", "lstm_fwd", "lstm_bwd", "attention_fwd",
                         "attention_bwd"}
    path = _build.library_path("stft")
    assert path.parent == _build.BUILD and path.suffix == ".so"
    assert path == _build.library_path("stft")  # stable for unchanged sources
    assert path != _build.library_path("masking")
    with pytest.raises(KeyError):
        _build.build(["no_such_kernel"])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    # no nvcc here: the build must raise, never fall back to the plain version
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
