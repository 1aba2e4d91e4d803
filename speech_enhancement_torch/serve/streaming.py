"""Streaming DCCRN and CRN: chunked real-time enhancement with carried state
(counterpart of speech_enhancement_tpu/serve/streaming.py).

A streamer wraps a built model (``models.build_model``), runs on its
device and takes its weights as they are; every step is fixed-shape and
runs under ``torch.no_grad()``.

DCCRN is causal in its encoder (time kernel 2, causal pad) and recurrent
bottleneck, but each decoder deconv has a one-frame lookahead (the time
chomp ``[1:]``). A DCCRN stream therefore carries:

* ``wav_tail``      the last ``win - hop`` input samples (ConvSTFT framing
                    history; zeros at the start = the offline left pad);
* ``enc_cache[i]``  one input frame per encoder conv (the causal pad);
* ``lstm[j]``       the complex-LSTM (h, c) carries, [2B, H] each;
* ``dec_cache[i]``  one input frame per decoder deconv: with the previous
                    input frame prepended and the transposed conv sliced
                    ``[1:-1]``, a chunk's outputs are the offline frames one
                    earlier, so the lookahead becomes a one-frame delay;
* ``skip_buf[i]``   an ``i``-frame FIFO per decoder skip join, so the
                    undelayed encoder skip meets the decoder trunk, delayed
                    ``i`` frames by the layers below;
* ``spec_buf``      the last ``n_layers`` input-spectrum frames, so the mask
                    (delayed ``n_layers`` frames) multiplies the frame it was
                    computed for;
* ``ola_tail``      the incomplete ``win - hop`` samples of the inverse
                    overlap-add.

Its algorithmic latency is ``n_layers * hop + (win - hop)`` samples: 900 =
56.25 ms at 16 kHz for configs/dccrn_vbd.yaml (6 layers, win 400, hop 100).
The first ``latency`` output samples are warmup (the leading
``n_layers * hop`` exactly zero); after them ``stream_out[latency + n]``
equals ``offline_out[n]`` to float tolerance, except over the final
``latency`` samples of a finished utterance, where the offline forward
sees zero future activations and a stream sees zero-padded input. The
stream divides by the periodic squared-window envelope, which needs
``win % hop == 0``.

On a CUDA model the chunk's STFT goes through ``kernels/stft.py:
stft_kernel`` (``use_stft_kernel``) and mask E through ``DCCRN.apply_mask``
(``use_mask_kernel``), one launch each a chunk; the encoder and decoder
run the unfused blocks in stream mode whatever ``use_fused_blocks`` says
(the fused block kernels build the causal pad in).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_enhancement_torch.device import module_device
from speech_enhancement_torch.kernels.stft import stft_kernel
from speech_enhancement_torch.models.crn import _DEC_CHANNELS, _ENC_CHANNELS, CRN
from speech_enhancement_torch.models.dccrn import DCCRN, _split
from speech_enhancement_torch.ops.complex_conv import complex_cat
from speech_enhancement_torch.ops.frame import frame_signal, overlap_add
from speech_enhancement_torch.ops.stft import _hann_np, _irfft_basis, _window_basis


def _periodic_envelope(window: np.ndarray, hop: int) -> np.ndarray:
    """Steady-state squared-window overlap sum, one ``hop`` period."""
    k = window.shape[0] // hop
    return (window * window).reshape(k, hop).sum(axis=0).astype(np.float32)


def _enhance(streamer, wav: torch.Tensor, total: int, start: int,
             step: Optional[Callable] = None) -> torch.Tensor:
    """Stream [B, T] chunk by chunk over ``total`` padded samples and return
    the [B, T] output from sample ``start`` of the stream's. ``step``
    stands in for ``streamer.step`` (one that times each call, say)."""
    step = step or streamer.step
    wav = torch.as_tensor(wav, dtype=torch.float32, device=streamer.device)
    batch, length = wav.shape
    cs = streamer.chunk_samples
    n_chunks = -(-total // cs)
    padded = F.pad(wav, (0, n_chunks * cs - length))
    state = streamer.init_state(batch)
    outs = []
    for c in range(n_chunks):
        state, out = step(state, padded[:, c * cs:(c + 1) * cs])
        outs.append(out)
    return torch.cat(outs, dim=-1)[:, start:start + length]


class DCCRNStreamer:
    """Stateful chunked inference over a built DCCRN.

    ``model``: a :class:`models.dccrn.DCCRN` with ``use_clstm=True`` and
    ``win_len % win_inc == 0`` (the shipped configs), in eval mode; the
    streamer runs on its device with its weights. ``chunk_frames``: STFT
    frames a step, so a chunk is ``chunk_frames * win_inc`` samples (16
    frames = 1600 samples = 100 ms at 16 kHz); at least ``len(kernel_num)``
    so every skip FIFO fits inside one chunk.
    """

    def __init__(self, model: DCCRN, chunk_frames: int = 16):
        n_layers = len(model.encoder)
        if not model.use_clstm:
            raise ValueError("DCCRNStreamer requires use_clstm=True")
        if model.win_len % model.win_inc != 0:
            raise ValueError("win_len must be a multiple of win_inc")
        if chunk_frames < n_layers:
            raise ValueError(f"chunk_frames must be >= n_layers ({n_layers})")
        self.model = model.eval()
        self.device = module_device(model)
        self.K = int(chunk_frames)
        self.hop = int(model.win_inc)
        self.win = int(model.win_len)
        self.pad = self.win - self.hop
        self.n_layers = n_layers
        #: the stream's output is late by this many samples: the first
        #: ``latency`` are warmup, which ``enhance()`` discards
        self.latency = self.n_layers * self.hop + self.pad
        #: samples consumed and emitted by each step()
        self.chunk_samples = self.K * self.hop
        self.n_freq = model.fft_len // 2 + 1
        window = model.stft_window.cpu().numpy()
        env = np.tile(_periodic_envelope(window, self.hop), self.K)
        self._env = torch.from_numpy(env).to(self.device)  # [K * hop]
        # frequency rows into each encoder conv (DC bin dropped), and out of the last
        f = model.fft_len // 2
        self._enc_f = []
        for _ in range(n_layers):
            self._enc_f.append(f)
            f = (f - 1) // 2 + 1
        self._bottleneck_f = f

    def init_state(self, batch: int) -> Dict[str, Any]:
        """Zero stream state for ``batch`` parallel streams (fixed shapes)."""
        m, dev = self.model, self.device
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        # stacked (r, i) channel counts: the input's, then each encoder block's
        widths = [2] + [2 * block[0].real_conv.bias.numel() for block in m.encoder]
        enc_cache = [zeros(batch, widths[i], self._enc_f[i], 1) for i in range(self.n_layers)]
        dec_cache, skip_buf = [], []
        f, c2x = self._bottleneck_f, widths[-1]
        for i, block in enumerate(m.decoder):
            c2s = widths[self.n_layers - i]
            dec_cache.append(zeros(batch, c2x + c2s, f, 1))
            skip_buf.append(zeros(batch, c2s, f, i))
            c2x = 2 * block[0].real_conv.bias.numel()
            f *= 2
        cd = m.compute_dtype
        lstm = []
        for layer in m.enhance:  # (h, c) of the real and the imaginary LSTM
            hidden = layer.real_lstm.hidden_size
            lstm.append(tuple(tuple(zeros(2 * batch, hidden, dtype=cd) for _ in range(2))
                              for _ in range(2)))
        return {
            "wav_tail": zeros(batch, self.pad),
            "enc_cache": enc_cache,
            "lstm": lstm,
            "dec_cache": dec_cache,
            "skip_buf": skip_buf,
            "spec_buf": zeros(batch, 2 * self.n_freq, self.n_layers),
            "ola_tail": zeros(batch, self.pad),
        }

    @torch.no_grad()
    def step(self, state: Dict[str, Any], chunk: torch.Tensor):
        """Consume ``chunk`` [B, chunk_samples]; return (new state, the same
        number of enhanced samples, late by ``latency``)."""
        m = self.model
        K, hop, win, n_freq = self.K, self.hop, self.win, self.n_freq
        batch = chunk.shape[0]
        new: Dict[str, Any] = {}

        # ConvSTFT over [tail | chunk] with no pad: the offline frame indices
        x = torch.cat([state["wav_tail"], chunk.float()], dim=-1)
        new["wav_tail"] = x[:, -self.pad:]
        if m.use_stft_kernel:
            spec = stft_kernel(x, m.stft_fwd, hop, win)  # [B, K, 2F]
        else:
            spec = torch.matmul(frame_signal(x, win, hop), m.stft_fwd)
        spec = spec.transpose(1, 2)  # [B, 2F, K]

        # encoder: the cached previous frame takes the causal pad's place
        x2 = torch.stack([spec[:, 1:n_freq], spec[:, n_freq + 1:]], dim=1)  # [B, 2, F, K]
        new["enc_cache"], skips = [], []
        for cache, block in zip(state["enc_cache"], m.encoder):
            xin = torch.cat([cache, x2.to(cache.dtype)], dim=-1)
            new["enc_cache"].append(xin[..., -1:])
            x2 = block(xin, time_mode="stream")
            skips.append(x2)

        # complex LSTM bottleneck with carried state
        xr, xi = _split(x2)
        channels, dims = xr.shape[1], xr.shape[2]
        r_in = xr.permute(0, 3, 1, 2).reshape(batch, K, channels * dims)
        i_in = xi.permute(0, 3, 1, 2).reshape(batch, K, channels * dims)
        new["lstm"] = []
        for carry, layer in zip(state["lstm"], m.enhance):
            (r_in, i_in), carry = layer(r_in, i_in, init_state=carry, return_state=True)
            new["lstm"].append(carry)
        xr = r_in.reshape(batch, K, channels, dims).permute(0, 2, 3, 1)
        xi = i_in.reshape(batch, K, channels, dims).permute(0, 2, 3, 1)
        x2 = torch.cat([xr, xi], dim=1)

        # decoder: delay-line deconvs and the skip FIFOs
        new["dec_cache"], new["skip_buf"] = [], []
        for i, block in enumerate(m.decoder):
            sb = torch.cat([state["skip_buf"][i], skips[self.n_layers - 1 - i]], dim=-1)
            new["skip_buf"].append(sb[..., K:])
            joined = complex_cat(x2, sb[..., :K])
            xin = torch.cat([state["dec_cache"][i], joined.to(state["dec_cache"][i].dtype)],
                            dim=-1)
            new["dec_cache"].append(xin[..., -1:])
            x2 = block.deconv(xin, time_mode="stream")

        # mask head on the input spectrum delayed n_layers frames
        x2 = x2.float()
        mask_real = F.pad(x2[:, 0], (0, 0, 1, 0))
        mask_imag = F.pad(x2[:, 1], (0, 0, 1, 0))
        sb = torch.cat([state["spec_buf"], spec], dim=-1)
        new["spec_buf"] = sb[..., K:]
        out_spec = m.apply_mask(sb[:, :n_freq, :K].contiguous(), sb[:, n_freq:, :K].contiguous(),
                                mask_real, mask_imag)  # [B, 2F, K]

        # streaming ConviSTFT: OLA with the carried tail, periodic envelope
        ola = overlap_add(torch.matmul(out_spec.transpose(1, 2), m.stft_inv), hop)
        ola = torch.cat([ola[:, :self.pad] + state["ola_tail"], ola[:, self.pad:]], dim=-1)
        new["ola_tail"] = ola[:, K * hop:]
        out = ola[:, :K * hop] / (self._env + 1e-8)
        return new, torch.clamp(out, -1.0, 1.0)

    def enhance(self, wav: torch.Tensor, step: Optional[Callable] = None) -> torch.Tensor:
        """Stream a whole [B, T] utterance chunk by chunk and return the
        latency-compensated [B, T] (equal to the offline forward but for the
        final ``latency`` samples). ``step`` stands in for ``self.step``."""
        length = wav.shape[-1]
        return _enhance(self, wav, length + self.latency, self.latency, step)


class CRNStreamer:
    """Stateful chunked inference over a built CRN.

    CRN is fully causal (conv encoder with a causal time pad, two
    unidirectional LSTMs, a transposed-conv decoder whose chomp drops the
    trailing step), so the stream carries only ``wav_tail`` (the last
    ``n_fft - hop`` input samples), ``enc_cache`` and ``dec_cache`` (one
    input frame per conv), ``lstm`` (the two layers' (h, c)) and
    ``ola_tail``.

    The offline path frames a centred, reflect-padded STFT
    (``ops/stft.py:stft_custom``), so ``step()`` sends the first chunk of a
    fresh state to a priming step whose framing starts at offline frame 0
    with the reflected head; from there every frame, LSTM state and sample
    equals the offline forward's to float tolerance, with no warmup: the
    first step emits ``latency`` = ``win - hop`` fewer samples (384 = 24 ms
    at 16 kHz for configs/crn_vbd.yaml's 512 / 128). The final ``win``
    samples of a finished utterance differ, where the offline forward sees
    the right reflect pad.

    The LSTMs run through the model's ``lstm_layer`` with carried state, so
    with ``fused_rnn`` a CUDA chunk launches the LSTM forward kernel once a
    layer. The STFT is the model's (``n_fft``, ``hop_length``,
    ``win_length`` of its config), with ``ops/stft.py``'s bases.
    """

    def __init__(self, model: CRN, chunk_frames: int = 16):
        if not model.use_lstm:
            raise ValueError("CRNStreamer requires use_lstm=True")
        n_fft, hop, win_length = model.n_fft, model.hop_length, model.win_length
        if n_fft % hop != 0:
            raise ValueError("n_fft must be a multiple of hop (periodic OLA envelope)")
        self.model = model.eval()
        self.device = module_device(model)
        self.n_fft = self.win = n_fft    # frame length (the window padded to n_fft)
        self.hop = hop
        self.K = int(chunk_frames)
        self.pad = n_fft // 2            # centre pad (reflected head)
        self.tail = n_fft - hop          # framing history
        #: samples consumed by a step; the first step emits
        #: ``chunk_samples - latency``, later steps ``chunk_samples``
        self.chunk_samples = self.K * hop
        #: algorithmic latency in samples (n_fft - hop)
        self.latency = n_fft - hop
        if self.chunk_samples <= self.latency + hop:
            raise ValueError(f"chunk_frames too small for the {n_fft} / {hop} STFT")
        self.n_freq = n_fft // 2 + 1

        window = _hann_np(win_length, n_fft)
        # the model-boundary 1 / win_length scale is in the forward basis
        # (stft_custom) and multiplied back in the inverse (istft_custom)
        fwd = _window_basis(n_fft, win_length) / win_length  # [n_fft, 2F]
        inv = np.concatenate(_irfft_basis(n_fft), axis=0) * (window * win_length)  # [2F, n_fft]
        self._fwd = torch.from_numpy(fwd.astype(np.float32)).to(self.device)
        self._inv = torch.from_numpy(inv.astype(np.float32)).to(self.device)
        env = np.tile(_periodic_envelope(window, hop), self.K)
        self._env = torch.from_numpy(env).to(self.device)
        # the first step's envelope: the true (edge-short) squared-window OLA
        # over the emitted coordinates [0, chunk - latency)
        n_first = self.K - 1
        full = np.zeros((n_first - 1) * hop + n_fft)
        for t in range(n_first):
            full[t * hop:t * hop + n_fft] += window * window
        emitted = self.chunk_samples - self.latency
        self._env_first = torch.from_numpy(
            full[self.pad:self.pad + emitted].astype(np.float32)).to(self.device)

    def init_state(self, batch: int) -> Dict[str, Any]:
        """Zero stream state for ``batch`` parallel streams; ``"fresh"`` is a
        host flag that sends the next chunk to the priming step."""
        dev, cd = self.device, self.model.compute_dtype
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        enc_cache, f, c = [], self.n_freq, 1
        for feats in _ENC_CHANNELS:
            enc_cache.append(zeros(batch, c, f, 1))
            f, c = (f - 3) // 2 + 1, feats
        dec_cache = []
        for i, feats in enumerate(_DEC_CHANNELS):
            cs = _ENC_CHANNELS[len(_ENC_CHANNELS) - 1 - i]
            dec_cache.append(zeros(batch, c + cs, f, 1))
            f, c = (f - 1) * 2 + 3 + (1 if i == 3 else 0), feats
        hidden = self.model.lstm_layer.hidden_size
        lstm = [(zeros(batch, hidden, dtype=cd), zeros(batch, hidden, dtype=cd))
                for _ in range(self.model.lstm_layer.num_layers)]
        return {"wav_tail": zeros(batch, self.tail), "enc_cache": enc_cache, "lstm": lstm,
                "dec_cache": dec_cache, "ola_tail": zeros(batch, self.tail), "fresh": True}

    @torch.no_grad()
    def step(self, state: Dict[str, Any], chunk: torch.Tensor):
        """Consume ``chunk`` [B, chunk_samples]; return (new state, enhanced
        samples aligned to input sample 0; the first call emits ``latency``
        fewer)."""
        chunk = chunk.float()
        if state["fresh"]:
            # reflect the head as the offline centre=True framing does
            x = torch.cat([chunk[:, 1:self.pad + 1].flip(-1), chunk], dim=-1)
        else:
            x = torch.cat([state["wav_tail"], chunk], dim=-1)
        new = {"wav_tail": x[:, -self.tail:], "fresh": False}
        spec = torch.matmul(frame_signal(x, self.win, self.hop), self._fwd)  # [B, T', 2F]
        caches, masked = self._net(state, spec)
        new.update(caches)
        ola = overlap_add(torch.matmul(masked, self._inv), self.hop)
        ola = torch.cat([ola[:, :self.tail] + state["ola_tail"], ola[:, self.tail:]], dim=-1)
        if state["fresh"]:
            emit = self.chunk_samples - self.latency + self.pad
            out = ola[:, self.pad:emit] / (self._env_first + 1e-8)
        else:
            emit = self.chunk_samples
            out = ola[:, :emit] / (self._env + 1e-8)
        new["ola_tail"] = ola[:, emit:emit + self.tail]
        return new, torch.clamp(out, -1.0, 1.0)

    def _net(self, state: Dict[str, Any], spec: torch.Tensor):
        """The CRN body over the chunk's frames with carried state: (the new
        caches and LSTM state, the masked spectrum [B, T', 2F])."""
        m, n_freq = self.model, self.n_freq
        real = spec[..., :n_freq].transpose(1, 2)  # [B, F, T']
        imag = spec[..., n_freq:].transpose(1, 2)
        h = m.magnitude(torch.stack([real, imag], dim=-1)[:, None])  # [B, 1, F, T']
        enc_cache, skips = [], []
        for i, cache in enumerate(state["enc_cache"]):
            xin = torch.cat([cache, h.to(cache.dtype)], dim=-1)
            enc_cache.append(xin[..., -1:])
            h = getattr(m, f"conv_block_{i + 1}")(xin, time_mode="stream")
            skips.append(h)
        batch, n_chan, n_rows, n_frames = h.shape
        flat = h.permute(0, 3, 1, 2).reshape(batch, n_frames, n_chan * n_rows)
        flat, lstm = m.lstm_layer(flat, init_state=state["lstm"], return_state=True)
        d = flat.reshape(batch, n_frames, n_chan, n_rows).permute(0, 2, 3, 1)
        dec_cache = []
        for i, cache in enumerate(state["dec_cache"]):
            d = torch.cat([d.float(), skips[len(skips) - 1 - i]], dim=1)
            xin = torch.cat([cache, d.to(cache.dtype)], dim=-1)
            dec_cache.append(xin[..., -1:])
            d = getattr(m, f"tran_conv_block_{i + 1}")(xin, time_mode="stream")
        mask = d[:, 0].float()  # [B, F, T']
        masked = torch.cat([(mask * real).transpose(1, 2), (mask * imag).transpose(1, 2)], dim=-1)
        return {"enc_cache": enc_cache, "lstm": lstm, "dec_cache": dec_cache}, masked

    def enhance(self, wav: torch.Tensor, step: Optional[Callable] = None) -> torch.Tensor:
        """Stream a whole [B, T] utterance chunk by chunk; returns [B, T]
        aligned to the offline forward (its final ``win`` samples excepted).
        ``step`` stands in for ``self.step``."""
        length = wav.shape[-1]
        return _enhance(self, wav, length + self.latency + self.chunk_samples, 0, step)
