#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``speech_enhancement_torch/kernels/
csrc``, holds each against its plain PyTorch version at the shapes of the
serving and training paths (the two block kernels and their four backward
kernels at all twelve blocks of DCCRN; the LSTM recurrence forward at CRN's
serving and training shapes and at rnn-stft-mask's in both directions, its
backward at CRN's training shape, and a small f32 case with an initial
state; the STFT, the LSTM backward at CRN's shape and both LSTM kernels at
every f32 case (the split-f32 designs) are also timed on their first
designs in the same run, beside their bounds and library calls: ``torch.matmul``
and cuFFT for the STFT, cuDNN's forward + backward and its backward alone
for the LSTM), then serves three 10 s requests with DCCRN at the full width of
``configs/dccrn_vbd.yaml`` (bf16, random weights from a seeded
``torch.Generator``) through ``train/evaluate.py:evaluate_utterance``,
twice: with the default unfused encoder/decoder, which goes through the
STFT and mask-E kernels, and with ``model.use_fused_blocks = True``, which
goes through the four forward kernels; it checks the launches of each run
and that the two agree. Then it trains the same model at ``bench.py``'s
operating point (B = 128, 4 s, MSE, Adam 3e-4, clip 5, int16 wire) through
``train/solver.py:train_step``, three steps with ``use_fused_blocks = True``
(all eight block and DCCRN kernels) and three on the unfused ``cbn_fold =
True`` path, and holds the two first steps against each other. Then CRN at
the full width of ``configs/crn_vbd.yaml`` (bf16, ``fused_rnn``): three 10 s
requests (two LSTM forward launches each) and three train steps at the
config's operating point (B = 16 x 4 s; two forward and two backward
launches each, the backward's share of a step from the profiler), each
held against the same weights on the plain loop (``fused_rnn = False``),
and a small f32 CRN on the card against the CPU
path; and rnn-stft-mask at the full width of
``configs/rnn_stft_mask_clarity.yaml`` serving three stereo 10 s requests
(six forward launches each, three of them reversed). Then Sepformer: both
attention kernels against their plain versions at its intra (L 250) and
inter (L 66) shapes and timed at the full serving and training batches
beside ``F.scaled_dot_product_attention``, a small f32 Sepformer on the
card against the CPU path, three stereo 10 s requests at the full width of
``configs/sepformer_clarity.yaml`` (bf16, 32 forward attention launches
each) and three train steps at its operating point (B = 4 x 4 s, two
speakers, si-sdr with PIT; 32 forward and 32 backward launches each), each
held against the same weights on flax's attention (``fused_attention =
False``); the serving split also times the copies around one intra and one
inter attention layer (the wrapper's ``.contiguous()`` of q, k and v, the
transposed output), and the build's report gives every attention kernel
variant's registers and spills. Then the recurrent slice: mel-rnn at the
full width of ``configs/mel_rnn_vbd.yaml`` (f32, ``fused_rnn``) serving
three 10 s requests against the plain loop within F32_ATOL, served once
each with GRU and vanilla-RNN stacks, and three train steps at B 16 held
against the plain loop (``mel_rnn_phase``); rnn-stft-mask training at its
config's operating point (B 8 stereo, two speakers, PIT), with drop_out 0
against the plain loop and with the config's drop_out 0.5
(``rnn_stft_mask_train_phase``); Sepformer train steps with RelPosMHAXL,
with RNN intra / inter blocks and with remat against remat off
(``sepformer_options_phase``); DCCRN with ``use_clstm = False`` served and
trained on both execution paths and a small f32 one on the card against
the CPU (``dccrn_real_lstm_phase``); the LSTM kernel phase holds both
kernels at those paths' shapes too (mel-rnn's f32 H 256 and rnn-stft-mask
training's bf16 H 896 at B 16, both directions). Then streaming serving
(``stream_phase``, serve/streaming.py): the STFT and LSTM forward kernels
at the stream's shapes against their plain versions, DCCRN and CRN at
full width (bf16; CRN with ``fused_rnn``) streaming 10 s requests in
16-frame chunks at B 1 and B 64, each held to its offline forward over
the interior (the small f32 models within 2e-4 of the peak), with each
step's ms, the RTF, the device-busy share of a step, the peak memory and
the launches a chunk (DCCRN: STFT and mask E once; CRN: LSTM forward
twice); and the Clarity hearing-aid chain (``ha_phase``, ha/):
``ClarityScorer`` on the card against the CPU for two 4 s utterances,
timed by its card chain and its host ear model. Last, the ``cli`` phase
runs the system's own entry point, ``speech_enhancement_torch.main.main``,
on synthetic data: DCCRN at full width trains two epochs, checkpoints, is
resumed and scores a test set (SI-SDR, STOI, PESQ), mel-rnn trains two
epochs and tests resumed, Sepformer trains on Clarity scenes and
``--mode test`` writes the hearing-aid columns (HASPI / HASQI), and
``python -m speech_enhancement_torch --mode validation`` runs in a
subprocess (``cli_phase``). Before it, the ``dp`` phase trains data
parallel (parallel/mesh.py, ``DistributedDataParallel``): ``main()`` with
an explicit mesh over NCCL, one rank a card, against the same DCCRN run
without a group; two ranks on card 0 over gloo with CUDA tensors, one
step each of DCCRN ``cbn_fold``, DCCRN ``use_fused_blocks`` and CRN with
``fused_rnn`` at full width held to JAX's ``pmean`` computed in one
process; and ``parallel/dryrun.py:dryrun_multichip`` over NCCL (Sepformer's
attention kernels among its families); every rank reports its own
launches (``dp_phase``). The ``remat`` phase trains DCCRN at
``bench.py``'s point with remat off and under the JAX policies "",
"conv_out,cbn_stats" and "cbn_stats", and Sepformer at B 4 off, "" and
"attn_out", each first step and DCCRN's running statistics held to remat
off's (``remat_phase``); the ``tools`` phase, last, lays out a synthetic
48 kHz VoiceBank-DEMAND tree with ``tools/prepare_data.py``, trains a
DCCRN epoch on it through the CLI and enhances one file with
``tools/inference.py``, each a subprocess that must import nothing of JAX
(``tools_phase``). The ``wide_lstm`` phase runs the LSTM kernels' wide
design (the widths whose weight slice outgrows a block's shared memory) on
its model paths: CRN at its class default f32 (1792 units) and Demucs with
its bottleneck BLSTM (``lstm_layers: 2``, 2048 units, f32), a 10 s request
and a train step each against the plain loop at the f32 bounds; the LSTM
phase holds and times both kernels at those shapes (``LSTM_WIDE_TAGS``). Each phase's seconds and the total are logged. It
imports nothing of JAX.

Output: progress lines, then on the line before the last one JSON object
``{"kernels": [...]}`` (per kernel: launches on its own path, max abs error
against the plain version, kernel / plain / library times and the least
time the card could take; for the block kernels and their backward kernels
each time is the sum over the model's six blocks of that kind, one launch
each, and the error the largest of the six; the LSTM kernels' at one CRN
layer, with every other shape's numbers under ``cases``; the attention
kernels' at one intra-chunk layer), and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line is printed; so does a host without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from speech_enhancement_torch.config import Config, load_config
from speech_enhancement_torch.data.loader import encode_wire_int16
from speech_enhancement_torch.kernels import _build, counted
from speech_enhancement_torch.kernels import attention as attn_k
from speech_enhancement_torch.kernels import conv_block as cb
from speech_enhancement_torch.kernels import lstm as lstm_k
from speech_enhancement_torch.kernels.conv_block import (fused_conv_block, fused_conv_block_plain,
                                                         fused_deconv_block,
                                                         fused_deconv_block_plain)
from speech_enhancement_torch.kernels.masking import mask_e_kernel, mask_e_plain, mask_e_ref
from speech_enhancement_torch.kernels.stft import stft_design, stft_kernel, stft_plain
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models.dccrn import _stft_bases
from speech_enhancement_torch.ops.stft import istft_custom, stft_custom
from speech_enhancement_torch.parallel import mesh as mesh_lib
from speech_enhancement_torch.ops.complex_conv import (complex_cat, conv_from_hwio,
                                                       deconv_from_hwio)
from speech_enhancement_torch.train.evaluate import evaluate_utterance, extract_windows
from speech_enhancement_torch.train.solver import (adapt, compute_loss, decode_wire,
                                                   get_optimizer, train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "dccrn_vbd.yaml")
CRN_CONFIG = os.path.join(ROOT, "configs", "crn_vbd.yaml")
MASK_CONFIG = os.path.join(ROOT, "configs", "rnn_stft_mask_clarity.yaml")
SEED = 1234
N_REQUESTS = 3
SECONDS = 10.0

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time for
# a kernel's work is the larger of bytes / HBM rate and FLOPs / f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

# Tolerances, stated before the run:
STFT_RTOL, STFT_ATOL = 1e-4, 2e-3  # f32 sums of 400 products, as tests/test_pallas.py:22
MASK_ATOL = 1e-5                   # same f32 formula per element; |out| ~ 1-10
# kernel path vs plain path of the bf16 model: the STFT kernel sums in
# another order than cuBLAS (~1e-6 relative), which flips single bf16
# roundings (2^-8 relative) downstream; mean error <= 2% and worst sample
# <= 20% of the enhanced waveform's RMS
BF16_MEAN_FRAC, BF16_MAX_FRAC = 0.02, 0.20
F32_ATOL = 2e-4                    # small f32 DCCRN, card vs CPU plain path (tests' parity bound)
# block kernels vs their plain versions in bf16: both round the same f32
# pointwise to bf16 and the f32 conv sum once, in another summation order,
# so an output may sit one bf16 step (2^-7 relative at most) apart:
# |dy| <= 2^-7 |y_plain| + 1e-3. Stats partials (f32 sums over 643 frames,
# atomics across frame tiles): within 1e-3 of each lane's largest magnitude.
BLOCK_RTOL, BLOCK_ATOL, STATS_RTOL = 2.0**-7, 1e-3, 1e-3
BLOCK_BATCH, BLOCK_FRAMES = 192, 643  # one request's windows, frames of a 4 s window
# backward kernels vs their plain versions in bf16, at bench.py's batch: the
# input gradients round the same f32 sums once (|d| <= 2^-7 |ref| + 1e-3,
# as the forward blocks). The weight gradients are f32 sums of exact
# bf16 x bf16 products over B x rows x T (up to 10.5 M terms, enc0), split
# into K partials summed by torch.sum, against cuDNN's f32 order in the
# plain version: a sequential f32 sum of random-sign terms rounds by about
# 2^-24 sqrt(terms / 2) of its size, 1.4e-4 at 10.5 M terms (both sides sum
# in blocks, which rounds less), so 1e-3 of each block's largest |dW|.
DW_RTOL = 1e-3
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS = 128, 4.0, 3  # bench.py's operating point
TRAIN_OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
# fused vs unfused (cbn_fold) first train step, bf16 with f32 statistics:
# two summation orders and roundings at other places
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_MIN_COSINE = 0.01, 0.05, 0.99
LEAF_RTOL = 2e-3  # small f32 train step, card vs CPU: the JAX package's fused-gradient bound
# the small config of tests/test_dccrn_fused.py:17-21
SMALL_FUSED = {"name": "dccrn", "win_len": 128, "win_inc": 32, "fft_len": 256,
               "kernel_num": [4, 8, 8, 16, 16, 16], "rnn_layers": 2, "rnn_units": 16,
               "dtype": "float32", "use_fused_blocks": True}
# LSTM kernels vs their plain versions, bf16, T = 501: both store h, c and
# the gates rounded to bf16 and sum each step's f32 product in another
# order, so a stored value may land one bf16 step (2^-7 |v|) apart, and the
# recurrence carries such flips into later steps. A first run at CRN's and
# rnn-stft-mask's shapes measured the worst element at one step and the
# mean drift at 2.6e-5 (h) to 5.5e-5 (c) after 501 steps, with no growth
# along t. Bounds: every element within two steps plus 2^-8, the mean
# within 4e-4 (7x the drift). Backward (dgates, dh0, dc0, f32 carries):
# within 1e-2 of each output's largest magnitude (measured 4.0e-3, 9.8e-4,
# 2.2e-4). f32: 1e-4 (the split-f32 design's three TF32 products, or the
# first design's f32 FMA, against the plain version's f32 matmul; one TF32
# product alone misses it, tests/test_torch_lstm_f32_ring.py).
LSTM_RTOL, LSTM_ATOL, LSTM_MEAN = 2.0**-6, 2.0**-8, 4e-4
LSTM_BWD_RTOL, LSTM_F32_TOL = 1e-2, 1e-4
CRN_TRAIN_BATCH = 16  # configs/crn_vbd.yaml solver.batch_size, 4 s each
SEP_CONFIG = os.path.join(ROOT, "configs", "sepformer_clarity.yaml")
SEP_TRAIN_BATCH = 4  # configs/sepformer_clarity.yaml solver.batch_size, 4 s stereo each
SEP_OPTIM = {"optim": "adam", "lr": 1.5e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
SEP_LAUNCHES = 2 * (8 + 8)  # attention launches a model call: 2 dual blocks x (8 + 8) layers
# attention kernels vs their plain versions. f32: the same FMA arithmetic in
# another order (the bf16 kernel's probabilities go through exp2, 2e-6
# relative): forward |d| <= 1e-5 + 1e-4 |ref|, each gradient within 1e-4 of
# its largest element. bf16: both round the same f32 values once, so a value
# may land one bf16 step apart: forward |d| <= 2^-9 + 2^-7 |ref|, each
# gradient within 2^-7 of its largest element.
MHA_TOL = {torch.float32: (1e-5, 1e-4, 1e-4), torch.bfloat16: (2.0**-9, 2.0**-7, 2.0**-7)}
MHA_SLICE = 1024  # sequences compared with the plain version (its f32 [B', H, L, L] is 2 GB)
# (case, B', H, L, D) compared with the plain versions, and (case, B', L,
# backward) timed at H 8, D 32: one serving request's and one train step's
# sequences (B' = windows x chunks: 192 x 66 and 192 x 250 serving, 4 x 66
# and 4 x 250 training)
MHA_CHECKED = (("intra", MHA_SLICE, 8, 250, 32), ("inter", MHA_SLICE, 8, 66, 32),
               ("ragged", 3, 2, 50, 16))
MHA_TIMED = (("intra serve", 12672, 250, False), ("inter serve", 48000, 66, False),
             ("intra train", 264, 250, True), ("inter train", 1000, 66, True))
# the small f32 Sepformer on the card vs the CPU path (D 16)
SMALL_SEP = {"name": "sepformer", "encoder_in_nchannels": 2, "encoder_out_nchannels": 64,
             "masknet_chunksize": 50, "masknet_numlayers": 1, "intra_numlayers": 1,
             "inter_numlayers": 1, "intra_nhead": 4, "inter_nhead": 4, "intra_dffn": 128,
             "inter_dffn": 128, "dtype": "float32", "fused_attention": True, "segment": 0.125,
             "sample_rate": 16000, "win_length": 512}
# the small f32 CRN on the card vs the CPU path: n_fft 128 gives H = 256
SMALL_CRN = {"name": "crn", "n_fft": 128, "hop_length": 32, "win_length": 128, "center": True,
             "segment": 0.25, "sample_rate": 16000, "dtype": "float32", "fused_rnn": True}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi exit {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def utterance(rng: np.random.Generator, n: int) -> np.ndarray:
    """Speech-like test signal: a glottal-pulse-ish harmonic source with
    syllable-rate envelope, plus noise, at 16 kHz -> [1, 1, n] f32."""
    t = np.arange(n) / 16000.0
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6.28)))
    noise = 0.1 * rng.standard_normal(n)
    return (0.2 * voiced * envelope + noise).astype(np.float32)[None, None]


def kernel_phase(dev) -> dict:
    """Each kernel vs its plain version at the serving path's shapes."""
    rng = np.random.default_rng(SEED)
    results = {}

    # STFT: N=192 windows of 64,000 samples, (win - hop) = 300 pad each side
    batch, total, win, hop = 192, 64000 + 2 * 300, 400, 100
    x = torch.from_numpy(rng.standard_normal((batch, total), dtype=np.float32)).to(dev)
    basis = torch.from_numpy(_stft_bases(win, 512)[0]).to(dev)
    n_frames, dim = (total - win) // hop + 1, basis.shape[1]
    got = stft_kernel(x, basis, hop, win)
    want = stft_plain(x, basis, hop, win)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if got.shape != (batch, n_frames, dim) or not torch.allclose(
            got, want, rtol=STFT_RTOL, atol=STFT_ATOL):
        fail(f"stft kernel disagrees with plain: max abs err {err}, shape {tuple(got.shape)}")
    flops = 2.0 * batch * n_frames * dim * win
    nbytes = 4.0 * (x.numel() + basis.numel() + batch * n_frames * dim)
    f32_bound = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    # the split-f32 design does three TF32 products for each f32 one
    tf32_bound = max(3 * flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    design = stft_design(batch, total, hop, win, dim)[0]
    bound = tf32_bound if design == "tc" else f32_bound
    # one PyTorch call for the same function: matmul on the unfolded frames
    library = cuda_ms(lambda: torch.matmul(x.unfold(-1, win, hop), basis))
    # the first design (f32 FMA) in the same run: a signal 4 bytes off a
    # 16-byte address takes it
    x_off = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
    if stft_design(batch, total, hop, win, dim, aligned=False)[0] != "simt":
        fail("stft: an unaligned signal does not take the first design")
    first_ms = cuda_ms(lambda: stft_kernel(x_off, basis, hop, win))
    first = stft_kernel(x_off, basis, hop, win)
    first_err = (first - want).abs().max().item()
    if not torch.allclose(first, want, rtol=STFT_RTOL, atol=STFT_ATOL):
        fail(f"stft first design disagrees with plain: max abs err {first_err}")
    del first
    # for reference, cuFFT through torch.stft on the same frames (a 512-sample
    # frame holding the 400 windowed taps, 112 zeros appended to the signal)
    window512 = torch.zeros(512, device=dev)
    window512[:win] = torch.from_numpy(_stft_bases(win, 512)[2]).to(dev)
    x_fft = torch.nn.functional.pad(x, (0, 512 - win))
    fft_ms = cuda_ms(lambda: torch.stft(x_fft, 512, hop, 512, window512, center=False,
                                        return_complex=True))
    results["stft"] = {
        "name": "stft", "route": "cuda",
        "source": "speech_enhancement_torch/kernels/csrc/stft.cu",
        "replaces": "speech_enhancement_tpu/ops/pallas/stft.py:54",
        "shape": f"x [{batch}, {total}] x basis [{win}, {dim}] -> [{batch}, {n_frames}, {dim}]",
        "max_abs_err": err, "tolerance": f"rtol {STFT_RTOL}, atol {STFT_ATOL}",
        "ms": cuda_ms(lambda: stft_kernel(x, basis, hop, win)),
        "plain_ms": cuda_ms(lambda: stft_plain(x, basis, hop, win)),
        "bound_ms": bound,
        "bound_by": "operations" if flops / F32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": library, "fft_ms": fft_ms, "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
        "design": design, "split_f32_bound_ms": tf32_bound, "f32_fma_bound_ms": f32_bound,
        "first_design_ms": first_ms, "first_design_max_abs_err": first_err,
    }
    del x, got, want, x_fft, x_off

    # mask E: four [192, 257, 643] f32 arrays -> two
    shape = (batch, 257, n_frames)
    arrays = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
              for _ in range(4)]
    got = mask_e_kernel(*arrays)
    want = mask_e_plain(*arrays)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if err > MASK_ATOL:
        fail(f"mask kernel disagrees with plain: max abs err {err}")
    elems = float(np.prod(shape))
    nbytes = 6 * 4 * elems
    flops = 15 * elems  # 2 squares+add, sqrt, tanh, add, div, 4 mul + 2 add/sub, 2 mul
    results["mask_e"] = {
        "name": "mask_e", "route": "cuda",
        "source": "speech_enhancement_torch/kernels/csrc/masking.cu",
        "replaces": "speech_enhancement_tpu/ops/pallas/masking.py:48",
        "shape": f"4 x [{batch}, 257, {n_frames}] -> 2 x same",
        "max_abs_err": err, "tolerance": f"atol {MASK_ATOL}",
        "ms": cuda_ms(lambda: mask_e_kernel(*arrays)),
        "plain_ms": cuda_ms(lambda: mask_e_plain(*arrays)),
        "bound_ms": max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "bytes", "library_ms": None, "gbytes": nbytes / 1e9,
    }
    for r in results.values():
        log(f"kernel {r['name']}: {r['shape']}; max abs err {r['max_abs_err']:.3e} "
            f"({r['tolerance']}); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f"; torch.stft (cuFFT) {r['fft_ms']:.4f} ms" if "fft_ms" in r else ""))
    r = results["stft"]
    log(f"kernel stft: design {r['design']}; bounds: split-f32 (3 TF32 products) "
        f"{r['split_f32_bound_ms']:.4f} ms, f32 FMA {r['f32_fma_bound_ms']:.4f} ms; the first "
        f"design (f32 FMA) in the same run {r['first_design_ms']:.4f} ms (max abs err "
        f"{r['first_design_max_abs_err']:.3e})")
    return results


def model_blocks(kernel_num, n_freq: int = 256):
    """(name, f_in, input widths, c2out) of DCCRN's six encoder and six
    decoder blocks; widths count stacked (r, i) channels."""
    blocks, c2in, f = [], 2, n_freq
    for i, c2out in enumerate(kernel_num):
        blocks.append((f"enc{i}", f, (c2in,), c2out))
        c2in, f = c2out, f // 2
    dec_out = list(kernel_num[::-1][1:]) + [2]
    for i, c2out in enumerate(dec_out):
        blocks.append((f"dec{i}", f, (c2in, kernel_num[len(kernel_num) - 1 - i]), c2out))
        c2in, f = c2out, 2 * f
    return blocks


def block_work(name: str, batch: int, f_in: int, widths, c2out: int, n_time: int):
    """(FLOPs, bytes) of one block launch: 2 x (live input rows x time taps
    x input channels) per output, counting only the frequency taps that land
    inside the input; inputs and the output read or written once in bf16."""
    dec = name.startswith("dec")
    f_out = 2 * f_in if dec else f_in // 2
    live = 0
    for fo in range(f_out):
        for jf in range(5):
            if dec and (fo + jf) % 2:
                continue
            fi = (fo + jf - 2) // 2 if dec else 2 * fo + jf - 2
            live += 0 <= fi < f_in
    flops = 2.0 * batch * n_time * c2out * live * 2 * sum(widths)
    nbytes = 2.0 * batch * n_time * (f_in * sum(widths) + f_out * c2out) + 2.0 * 10 * sum(
        widths) * c2out
    return flops, nbytes


def block_inputs(dev, gen, name, batch, f_in, widths, c2out, n_time):
    """bf16 activations, HWIO weights with unit-variance outputs, bias,
    coefficients near identity and PReLU slopes, on the card."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    acts = [randn(batch, f_in * c2, n_time).to(torch.bfloat16) for c2 in widths]
    w2 = randn(5, 2, sum(widths), c2out) / float(np.sqrt(10 * sum(widths)))
    b2 = 0.1 * randn(c2out)
    coefs = [(1 + 0.1 * randn(c2), 0.1 * randn(c2), 0.1 * randn(c2)) for c2 in widths]
    alphas = [torch.full((1,), 0.25, device=dev) for _ in widths]
    return acts, w2, b2, coefs, alphas


def block_calls(name, f_in, widths, c2out, acts, w2, b2, coefs, alphas):
    """(kernel(with_stats=...), plain(with_stats=...), library call) of one
    block. The library call is the unfused path's cuDNN bf16 convolution
    alone: no complex-BN / PReLU prologue and no stats, so less work than
    the kernel."""
    if name.startswith("enc"):
        shapes = dict(f_in=f_in, c2in=widths[0], c2out=c2out)
        args = (acts[0], w2, b2, *coefs[0], alphas[0])
        kernel = functools.partial(fused_conv_block, *args, **shapes)
        plain = functools.partial(fused_conv_block_plain, *args, **shapes)
        # cuDNN's bf16 conv alone, on an input of the activated input's shape
        # and type, padded and in NCHW beforehand
        xp = F.pad(acts[0].view(acts[0].shape[0], f_in, widths[0], -1).permute(0, 2, 1, 3),
                   (1, 0, 2, 2)).contiguous()
        k = conv_from_hwio(w2).to(torch.bfloat16).contiguous()
        bias = b2.to(torch.bfloat16)
        library = functools.partial(F.conv2d, xp, k, bias, stride=(2, 1))
    else:
        shapes = dict(f_in=f_in, c2x=widths[0], c2s=widths[1], c2out=c2out)
        args = (acts[0], acts[1], w2, b2, coefs[0], alphas[0], coefs[1], alphas[1])
        kernel = functools.partial(fused_deconv_block, *args, **shapes)
        plain = functools.partial(fused_deconv_block_plain, *args, **shapes)
        nchw = [a.view(a.shape[0], f_in, c2, -1).permute(0, 2, 1, 3)
                for a, c2 in zip(acts, widths)]
        joined = complex_cat(*nchw).contiguous()
        k = deconv_from_hwio(w2).to(torch.bfloat16).contiguous()
        bias = b2.to(torch.bfloat16)
        library = functools.partial(F.conv_transpose2d, joined, k, bias, stride=(2, 1),
                                    padding=(2, 0), output_padding=(1, 0))
    return kernel, plain, library


def block_close(got, want) -> float:
    """Max abs error of a bf16 block output; fails past the stated bound."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if got.shape != want.shape or not bool((err <= BLOCK_RTOL * want.abs() + BLOCK_ATOL).all()):
        return float("inf")
    return err.max().item()


def stats_err(got, want) -> float:
    """Largest stats error as a share of its lane's largest magnitude."""
    scale = want.abs().amax(dim=(0, 1), keepdim=True) + 1e-6
    return ((got - want).abs() / scale).max().item()


def block_kernel_phase(dev, kernel_num) -> dict:
    """Both block kernels vs their plain versions at the twelve full-width
    blocks (B = 192 windows, T = 643 frames, bf16), with and without stats,
    then the small-K enc0 and the two-channel dec5 at B = 1 with T = 100.
    Returns the per-kernel entries of the kernels line: times summed over
    the six blocks of each kind, the largest error of the six."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, f_in, widths, c2out in model_blocks(kernel_num):
        inputs = block_inputs(dev, gen, name, BLOCK_BATCH, f_in, widths, c2out, BLOCK_FRAMES)
        kernel, plain, library = block_calls(name, f_in, widths, c2out, *inputs)
        err = block_close(kernel(), plain())
        (y, st), (y_p, st_p) = kernel(with_stats=True), plain(with_stats=True)
        torch.cuda.synchronize()
        err_stats_y, err_stats = block_close(y, y_p), stats_err(st, st_p)
        if max(err, err_stats_y) == float("inf") or err_stats > STATS_RTOL:
            fail(f"{name} kernel disagrees with plain: y {err}, with stats y {err_stats_y}, "
                 f"stats {err_stats} (bounds |dy| <= {BLOCK_RTOL:g}|y| + {BLOCK_ATOL:g}, "
                 f"stats {STATS_RTOL:g})")
        flops, nbytes = block_work(name, BLOCK_BATCH, f_in, widths, c2out, BLOCK_FRAMES)
        row = {"block": name, "f_in": f_in, "widths": widths, "c2out": c2out,
               "max_abs_err": err, "stats_err": err_stats,
               "ms": cuda_ms(kernel, reps=10), "ms_stats": cuda_ms(
                   lambda: kernel(with_stats=True), reps=10),
               "plain_ms": cuda_ms(plain, reps=5), "library_ms": cuda_ms(library, reps=10),
               "flops_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
               "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "gflop": flops / 1e9}
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        row["bound_by"] = ("operations" if row["flops_bound_ms"] > row["bytes_bound_ms"]
                           else "bytes")
        rows.append(row)
        log(f"block {name}: f_in {f_in}, in {'+'.join(map(str, widths))} -> {c2out} channels, "
            f"[{BLOCK_BATCH}, ., {BLOCK_FRAMES}] bf16; max abs err {err:.3e}, stats "
            f"{err_stats:.2e} of lane max; kernel {row['ms']:.4f} ms "
            f"({row['gflop'] / row['ms']:.1f} TFLOP/s), with stats {row['ms_stats']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, cuDNN bf16 conv alone {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del inputs, kernel, plain, library, y, st, y_p, st_p
    for name, f_in, widths, c2out in (("enc0", 256, (2,), 16), ("dec5", 128, (16, 16), 2)):
        inputs = block_inputs(dev, gen, name, 1, f_in, widths, c2out, 100)
        kernel, plain, _ = block_calls(name, f_in, widths, c2out, *inputs)
        (y, st), (y_p, st_p) = kernel(with_stats=True), plain(with_stats=True)
        err, err_stats = block_close(y, y_p), stats_err(st, st_p)
        if err == float("inf") or err_stats > STATS_RTOL:
            fail(f"{name} at B = 1, T = 100 disagrees with plain: y {err}, stats {err_stats}")
        log(f"block {name} at B = 1, T = 100 (ragged frame tile): max abs err {err:.3e}, "
            f"stats {err_stats:.2e} of lane max")

    entries = {}
    for kind, name, source, replaces in (
            ("enc", "conv_block", "speech_enhancement_torch/kernels/csrc/conv_block.cu",
             "speech_enhancement_tpu/ops/pallas/experimental/conv_block.py:444"),
            ("dec", "deconv_block", "speech_enhancement_torch/kernels/csrc/deconv_block.cu",
             "speech_enhancement_tpu/ops/pallas/experimental/conv_block.py:505")):
        mine = [r for r in rows if r["block"].startswith(kind)]
        total = {key: sum(r[key] for r in mine) for key in
                 ("ms", "ms_stats", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        entries[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": f"the six {kind}oder blocks of configs/dccrn_vbd.yaml at B = "
                     f"{BLOCK_BATCH}, T = {BLOCK_FRAMES}, bf16; times summed over the six",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "tolerance": f"|dy| <= {BLOCK_RTOL:g}|y_plain| + {BLOCK_ATOL:g}; stats "
                         f"{STATS_RTOL:g} of lane max",
            **total,
            "bound_by": "operations" if by_ops > total["bound_ms"] / 2 else "bytes",
            "blocks": mine,
        }
        log(f"kernel {name}: six blocks sum kernel {total['ms']:.3f} ms (with stats "
            f"{total['ms_stats']:.3f}), plain {total['plain_ms']:.3f} ms, cuDNN bf16 conv "
            f"alone {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return entries


def bwd_calls(name, f_in, widths, c2out, gy, zs, w2):
    """(input-gradient kernel, its plain version, weight-gradient kernel,
    its plain version, cuDNN's bf16 input gradient, cuDNN's bf16 weight
    gradient) of one block. The cuDNN calls are aten.convolution_backward of
    the unfused path's own bf16 convolution (the library yardstick; the
    port never calls it), on operands laid out beforehand."""
    batch, _, n_time = gy.shape
    nchw = [z.view(batch, f_in, c2, n_time).permute(0, 2, 1, 3) for z, c2 in zip(zs, widths)]
    if name.startswith("enc"):
        shapes = dict(f_in=f_in, c2in=widths[0], c2out=c2out)
        f_out = f_in // 2
        gz = (functools.partial(cb.enc_bwd_gz, gy, w2, **shapes),
              functools.partial(cb.enc_bwd_gz_plain, gy, w2, **shapes))
        dw = (functools.partial(cb.enc_bwd_dw, zs[0], gy, **shapes),
              functools.partial(cb.enc_bwd_dw_plain, zs[0], gy, **shapes))
        inp = F.pad(nchw[0], (1, 0, 2, 2)).contiguous()
        k = conv_from_hwio(w2).to(torch.bfloat16).contiguous()
        g = gy.view(batch, f_out, c2out, n_time).permute(0, 2, 1, 3).contiguous()
        conv = ([2, 1], [0, 0], [1, 1], False, [0, 0], 1)
    else:
        shapes = dict(f_in=f_in, c2x=widths[0], c2s=widths[1], c2out=c2out)
        f_out = 2 * f_in
        gz = (functools.partial(cb.dec_bwd_gz, gy, w2, **shapes),
              functools.partial(cb.dec_bwd_gz_plain, gy, w2, **shapes))
        dw = (functools.partial(cb.dec_bwd_dw, zs[0], zs[1], gy, **shapes),
              functools.partial(cb.dec_bwd_dw_plain, zs[0], zs[1], gy, **shapes))
        inp = complex_cat(*nchw).contiguous()
        k = deconv_from_hwio(w2).to(torch.bfloat16).contiguous()
        # the transposed conv's full output: the chomped first frame gets 0
        g = F.pad(gy.view(batch, f_out, c2out, n_time).permute(0, 2, 1, 3), (1, 0)).contiguous()
        conv = ([2, 1], [2, 0], [1, 1], True, [1, 0], 1)
    lib_gz = functools.partial(torch.ops.aten.convolution_backward, g, inp, k, None, *conv,
                               [True, False, False])
    lib_dw = functools.partial(torch.ops.aten.convolution_backward, g, inp, k, None, *conv,
                               [False, True, False])
    return gz, dw, lib_gz, lib_dw


def bwd_kernel_phase(dev, kernel_num) -> dict:
    """The four backward kernels vs their plain versions at the twelve
    full-width blocks (B = 128 windows of bench.py's step, T = 643, bf16).
    Returns the per-kernel entries of the kernels line: times summed over
    the six blocks of each kind, the largest error of the six."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    rows = []
    for name, f_in, widths, c2out in model_blocks(kernel_num):
        f_out = 2 * f_in if name.startswith("dec") else f_in // 2
        gy = randn(TRAIN_BATCH, f_out * c2out, BLOCK_FRAMES).to(torch.bfloat16)
        zs = [randn(TRAIN_BATCH, f_in * c2, BLOCK_FRAMES).to(torch.bfloat16) for c2 in widths]
        w2 = randn(5, 2, sum(widths), c2out) / float(np.sqrt(10 * sum(widths)))
        (gz, gz_plain), (dw, dw_plain), lib_gz, lib_dw = bwd_calls(name, f_in, widths, c2out,
                                                                   gy, zs, w2)
        got, want = gz(), gz_plain()
        got, want = (got, want) if isinstance(got, torch.Tensor) else (
            torch.cat([a.flatten() for a in got]), torch.cat([a.flatten() for a in want]))
        err_gz = block_close(got, want)
        got, want = dw(), dw_plain()
        torch.cuda.synchronize()
        err_dw = (got - want).abs().max().item()
        rel_dw = err_dw / want.abs().max().item()
        if err_gz == float("inf") or not rel_dw <= DW_RTOL:
            fail(f"{name} backward kernels disagree with plain: g_z {err_gz} (bound |d| <= "
                 f"{BLOCK_RTOL:g}|ref| + {BLOCK_ATOL:g}), dW {rel_dw} of its max (bound "
                 f"{DW_RTOL:g})")
        del got, want
        flops, _ = block_work(name, TRAIN_BATCH, f_in, widths, c2out, BLOCK_FRAMES)
        acts = 2.0 * TRAIN_BATCH * BLOCK_FRAMES * (f_in * sum(widths) + f_out * c2out)
        weights = 10.0 * sum(widths) * c2out
        for kind, kernel, plain, library, err, nbytes in (
                ("gz", gz, gz_plain, lib_gz, err_gz, acts + 2 * weights),
                ("dw", dw, dw_plain, lib_dw, err_dw, acts + 4 * weights)):
            row = {"block": name, "kind": kind, "f_in": f_in, "widths": widths, "c2out": c2out,
                   "max_abs_err": err, "rel_err": rel_dw if kind == "dw" else None,
                   "ms": cuda_ms(kernel, reps=10, warmup=2),
                   "plain_ms": cuda_ms(plain, reps=2, warmup=1),
                   "library_ms": cuda_ms(library, reps=3, warmup=1),
                   "flops_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
                   "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "gflop": flops / 1e9}
            row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
            row["bound_by"] = ("operations" if row["flops_bound_ms"] > row["bytes_bound_ms"]
                               else "bytes")
            rows.append(row)
            log(f"bwd {name} {kind}: f_in {f_in}, in {'+'.join(map(str, widths))} -> {c2out} "
                f"channels, B {TRAIN_BATCH}, T {BLOCK_FRAMES} bf16; max abs err {err:.3e}"
                + (f" ({rel_dw:.2e} of the largest |dW|)" if kind == "dw" else "") + "; kernel "
                f"{row['ms']:.4f} ms ({row['gflop'] / row['ms']:.1f} TFLOP/s), plain "
                f"{row['plain_ms']:.4f} ms, cuDNN bf16 {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        del gy, zs, gz, gz_plain, dw, dw_plain, lib_gz, lib_dw

    entries = {}
    for kind, part, name, source, replaces in (
            ("enc", "gz", "enc_bwd_gz", "conv_block_bwd.cu", "conv_block.py:725"),
            ("enc", "dw", "enc_bwd_dw", "conv_block_bwd.cu", "conv_block.py:755"),
            ("dec", "gz", "dec_bwd_gz", "deconv_block_bwd.cu", "conv_block.py:790"),
            ("dec", "dw", "dec_bwd_dw", "deconv_block_bwd.cu", "conv_block.py:828")):
        mine = [r for r in rows if r["block"].startswith(kind) and r["kind"] == part]
        total = {key: sum(r[key] for r in mine) for key in
                 ("ms", "plain_ms", "library_ms", "bound_ms", "gflop")}
        by_ops = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"speech_enhancement_torch/kernels/csrc/{source}",
            "replaces": f"speech_enhancement_tpu/ops/pallas/experimental/{replaces}",
            "shape": f"the six {kind}oder blocks of configs/dccrn_vbd.yaml at B = "
                     f"{TRAIN_BATCH}, T = {BLOCK_FRAMES}, bf16; times summed over the six",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "tolerance": (f"|d| <= {BLOCK_RTOL:g}|ref| + {BLOCK_ATOL:g}" if part == "gz" else
                          f"{DW_RTOL:g} of each block's largest |dW|"),
            **total, "tflops": total["gflop"] / total["ms"],
            "bound_by": "operations" if by_ops > total["bound_ms"] / 2 else "bytes",
            "blocks": mine,
        }
        log(f"kernel {name}: six blocks sum kernel {total['ms']:.3f} ms "
            f"({entries[name]['tflops']:.1f} TFLOP/s), plain {total['plain_ms']:.3f} ms, cuDNN "
            f"bf16 {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return entries


def grad_phase(dev) -> dict:
    """The STFT and mask-E kernels under autograd at the train step's shapes
    (B = 128 windows of 4 s) vs the plain path's gradients: the signal's
    gradient of the STFT (kernel forward, overlap-add backward) against
    autograd of the plain framing + matmul, and the mask-E kernel's against
    autograd of the pole-free formula, with a zero mask in part of the input."""
    rng = np.random.default_rng(SEED + 2)
    win, hop = 400, 100
    total = int(TRAIN_SECONDS * 16000) + 2 * (win - hop)
    n_frames = (total - win) // hop + 1
    basis = torch.from_numpy(_stft_bases(win, 512)[0]).to(dev)
    x = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, total), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n_frames, basis.shape[1]),
                                             dtype=np.float32)).to(dev)
    grads = []
    for fn in (stft_kernel, stft_plain):
        leaf = x.clone().requires_grad_()
        fn(leaf, basis, hop, win).backward(g)
        grads.append(leaf.grad)
    scale = grads[1].abs().max().item()
    err_stft = (grads[0] - grads[1]).abs().max().item() / scale
    shape = (TRAIN_BATCH, 257, n_frames)
    arrays = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
              for _ in range(4)]
    arrays[2][:, :8] = 0.0  # the mask is zero on the lowest bins: the pole
    arrays[3][:, :8] = 0.0
    cot = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
           for _ in range(2)]
    mask_grads = []
    for fn in (mask_e_kernel, mask_e_ref):
        leaves = [a.clone().requires_grad_() for a in arrays]
        torch.autograd.backward(fn(*leaves), cot)
        mask_grads.append([leaf.grad for leaf in leaves])
    finite = all(bool(torch.isfinite(t).all()) for t in mask_grads[0])
    err_mask = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(*mask_grads))
    torch.cuda.synchronize()
    # the STFT gradient sums win / hop = 4 frames of 514-term f32 products;
    # the mask's is the same f32 formula: 1e-5 of the largest gradient each
    if not finite or err_stft > 1e-5 or err_mask > 1e-5:
        fail(f"kernel gradients disagree with the plain path: STFT {err_stft}, mask E "
             f"{err_mask} of the largest gradient (bound 1e-5), mask finite {finite}")
    log(f"grad: STFT kernel path vs plain signal gradient {err_stft:.2e}, mask E kernel path "
        f"vs pole-free plain {err_mask:.2e} of the largest gradient (bound 1e-5; the mask "
        f"is zero on 8 of 257 bins, gradients finite)")
    return {"stft_grad_err": err_stft, "mask_e_grad_err": err_mask}


def train_batch(sample_rate: int):
    """bench.py's batch: B = 128 mixtures and targets of 4 s, N(0, 0.1^2),
    made with numpy from the seed, on the int16 wire."""
    rng = np.random.default_rng(SEED)
    n = int(TRAIN_SECONDS * sample_rate)
    mixture = (0.1 * rng.standard_normal((TRAIN_BATCH, 1, n))).astype(np.float32)
    target = (0.1 * rng.standard_normal((TRAIN_BATCH, 1, 1, n))).astype(np.float32)
    return encode_wire_int16(mixture), encode_wire_int16(target)


def flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.float().flatten() for p in model.parameters()])


def train_path(tag, dev, wire_m, wire_s, path=CONFIG, loss_name="mse", optim=TRAIN_OPTIM,
               steps=TRAIN_STEPS, detail=True, falling=True, first_step=None,
               **overrides) -> dict:
    """``steps`` steps of train_step with the config at ``path`` at full
    width (PIT over the speakers of a multi-speaker model), the loss
    falling step to step unless ``falling`` is off (dropout); then, with
    ``detail``, one step split by CUDA events and one under the profiler.
    ``first_step(model)``, if given, is called after the first step."""
    cfg, model, spec = load_model(dev, path, **overrides)
    opt = get_optimizer(Config(optim), model.parameters())
    model_config = cfg.model if spec.domain == "stft" else None
    use_pit = spec.multi_speaker
    step_fn = functools.partial(train_step, model, spec, opt, wire_m, wire_s, loss_name,
                                use_pit=use_pit, device=dev, model_config=model_config)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, norms, times, first_grads = [], [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, norm = step_fn()
        losses.append(float(loss))  # syncs
        norms.append(float(norm))
        times.append(time.perf_counter() - t0)
        if step == 0:
            first_grads = flat_grads(model)  # clipped in place if norm > clip: same direction
            if first_step is not None:
                first_step(model)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses + norms)):
        fail(f"{tag} train: non-finite loss or grad norm {losses} {norms}")
    if falling and not all(a > b for a, b in zip(losses, losses[1:])):
        fail(f"{tag} train: the loss does not fall over {steps} steps: {losses}")
    step_ms = 1e3 * statistics.median(times[1:] or times)
    batch = (wire_m["q"] if isinstance(wire_m, dict) else wire_m).shape[0]
    result = {"config": os.path.relpath(path, ROOT), "overrides": overrides, "batch": batch,
              "seconds": TRAIN_SECONDS, "losses": losses, "grad_norms": norms,
              "step_ms": [1e3 * t for t in times], "median_step_ms_2_to_3": step_ms,
              "utt_per_s": batch / (step_ms / 1e3), "peak_mem_gib": peak_gib,
              "launches": launches, "reverse_launches": {
                  "lstm_fwd": lstm_k.lstm_fwd.reverse_launches,
                  "lstm_bwd": lstm_k.lstm_bwd.reverse_launches}}
    log(f"train {tag}: losses {losses}, grad norms {norms}; step ms "
        f"{[round(x, 1) for x in result['step_ms']]} (the first warms up), median of steps 2 "
        f"to {steps} {step_ms:.1f} ms = {result['utt_per_s']:.1f} utt/s; peak "
        f"{peak_gib:.2f} GiB; launches {launches}")
    if not detail:
        return result, first_grads

    mixture, target = adapt(spec, decode_wire(wire_m, dev), decode_wire(wire_s, dev),
                            model_config)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    opt.zero_grad()
    out = model(mixture)
    loss = compute_loss(loss_name, out, target, mixture, use_pit=use_pit)
    events[1].record()
    loss.backward()
    events[2].record()
    opt.step()
    events[3].record()
    torch.cuda.synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward", "backward", "optimizer"))}
    busy_ms, top = device_busy(step_fn)
    result.update(split_ms=split, device_busy_ms=busy_ms,
                  device_busy_share=busy_ms / step_ms if busy_ms else None, top_kernels=top)
    share = result["device_busy_share"]
    log(f"train {tag}: one step by CUDA events: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in split.items()) + f"; device busy {busy_ms:.1f} ms "
        f"({'not measured' if share is None else f'{share:.3f}'} of the median step); top "
        "kernels " + "; ".join(f"{t['kernel']} {t['ms']:.2f} ms x{t['count']}" for t in top))
    return result, first_grads


BLOCK_STEP = {"stft": 1, "mask_e": 1, "conv_block": 6, "deconv_block": 6, "enc_bwd_gz": 5,
              "enc_bwd_dw": 6, "dec_bwd_gz": 6, "dec_bwd_dw": 6}  # a fused DCCRN train step


def expect_launches(tag: str, got: dict, **want) -> None:
    full = dict.fromkeys(COUNTED, 0)
    full.update(want)
    if got != full:
        fail(f"{tag}: launches {got}, want {full}")


def first_step_agreement(tag: str, ref: dict, g_ref, other: dict, g_other, what: str,
                         min_cosine: float = TRAIN_MIN_COSINE) -> dict:
    """Two paths' first train steps on the same batch and weights: loss 1%,
    grad norm 5%, gradient cosine >= ``min_cosine``."""
    loss_rel = abs(other["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    norm_rel = abs(other["grad_norms"][0] - ref["grad_norms"][0]) / ref["grad_norms"][0]
    cosine = F.cosine_similarity(g_other, g_ref, dim=0).item()
    agreement = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "grad_cosine": cosine}
    log(f"{tag}: {what}, first step: loss {loss_rel:.2e} relative (bound {TRAIN_LOSS_RTOL}), "
        f"grad norm {norm_rel:.2e} (bound {TRAIN_NORM_RTOL}), gradient cosine {cosine:.6f} "
        f"(bound {min_cosine})")
    if loss_rel > TRAIN_LOSS_RTOL or norm_rel > TRAIN_NORM_RTOL or cosine < min_cosine:
        fail(f"{tag}: {what} disagree on the first step: {agreement}")
    return agreement


def card_vs_cpu_step(tag, cfg, wav, mixture, sources, want_serve, want_train, seed=SEED,
                     loss_name="mse", optim=TRAIN_OPTIM, use_pit=False, model_config=None,
                     zero_grad=lambda key: False, prepare=None) -> dict:
    """A small f32 model built from ``cfg`` with the same weights (from
    ``seed``) on the card and on the CPU (the plain versions, which the CPU
    tests hold against the JAX package): ``wav`` served within F32_ATOL
    (``wav=None``: no serving), then one train step with every gradient and
    updated leaf within LEAF_RTOL of its scale (a leaf whose true gradient
    is zero, ``zero_grad``, at the global scale; Adam moves an element by up
    to lr whatever its gradient: the parameters get 2 lr more). Checks the
    card's launches. ``prepare`` (if given) is applied to each built model."""
    results = []
    for device in ("cuda", "cpu"):
        model, spec = build_model(cfg.model, device=device,
                                  generator=torch.Generator().manual_seed(seed))
        if prepare is not None:
            prepare(model)
        reset_launches()
        served = (evaluate_utterance(wav, model, spec, cfg, device=device) if wav is not None
                  else np.zeros(1))
        serve_launches = read_launches()
        opt = get_optimizer(Config(optim), model.parameters())
        reset_launches()
        loss, norm = train_step(model, spec, opt, mixture, sources, loss_name, use_pit=use_pit,
                                device=device, model_config=model_config)
        results.append((served, serve_launches, float(loss), float(norm), read_launches(),
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        {k: v.cpu() for k, v in model.state_dict().items()}))
    (served_c, serve_l, loss_c, norm_c, train_l, grads_c, state_c), (
        served_p, _, loss_p, norm_p, _, grads_p, state_p) = results
    expect_launches(f"{tag} serve", serve_l, **want_serve)
    expect_launches(f"{tag} train step", train_l, **want_train)
    serve_err = float(np.abs(served_c - served_p).max())
    if not np.isfinite(served_c).all() or serve_err > F32_ATOL:
        fail(f"{tag} served on the card vs CPU: max abs err {serve_err} > {F32_ATOL}")
    worst = {"loss": abs(loss_c - loss_p) / abs(loss_p),
             "grad_norm": abs(norm_c - norm_p) / norm_p}
    for what, got, ref, extra in (("grad", grads_c, grads_p, 0.0),
                                  ("state", state_c, state_p, 2 * optim["lr"])):
        scale = max(v.abs().max().item() for v in ref.values())
        for key in ref:
            leaf = scale if zero_grad(key) else max(ref[key].abs().max().item(), 1e-12)
            worst[f"{what} {key}"] = ((got[key] - ref[key]).abs().max().item() - extra) / leaf
    bad = {k: v for k, v in worst.items() if not np.isfinite(v) or v > LEAF_RTOL}
    if bad:
        fail(f"{tag} train step, card vs CPU, beyond {LEAF_RTOL}: {bad}")
    top = max(worst, key=worst.get)
    log(f"{tag}: card vs CPU served max abs err {serve_err:.2e} (bound {F32_ATOL}); one train "
        f"step loss {worst['loss']:.2e}, grad norm {worst['grad_norm']:.2e} relative, worst leaf "
        f"{top} {worst[top]:.2e} of its scale (bound {LEAF_RTOL}); launches serve {serve_l}, "
        f"train {train_l}")
    return {"serve_err": serve_err, "served_shape": served_c.shape, "loss_rel": worst["loss"],
            "grad_norm_rel": worst["grad_norm"], "worst_leaf": top, "worst_leaf_err": worst[top]}


def train_phase(dev) -> dict:
    """bench.py's train step at full width on both paths, the fused one
    through all eight kernels (enc0's input is the spectrogram: no input
    gradient launched), held against each other on the first step."""
    cfg = load_config(CONFIG)
    wire_m, wire_s = train_batch(int(cfg.dset.sample_rate))
    fused, g_fused = train_path("fused", dev, wire_m, wire_s, use_fused_blocks=True)
    expect_launches("the fused train steps", fused["launches"],
                    **{k: TRAIN_STEPS * v for k, v in BLOCK_STEP.items()})
    unfused, g_unfused = train_path("unfused (cbn_fold)", dev, wire_m, wire_s, cbn_fold=True)
    expect_launches("the unfused train steps", unfused["launches"], stft=TRAIN_STEPS,
                    mask_e=TRAIN_STEPS)
    agreement = first_step_agreement("train", unfused, g_unfused, fused, g_fused,
                                     "fused vs unfused")
    return {"fused": fused, "unfused": unfused, "first_step_agreement": agreement}


def zero_grad_bias(key: str, n_blocks: int) -> bool:
    """Conv biases followed by complex BN: every block's but the last decoder's."""
    return key.endswith("_conv.bias") and not key.startswith(f"decoder.{n_blocks - 1}.")


def train_reference_phase(dev) -> dict:
    """The small f32 fused DCCRN: one train step on the card through the f32
    variants of all eight kernels vs the same step on the CPU (the plain
    versions, which the CPU tests hold against the JAX package): loss, grad
    norm, every gradient and every updated parameter and statistic within
    LEAF_RTOL of each leaf's largest magnitude (``card_vs_cpu_step``; a conv
    bias that complex BN follows has an exactly zero true gradient, so both
    sides hold rounding residue, compared at the global scale)."""
    rng = np.random.default_rng(SEED + 3)
    mixture = (0.5 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 8000))).astype(np.float32)
    n_blocks = len(SMALL_FUSED["kernel_num"])
    return card_vs_cpu_step("train reference: small f32 fused DCCRN", Config(
        {"model": SMALL_FUSED}), None, mixture, sources, {}, BLOCK_STEP, seed=5,
        zero_grad=lambda key: zero_grad_bias(key, n_blocks))


def reference_phase(dev) -> dict:
    """Small f32 DCCRN on the card (kernels on) vs the same weights on the
    CPU (plain versions), which the CPU tests hold against the JAX package;
    unfused, then with ``use_fused_blocks`` (three launches of each block
    kernel)."""
    wav = utterance(np.random.default_rng(SEED), 8000)[:, 0] * 0.5
    errors = {}
    for fused in (False, True):
        cfg = Config({"name": "dccrn", "kernel_num": [16, 32, 64], "rnn_units": 64,
                      "dtype": "float32", "use_fused_blocks": fused})
        card, _ = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        cpu, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        reset_launches()
        with torch.inference_mode():
            got = card(torch.from_numpy(wav).to(dev)).cpu()
            want = cpu(torch.from_numpy(wav))
        launches = read_launches()
        blocks = (launches["conv_block"], launches["deconv_block"])
        err = (got - want).abs().max().item()
        tag = "fused" if fused else "unfused"
        if not torch.isfinite(got).all() or err > F32_ATOL:
            fail(f"small f32 {tag} DCCRN on the card vs CPU: max abs err {err} > {F32_ATOL}")
        if blocks != ((3, 3) if fused else (0, 0)):
            fail(f"small f32 {tag} DCCRN launched the block kernels {blocks} times")
        log(f"reference: small f32 {tag} DCCRN card vs CPU max abs err {err:.3e} "
            f"(atol {F32_ATOL}); block kernel launches {blocks}")
        errors[tag] = err
    return errors


def load_model(dev, path=CONFIG, **overrides):
    """The config at ``path`` (default configs/dccrn_vbd.yaml) at full width
    with ``overrides`` on its model section, random weights from the
    config's seed (the same for every override)."""
    cfg = load_config(path)
    for key, value in overrides.items():
        setattr(cfg.model, key, value)
    gen = torch.Generator().manual_seed(int(cfg.seed))
    model, spec = build_model(cfg.model, device=dev, generator=gen)
    return cfg, model, spec


def serve(model, spec, cfg, requests, dev):
    """Each request through evaluate_utterance; host clock, ending in a sync."""
    outs, times = [], []
    for mixture in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(evaluate_utterance(mixture, model, spec, cfg, device=dev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return outs, times


def agree(outs, refs, what: str) -> list:
    """bf16 agreement: mean error <= 2% and max <= 20% of the reference's RMS."""
    agreement = []
    for out, ref in zip(outs, refs):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{what}: bad output, shape {out.shape}, finite {np.isfinite(out).all()}")
        rms = float(np.sqrt(np.mean(ref**2)))
        err = np.abs(out - ref)
        agreement.append({"rms": rms, "mean_err": float(err.mean()),
                          "max_err": float(err.max())})
        if err.mean() > BF16_MEAN_FRAC * rms or err.max() > BF16_MAX_FRAC * rms:
            fail(f"{what}: {agreement[-1]}")
    return agreement


def f32_serve_agreement(tag: str, outs, refs) -> list:
    """Every sample of each served request within F32_ATOL of its
    reference's peak."""
    agreement = []
    for out, ref in zip(outs, refs):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{tag}: bad output, shape {out.shape}, finite {np.isfinite(out).all()}")
        agreement.append({"max_err": float(np.abs(out - ref).max()),
                          "peak": float(np.abs(ref).max())})
    if any(a["max_err"] > F32_ATOL * a["peak"] for a in agreement):
        fail(f"{tag}: kernel path vs plain path beyond {F32_ATOL} of the peak: {agreement}")
    return agreement


COUNTED = counted()


def reset_launches() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    lstm_k.lstm_fwd.reverse_launches = lstm_k.lstm_bwd.reverse_launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def slice_result(tag, model, cfg, requests, times, peak_gib, launches, stages) -> dict:
    n_params = sum(p.numel() for p in model.parameters())
    ms = 1e3 * statistics.mean(times[1:])
    result = {
        "config": "configs/dccrn_vbd.yaml", "params": n_params, "requests": len(requests),
        "audio_s": SECONDS, "windows_per_request": stages["windows"],
        "request_ms": [1e3 * t for t in times],
        "ms_per_request": ms, "utt_per_s": 1e3 / ms, "rtf": ms / 1e3 / SECONDS,
        "peak_mem_gib": peak_gib, "launches": launches,
        "stage_ms": stages["ms"], "device_busy_ms": stages["device_busy_ms"],
        "device_busy_share": stages["device_busy_share"], "top_kernels": stages["top_kernels"],
    }
    log(f"{tag}: DCCRN {n_params} params (bf16 compute), {len(requests)} requests of "
        f"{SECONDS:g} s = {stages['windows']} windows each; request ms "
        f"{[round(x, 1) for x in result['request_ms']]} (first includes warm-up); "
        f"warm {ms:.1f} ms/request = {result['utt_per_s']:.2f} utt/s, RTF {result['rtf']:.4f}; "
        f"peak {peak_gib:.2f} GiB; launches {launches}")
    log_stages(tag, stages)
    return result


def log_stages(tag: str, stages: dict) -> None:
    log(f"{tag}: stage ms of one request's model call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages["ms"].items()))
    for kind, row in stages.get("layout_ms", {}).items():
        log(f"{tag}: {kind} attention layer (B' {row['batch']}, L {row['length']}, width "
            f"{row['width']} bf16): q, k, v .contiguous() {row['qkv_contiguous_ms']:.3f} ms, "
            f"kernel {row['kernel_ms']:.3f} ms, output transpose {row['out_transpose_ms']:.3f} "
            f"ms; the copies {row['copies_per_request_ms']:.2f} ms a request")
    share = stages["device_busy_share"]
    log(f"{tag}: device busy {stages['device_busy_ms']:.2f} ms of the model call "
        f"({'not measured' if share is None else f'{share:.3f}'}); top kernels "
        + "; ".join(f"{t['kernel']} {t['ms']:.2f} ms x{t['count']}"
                    for t in stages["top_kernels"]))


def slice_phase(dev):
    """The unfused path (STFT and mask-E kernels) and its plain twin.
    Returns (result, the kernel path's outputs, the requests)."""
    cfg, model, spec = load_model(dev)
    rng = np.random.default_rng(SEED)
    n = int(SECONDS * cfg.dset.sample_rate)
    requests = [utterance(rng, n) for _ in range(N_REQUESTS)]

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, times = serve(model, spec, cfg, requests, dev)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if min(launches["stft"], launches["mask_e"]) == 0:
        fail(f"the main path did not launch every kernel: {launches}")
    if launches["conv_block"] or launches["deconv_block"]:
        fail(f"the unfused path launched a block kernel: {launches}")

    model.use_stft_kernel = model.use_mask_kernel = False
    plain_outs, plain_times = serve(model, spec, cfg, requests, dev)
    model.use_stft_kernel = model.use_mask_kernel = True
    if read_launches() != launches:
        fail("the plain path launched a kernel")
    agreement = agree(outs, plain_outs, "kernel path vs plain path")

    stages = stage_split(model, cfg, requests[0], dev)
    result = slice_result("slice", model, cfg, requests, times, peak_gib, launches, stages)
    result["plain_request_ms"] = [1e3 * t for t in plain_times]
    result["agreement"] = agreement
    log(f"slice: plain path request ms {[round(x, 1) for x in result['plain_request_ms']]}; "
        f"kernel vs plain {agreement}")
    return result, outs, requests


def fused_slice_phase(dev, unfused_outs, requests) -> dict:
    """``use_fused_blocks = True``: the same requests and weights through all
    four kernels, held against the unfused kernel path's outputs; then the
    stage split of the unfused model with ``cbn_fold = True``."""
    cfg, model, spec = load_model(dev, use_fused_blocks=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, times = serve(model, spec, cfg, requests, dev)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = dict.fromkeys(COUNTED, 0)  # serving launches no backward kernel
    want.update({"stft": N_REQUESTS, "mask_e": N_REQUESTS, "conv_block": 6 * N_REQUESTS,
                 "deconv_block": 6 * N_REQUESTS})
    if launches != want:
        fail(f"the fused path's launches {launches}, want {want}")
    agreement = agree(outs, unfused_outs, "fused path vs unfused kernel path")
    stages = stage_split(model, cfg, requests[0], dev)
    result = slice_result("fused", model, cfg, requests, times, peak_gib, launches, stages)
    result["agreement_with_unfused"] = agreement
    log(f"fused: vs the unfused kernel path {agreement}")
    del model

    cfg, model, _ = load_model(dev, cbn_fold=True)
    fold = stage_split(model, cfg, requests[0], dev)
    log_stages("cbn_fold", fold)
    result["cbn_fold_stage_ms"] = fold["ms"]
    return result


def stage_split(model, cfg, mixture, dev) -> dict:
    """CUDA-event split of the model call on one request's window batch."""
    window = int(cfg.dset.sample_rate * cfg.model.segment)
    stride = int(cfg.model.win_length)
    x = torch.from_numpy(mixture[0]).to(dev)  # [1, T]
    x = (x - x.mean()) / (x.std() + 1e-9)
    n_win = -(-(x.shape[-1] - window) // stride) + 1
    n_win = -(-n_win // 4) * 4
    wav = extract_windows(x, window, stride, n_win).reshape(n_win, window).contiguous()
    names = ["stft", "encoder", "lstm", "decoder", "mask", "istft"]
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            events[0].record()
            real, imag = model.analyze(wav)
            events[1].record()
            skips = model.encode(real, imag)
            events[2].record()
            x2 = model.recur(skips[-1])
            events[3].record()
            mask_r, mask_i = model.decode(x2, skips)
            events[4].record()
            spec = model.apply_mask(real, imag, mask_r, mask_i)
            events[5].record()
            out = model.synthesize(spec, window)
            events[6].record()
            torch.cuda.synchronize()
        whole = model(wav)
    if not torch.equal(out, whole):
        diff = (out - whole).abs().max().item()
        if diff > 1e-2:
            fail(f"stage composition differs from forward(): {diff}")
    ms = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}
    ms["total"] = events[0].elapsed_time(events[-1])
    def call():
        with torch.inference_mode():
            model(wav)

    busy_ms, top = device_busy(call)
    return {"windows": n_win, "ms": ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / ms["total"] if busy_ms else None,
            "top_kernels": top}


def device_busy(fn):
    """Sum of kernel time on the card over one call of ``fn`` (a model call
    or a train step; torch.profiler), and the kernels that take most of it.
    The profiler slows the host, so the share is taken against the
    unprofiled call's time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(row):
        return getattr(row, "self_device_time_total", 0) or getattr(
            row, "self_cuda_time_total", 0)

    rows = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy_ms = sum(device_us(r) for r in rows) / 1e3
    top = [{"kernel": r.key[:90], "ms": device_us(r) / 1e3, "count": r.count} for r in rows[:8]]
    return busy_ms, top


# -- the LSTM recurrence kernels ----------------------------------------------

def lstm_work(steps, batch, hidden, backward=False, itemsize=2):
    """(FLOPs, bytes) of one recurrence launch: the step products 2 B H 4H
    a step; sequences of ``itemsize`` bytes read or written once (forward:
    x_proj and the weights in, h, c, gates out; backward: gates, c, c_prev,
    dout and the weights in, dgates out), f32 states."""
    flops = 2.0 * steps * batch * hidden * 4 * hidden
    seq = itemsize * steps * batch * hidden
    gates = itemsize * steps * batch * 4 * hidden
    weights, states = itemsize * 4.0 * hidden * hidden, 4.0 * batch * hidden
    if backward:
        nbytes = 2 * gates + 3 * seq + weights + 4 * states
    else:
        nbytes = 2 * gates + 2 * seq + weights + 2 * states
    return flops, nbytes


def lstm_bound(row, backward=False):
    """The case's least time: FLOPs at the design's peak rate (bf16 tensor
    cores; f32: three TF32 products a product for the split-f32 and wide
    designs, f32 FMA for the first) against its bytes at the HBM rate. An
    f32 case reports both bounds."""
    bf16 = row["dtype"] == "bfloat16"
    flops, nbytes = lstm_work(row["steps"], row["batch"], row["hidden"], backward,
                              2 if bf16 else 4)
    row["gflop"] = flops / 1e9
    row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    if bf16:
        row["flops_bound_ms"] = flops / BF16_FLOPS_PER_S * 1e3
    else:
        row["split_f32_bound_ms"] = max(3 * flops / TF32_FLOPS_PER_S * 1e3, row["bytes_bound_ms"])
        row["f32_fma_bound_ms"] = max(flops / F32_FLOPS_PER_S * 1e3, row["bytes_bound_ms"])
        row["flops_bound_ms"] = (3 * flops / TF32_FLOPS_PER_S if row["design"] in ("f32", "wide")
                                 else flops / F32_FLOPS_PER_S) * 1e3
    row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
    row["bound_by"] = "operations" if row["flops_bound_ms"] > row["bytes_bound_ms"] else "bytes"
    row["us_per_step"] = row["ms"] * 1e3 / row["steps"]


def lstm_inputs(gen, steps, batch, hidden, dtype, dev, state=False):
    x_proj = torch.randn(steps, batch, 4 * hidden, device=dev, generator=gen).to(dtype)
    w_hh = (torch.randn(hidden, 4 * hidden, device=dev, generator=gen) / hidden**0.5).to(dtype)
    h0 = 0.5 * torch.randn(batch, hidden, device=dev, generator=gen) if state else torch.zeros(
        batch, hidden, device=dev)
    c0 = 0.5 * torch.randn(batch, hidden, device=dev, generator=gen) if state else torch.zeros(
        batch, hidden, device=dev)
    return x_proj, w_hh, h0.to(dtype), c0.to(dtype)


def lstm_close(got, want, bf16: bool):
    """(max abs error, mean abs error) of the forward's outputs; fails past
    the stated bounds."""
    worst, mean = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        bound = LSTM_RTOL * w.abs() + LSTM_ATOL if bf16 else LSTM_F32_TOL * (1 + w.abs())
        if g.shape != w.shape or not bool((err <= bound).all()):
            return float("inf"), float("inf")
        worst, mean = max(worst, err.max().item()), max(mean, err.mean().item())
    if bf16 and mean > LSTM_MEAN:
        return worst, float("inf")
    return worst, mean


# (case, T, B, H, dtype, reversed, the layer's input width for cuDNN): CRN's
# serving and training layer, rnn-stft-mask's serving layer both ways,
# mel-rnn's f32 training layer and rnn-stft-mask's training layer both ways
LSTM_FWD_CASES = (
    ("crn serve", 501, 192, 1792, torch.bfloat16, False, 1792),
    ("crn train", 501, 16, 1792, torch.bfloat16, False, 1792),
    ("rnn-stft-mask serve", 501, 384, 896, torch.bfloat16, False, 257),
    ("rnn-stft-mask serve, reversed", 501, 384, 896, torch.bfloat16, True, 257),
    ("mel-rnn train", 501, 16, 256, torch.float32, False, 257),
    ("rnn-stft-mask train", 501, 16, 896, torch.bfloat16, False, 257),
    ("rnn-stft-mask train, reversed", 501, 16, 896, torch.bfloat16, True, 257),
    ("mel-rnn serve", 501, 192, 256, torch.float32, False, 257),
    # Demucs's DConv BLSTMs (layers 4 and 5 of configs/demucs_clarity.yaml):
    # f32 on its path (GroupNorm promotes the bf16 conv output, as flax
    # does); bf16 at the same shapes beside them
    ("demucs serve, layer 4", 124, 192, 256, torch.float32, False, 256),
    ("demucs serve, layer 4, reversed", 124, 192, 256, torch.float32, True, 256),
    ("demucs serve, layer 5", 30, 192, 512, torch.float32, False, 512),
    ("demucs train, layer 4", 124, 8, 256, torch.float32, False, 256),
    ("demucs train, layer 5", 30, 8, 512, torch.float32, False, 512),
    ("demucs serve, layer 4, bf16", 124, 192, 256, torch.bfloat16, False, 256),
    ("demucs serve, layer 5, bf16", 30, 192, 512, torch.bfloat16, False, 512),
    ("demucs train, layer 4, bf16", 124, 8, 256, torch.bfloat16, False, 256),
    ("demucs train, layer 5, bf16", 30, 8, 512, torch.bfloat16, False, 512),
    # the wide design (LSTM_WIDE_TAGS): CRN at its class default f32, and
    # Demucs's bottleneck BLSTM (configs/demucs_clarity.yaml with
    # lstm_layers: 2; 2048 units, T 30 for a 4 s window), f32 on its path
    # and bf16 beside it
    ("crn serve, f32", 501, 192, 1792, torch.float32, False, 1792),
    ("crn train, f32", 501, 16, 1792, torch.float32, False, 1792),
    ("demucs bottleneck serve", 30, 192, 2048, torch.float32, False, 2048),
    ("demucs bottleneck serve, reversed", 30, 192, 2048, torch.float32, True, 2048),
    ("demucs bottleneck serve, bf16", 30, 192, 2048, torch.bfloat16, False, 2048),
    ("demucs bottleneck serve, bf16, reversed", 30, 192, 2048, torch.bfloat16, True, 2048))
LSTM_BWD_CASES = (
    ("crn train", 501, 16, 1792, torch.bfloat16, False, 1792),
    ("mel-rnn train", 501, 16, 256, torch.float32, False, 257),
    ("rnn-stft-mask train", 501, 16, 896, torch.bfloat16, False, 257),
    ("rnn-stft-mask train, reversed", 501, 16, 896, torch.bfloat16, True, 257),
    ("demucs train, layer 4", 124, 8, 256, torch.float32, False, 256),
    ("demucs train, layer 5", 30, 8, 512, torch.float32, False, 512),
    ("demucs train, layer 4, bf16", 124, 8, 256, torch.bfloat16, False, 256),
    ("demucs train, layer 5, bf16", 30, 8, 512, torch.bfloat16, False, 512),
    ("crn train, f32", 501, 16, 1792, torch.float32, False, 1792),
    ("demucs bottleneck train", 30, 8, 2048, torch.float32, False, 2048),
    ("demucs bottleneck train, reversed", 30, 8, 2048, torch.float32, True, 2048),
    ("demucs bottleneck train, bf16", 30, 8, 2048, torch.bfloat16, False, 2048))
# the cases whose slice no other design holds: they must take the wide
# design (and have no first design to time beside it)
LSTM_WIDE_TAGS = frozenset(case[0] for case in LSTM_FWD_CASES + LSTM_BWD_CASES
                           if case[0].startswith(("crn serve, f32", "crn train, f32",
                                                  "demucs bottleneck")))


def lstm_want_design(tag: str, bf16: bool) -> str:
    """The design a case of LSTM_*_CASES must take: the wide design for this
    slice's widths, else bf16's ring and f32's split-f32 design."""
    return "wide" if tag in LSTM_WIDE_TAGS else "ring" if bf16 else "f32"


def lstm_fwd_first(x_proj, w_hh, h0, c0, reverse):
    """lstm_fwd's launch with w_hhᵀ 4 bytes off a 16-byte address, which
    takes the first design (the wrapper's own w_hhᵀ is aligned); not
    counted in lstm_fwd.launches."""
    steps, batch, g4 = x_proj.shape
    w_t = torch.empty(w_hh.numel() + 1, device=x_proj.device, dtype=x_proj.dtype)[1:]
    w_t = w_t.view(g4, g4 // 4).copy_(w_hh.t())
    c = c0.float().clone()
    h_seq = x_proj.new_empty((steps, batch, g4 // 4))
    c_seq, gates = torch.empty_like(h_seq), torch.empty_like(x_proj)
    bar = torch.zeros(2, dtype=torch.int32, device=x_proj.device)
    lstm_k._launch("lstm_fwd", [int(x_proj.dtype == torch.bfloat16), x_proj.data_ptr(),
                                w_t.data_ptr(), h0.data_ptr(), c.data_ptr(), h_seq.data_ptr(),
                                c_seq.data_ptr(), gates.data_ptr(), bar.data_ptr(), steps, batch,
                                g4 // 4, int(reverse)], x_proj)
    return h_seq, c_seq, gates


def lstm_fwd_case(dev, gen, tag, steps, batch, hidden, dtype, reverse, in_dim) -> dict:
    """The forward kernel vs its plain version at one shape, timed beside
    cuDNN's torch.nn.LSTM forward on the layer's input (more work: it
    includes the input projection; a reversed case against the same
    unidirectional call). bf16 takes the ring, f32 the split-f32 design,
    the widths of LSTM_WIDE_TAGS the wide design; an f32 case of the
    split-f32 design also times the first design in the same run (w_hhᵀ 4
    bytes off a 16-byte address takes it)."""
    bf16 = dtype == torch.bfloat16
    args = lstm_inputs(gen, steps, batch, hidden, dtype, dev)
    design = lstm_k.lstm_fwd_design(dtype, hidden, batch)[0]
    got = lstm_k.lstm_fwd(*args, reverse)
    want = lstm_k.fused_lstm_plain(*args, reverse)
    torch.cuda.synchronize()
    err, mean = lstm_close(got, want, bf16)
    if design != lstm_want_design(tag, bf16) or not np.isfinite(mean):
        fail(f"lstm_fwd ({tag}, {design}) disagrees with plain: max abs err {err}, mean {mean} "
             + (f"(bounds |d| <= {LSTM_RTOL:g}|ref| + {LSTM_ATOL:g}, mean {LSTM_MEAN:g})" if bf16
                else f"(bound |d| <= {LSTM_F32_TOL:g}(1 + |ref|))"))
    first = {}
    if design == "f32":
        if lstm_k.lstm_fwd_design(dtype, hidden, batch, aligned=False)[0] != "first":
            fail("lstm_fwd: an unaligned w_hhᵀ does not take the first design")
        first_err, _ = lstm_close(lstm_fwd_first(*args, reverse), want, bf16)
        if not np.isfinite(first_err):
            fail(f"lstm_fwd first design ({tag}) disagrees with plain (bound |d| <= "
                 f"{LSTM_F32_TOL:g}(1 + |ref|))")
        first = {"first_design_max_abs_err": first_err,
                 "first_design_ms": cuda_ms(lambda: lstm_fwd_first(*args, reverse), reps=3,
                                            warmup=1)}
    del got, want
    cudnn = torch.nn.LSTM(in_dim, hidden).to(dev, dtype)
    x = torch.randn(steps, batch, in_dim, device=dev, generator=gen).to(dtype)
    with torch.no_grad():
        library = cuda_ms(lambda: cudnn(x), reps=3, warmup=1)
    row = {"case": tag, "steps": steps, "batch": batch, "hidden": hidden,
           "dtype": str(dtype).split(".")[-1], "reverse": reverse, "design": design,
           "max_abs_err": err, "mean_abs_err": mean,
           "ms": cuda_ms(lambda: lstm_k.lstm_fwd(*args, reverse), reps=3, warmup=1),
           "plain_ms": cuda_ms(lambda: lstm_k.fused_lstm_plain(*args, reverse), reps=1,
                               warmup=0),
           "library_ms": library, **first}
    lstm_bound(row)
    log(f"lstm_fwd {tag}: T {steps}, B {batch}, H {hidden} {row['dtype']}, design {design}; "
        f"max abs err {err:.3e}, mean {mean:.2e}; kernel {row['ms']:.3f} ms = "
        f"{row['us_per_step']:.2f} us a step ({row['gflop'] / row['ms']:.2f} TFLOP/s), "
        f"plain {row['plain_ms']:.3f} ms, cuDNN "
        f"nn.LSTM forward ({in_dim} -> {hidden}) {library:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
        + (f"; the first design in the same run {row['first_design_ms']:.3f} ms" if first else "")
        + lstm_f32_bounds(row))
    return row


def lstm_f32_bounds(row) -> str:
    """Both bounds of an f32 case (none for bf16)."""
    if row["dtype"] != "float32":
        return ""
    return (f"; bounds split-f32 {row['split_f32_bound_ms']:.4f} ms, f32 FMA "
            f"{row['f32_fma_bound_ms']:.4f} ms")


def lstm_bwd_case(dev, gen, tag, steps, batch, hidden, dtype, reverse, in_dim,
                  first_design=False) -> dict:
    """The backward kernel vs its plain version at one shape, on the plain
    forward's outputs: dgates, dh0 and dc0 within LSTM_BWD_RTOL (bf16, the
    ring) or LSTM_F32_TOL (f32, the split-f32 design) of each one's largest;
    timed beside cuDNN's nn.LSTM forward + backward and its backward alone.
    ``first_design`` also times the first design in the same run (w_hh 2
    or 4 bytes off a 16-byte address takes it)."""
    bf16 = dtype == torch.bfloat16
    tol = LSTM_BWD_RTOL if bf16 else LSTM_F32_TOL
    x_proj, w_hh, h0, c0 = lstm_inputs(gen, steps, batch, hidden, dtype, dev)
    _, c_seq, gates = lstm_k.fused_lstm_plain(x_proj, w_hh, h0, c0, reverse)
    c_prev = lstm_k.shift_prev(c_seq, c0, reverse)
    dout = torch.randn(steps, batch, hidden, device=dev, generator=gen).to(dtype)
    d_last = torch.randn(batch, hidden, device=dev, generator=gen)
    zero = torch.zeros(batch, hidden, device=dev)
    bwd_args = (gates, c_seq, c_prev, dout, w_hh, zero, d_last)
    design = lstm_k.lstm_bwd_design(dtype, hidden, batch)[0]
    got = lstm_k.lstm_bwd(*bwd_args, reverse)
    want = lstm_k.lstm_bwd_plain(*bwd_args, reverse)
    torch.cuda.synchronize()
    rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
           for g, w in zip(got, want)]
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    # the Demucs DConv bf16 shapes, on no path, take whichever the plan
    # picks; every other case the design lstm_want_design names
    dconv_bf16 = bf16 and tag.startswith("demucs") and tag not in LSTM_WIDE_TAGS
    want_design = design if dconv_bf16 else lstm_want_design(tag, bf16)
    if design != want_design or not max(rel) <= tol:
        fail(f"lstm_bwd {tag} ({design}) disagrees with plain: dgates, dh0, dc0 {rel} of their "
             f"largest (bound {tol:g})")
    row = {"case": tag, "steps": steps, "batch": batch, "hidden": hidden,
           "dtype": str(dtype).split(".")[-1], "reverse": reverse, "design": design,
           "rel_err": rel, "max_abs_err": err}
    if first_design:
        w_off = torch.empty(w_hh.numel() + 1, device=dev, dtype=dtype)[1:].view_as(w_hh)
        first_args = (*bwd_args[:4], w_off.copy_(w_hh), *bwd_args[5:])
        if lstm_k.lstm_bwd_design(dtype, hidden, batch, aligned=False)[0] != "first":
            fail("lstm_bwd: an unaligned w_hh does not take the first design")
        first = lstm_k.lstm_bwd(*first_args, reverse)
        row["first_design_rel_err"] = [
            ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            for g, w in zip(first, want)]
        if not max(row["first_design_rel_err"]) <= tol:
            fail(f"lstm_bwd first design disagrees with plain: {row['first_design_rel_err']} "
                 f"(bound {tol:g})")
        row["first_design_ms"] = cuda_ms(lambda: lstm_k.lstm_bwd(*first_args, reverse), reps=3,
                                         warmup=1)
        del first, first_args, w_off
    del got, want
    cudnn = torch.nn.LSTM(in_dim, hidden).to(dev, dtype)
    x = torch.randn(steps, batch, in_dim, device=dev, generator=gen).to(dtype).requires_grad_()
    g_out = torch.randn(steps, batch, hidden, device=dev, generator=gen).to(dtype)

    def cudnn_fwd_bwd():
        cudnn(x)[0].backward(g_out)

    y = cudnn(x)[0]  # cuDNN's backward alone: one forward, then its graph again and again
    leaves = (x, *cudnn.parameters())
    row.update(ms=cuda_ms(lambda: lstm_k.lstm_bwd(*bwd_args, reverse), reps=3, warmup=1),
               plain_ms=cuda_ms(lambda: lstm_k.lstm_bwd_plain(*bwd_args, reverse), reps=1,
                                warmup=0),
               library_ms=cuda_ms(cudnn_fwd_bwd, reps=3, warmup=1),
               cudnn_bwd_ms=cuda_ms(lambda: torch.autograd.grad(y, leaves, g_out,
                                                                retain_graph=True),
                                    reps=3, warmup=1))
    lstm_bound(row, backward=True)
    log(f"lstm_bwd {tag}: T {steps}, B {batch}, H {hidden} {row['dtype']}, design {design}; "
        f"dgates, dh0, dc0 within {[f'{r:.2e}' for r in rel]} of their largest (bound "
        f"{tol:g}); kernel {row['ms']:.3f} ms = {row['us_per_step']:.2f} us a step, plain "
        f"{row['plain_ms']:.3f} ms, cuDNN nn.LSTM ({in_dim} -> {hidden}) forward + backward "
        f"{row['library_ms']:.3f} ms, its backward alone {row['cudnn_bwd_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
        + (f"; the first design in the same run {row['first_design_ms']:.3f} ms (within "
           f"{[f'{r:.2e}' for r in row['first_design_rel_err']]})" if first_design else "")
        + lstm_f32_bounds(row))
    return row


def lstm_kernel_phase(dev) -> dict:
    """Both LSTM kernels vs their plain versions on the card at every case
    of LSTM_FWD_CASES / LSTM_BWD_CASES, the first designs timed beside the
    others at CRN's bf16 training shape (the backward) and at every f32
    case of the split-f32 design (both), and a small f32 case with an
    initial state both ways. The kernel line's numbers are CRN's (serve for
    the forward, train for the backward); every case rides along, the wide
    design's (LSTM_WIDE_TAGS) among them."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = [lstm_fwd_case(dev, gen, *case) for case in LSTM_FWD_CASES]
    bwd_rows = [lstm_bwd_case(dev, gen, *case,
                              first_design=case[0] not in LSTM_WIDE_TAGS and (
                                  case[0] == "crn train" or case[4] == torch.float32))
                for case in LSTM_BWD_CASES]

    # small f32 with an initial state, both directions, forward and backward
    for reverse in (False, True):
        args = lstm_inputs(gen, 64, 8, 256, torch.float32, dev, state=True)
        got = lstm_k.lstm_fwd(*args, reverse)
        want = lstm_k.fused_lstm_plain(*args, reverse)
        err, _ = lstm_close(got, want, False)
        c_prev = lstm_k.shift_prev(want[1], args[3], reverse)
        dout = torch.randn_like(want[0])
        d_last = torch.randn(8, 256, device=dev, generator=gen)
        b_args = (want[2], want[1], c_prev, dout, args[1], d_last, d_last)
        rel = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(lstm_k.lstm_bwd(*b_args, reverse),
                                  lstm_k.lstm_bwd_plain(*b_args, reverse)))
        if not np.isfinite(err) or rel > LSTM_F32_TOL:
            fail(f"f32 LSTM kernels (reverse {reverse}) disagree with plain: forward {err}, "
                 f"backward {rel} (bound {LSTM_F32_TOL:g})")
        log(f"lstm f32 T 64, B 8, H 256, initial state, reverse {reverse}: forward max abs err "
            f"{err:.2e}, backward {rel:.2e} of the largest (bound {LSTM_F32_TOL:g})")

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    shown = ("case", "dtype", "batch", "hidden", "reverse", "design", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "first_design_ms",
             "split_f32_bound_ms", "f32_fma_bound_ms")
    return {
        "lstm_fwd": {
            "name": "lstm_fwd", "route": "cuda",
            "source": "speech_enhancement_torch/kernels/csrc/lstm_fwd.cu",
            "replaces": "speech_enhancement_tpu/ops/pallas/lstm.py:116",
            "shape": "CRN serve: T 501, B 192, H 1792 bf16 (one layer)",
            "tolerance": f"|d| <= {LSTM_RTOL:g}|ref| + {LSTM_ATOL:g}, mean <= {LSTM_MEAN:g}",
            **{k: rows[0][k] for k in keys},
            "cases": [{k: r[k] for k in shown if k in r} for r in rows]},
        "lstm_bwd": {
            "name": "lstm_bwd", "route": "cuda",
            "source": "speech_enhancement_torch/kernels/csrc/lstm_bwd.cu",
            "replaces": "speech_enhancement_tpu/ops/pallas/lstm.py:148",
            "shape": "CRN train: T 501, B 16, H 1792 bf16 (one layer)",
            "tolerance": f"{LSTM_BWD_RTOL:g} of each output's largest",
            **{k: bwd_rows[0][k] for k in keys},
            "cases": [{k: r[k] for k in shown if k in r} for r in bwd_rows]},
    }


def crn_stage_split(model, cfg, mixture, dev) -> dict:
    """CUDA-event split of one request's model call for an stft-domain
    model (CRN): STFT, encoder, LSTM, decoder, mask + iSTFT."""
    window = int(cfg.dset.sample_rate * cfg.model.segment)
    stride = int(cfg.model.win_length)
    x = torch.from_numpy(mixture[0]).to(dev)  # [C, T]
    x = (x - x.mean()) / (x.std() + 1e-9)
    n_win = -(-(x.shape[-1] - window) // stride) + 1
    n_win = -(-n_win // 4) * 4
    wav = extract_windows(x, window, stride, n_win).contiguous()  # [N, C, W]
    names = ["stft", "encoder", "lstm", "decoder", "mask_istft"]
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            events[0].record()
            spec = stft_custom(wav, cfg.model)
            events[1].record()
            skips = model.encode(model.magnitude(spec))
            events[2].record()
            mid = model.recur(skips[-1])
            events[3].record()
            mask = model.decode(mid, skips)
            events[4].record()
            out = istft_custom(mask[..., None] * spec, window, cfg.model)
            events[5].record()
            torch.cuda.synchronize()
    ms = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}
    ms["total"] = events[0].elapsed_time(events[-1])

    def call():
        with torch.inference_mode():
            istft_custom(model(stft_custom(wav, cfg.model)), window, cfg.model)

    busy_ms, top = device_busy(call)
    if not torch.isfinite(out).all():
        fail("CRN stage split: non-finite output")
    return {"windows": n_win, "ms": ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / ms["total"] if busy_ms else None, "top_kernels": top}


def serve_family(tag, dev, path, requests, want_launches, stage_fn=None,
                 plain=(("fused_rnn", False),), f32=False, **overrides) -> dict:
    """Serve ``requests`` with the config at ``path`` and ``overrides`` (its
    kernels as the config sets them) and again with the overrides ``plain``
    too (default fused_rnn = False, the plain loop), the same weights;
    checks the first run's launches and the agreement: the bf16 bound, or
    with ``f32`` every sample within F32_ATOL of the reference's peak."""
    cfg, model, spec = load_model(dev, path, **overrides)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, times = serve(model, spec, cfg, requests, dev)
    launches = read_launches()
    reversed_launches = lstm_k.lstm_fwd.reverse_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    want = dict.fromkeys(COUNTED, 0)
    want.update(want_launches)
    if launches != want:
        fail(f"{tag}: launches {launches}, want {want}")
    for out, req in zip(outs, requests):
        shape = ((1, model.num_spk) if hasattr(model, "num_spk") else (1,)) + req.shape[1:]
        if out.shape != shape or not np.isfinite(out).all():
            fail(f"{tag}: output shape {out.shape} (want {shape}), finite {np.isfinite(out).all()}")
    stages = stage_fn(model, cfg, requests[0], dev) if stage_fn else None
    del model
    torch.cuda.reset_peak_memory_stats()
    _, plain_model, _ = load_model(dev, path, **{**overrides, **dict(plain)})
    reset_launches()
    plain_outs, plain_times = serve(plain_model, spec, cfg, requests, dev)
    plain_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(read_launches().values()):
        fail(f"{tag}: the plain path launched a kernel: {read_launches()}")
    if f32:
        agreement = f32_serve_agreement(tag, outs, plain_outs)
    else:
        agreement = agree(outs, plain_outs, f"{tag}: kernel path vs plain path")
    del plain_model
    ms = 1e3 * statistics.mean(times[1:])
    result = {"config": os.path.relpath(path, ROOT), "params": n_params,
              "requests": len(requests), "audio_s": SECONDS,
              "request_ms": [1e3 * t for t in times], "ms_per_request": ms,
              "utt_per_s": 1e3 / ms, "rtf": ms / 1e3 / SECONDS, "peak_mem_gib": peak_gib,
              "launches": launches, "reverse_launches": reversed_launches,
              "plain_request_ms": [1e3 * t for t in plain_times], "plain_peak_mem_gib":
              plain_peak_gib, "agreement": agreement}
    log(f"{tag}: {n_params} params, {len(requests)} requests of {SECONDS:g} s; "
        f"request ms {[round(x, 1) for x in result['request_ms']]} (first includes warm-up); "
        f"warm {ms:.1f} ms/request = {result['utt_per_s']:.2f} utt/s, RTF {result['rtf']:.4f}; "
        f"peak {peak_gib:.2f} GiB; launches {launches}; plain path ({dict(plain)}) request ms "
        f"{[round(x, 1) for x in result['plain_request_ms']]}, peak {plain_peak_gib:.2f} GiB; "
        f"kernel vs plain {agreement}")
    if stages:
        result.update(stage_ms=stages["ms"], windows_per_request=stages["windows"],
                      device_busy_ms=stages["device_busy_ms"],
                      device_busy_share=stages["device_busy_share"],
                      top_kernels=stages["top_kernels"])
        if "layout_ms" in stages:
            result["layout_ms"] = stages["layout_ms"]
        log_stages(tag, stages)
    return result


def crn_slice_phase(dev) -> dict:
    """configs/crn_vbd.yaml at full width (bf16, fused_rnn) serving three
    10 s requests: two forward launches a request."""
    rng = np.random.default_rng(SEED)
    requests = [utterance(rng, int(SECONDS * 16000)) for _ in range(N_REQUESTS)]
    return serve_family("crn serve", dev, CRN_CONFIG, requests,
                        {"lstm_fwd": 2 * N_REQUESTS}, crn_stage_split)


def rnn_stft_mask_slice_phase(dev) -> dict:
    """configs/rnn_stft_mask_clarity.yaml at full width (three bidirectional
    LSTM layers of 896, bf16, fused_rnn) serving three stereo 10 s
    requests: six forward launches a request, three of them reversed."""
    rng = np.random.default_rng(SEED + 5)
    n = int(SECONDS * 16000)
    requests = [np.concatenate([utterance(rng, n), utterance(rng, n)], axis=1)
                for _ in range(N_REQUESTS)]
    result = serve_family("rnn-stft-mask serve", dev, MASK_CONFIG, requests,
                          {"lstm_fwd": 6 * N_REQUESTS})
    if result["reverse_launches"] != 3 * N_REQUESTS:
        fail(f"rnn-stft-mask serve: {result['reverse_launches']} reversed forward launches, "
             f"want {3 * N_REQUESTS}")
    return result


def crn_train_batch():
    """configs/crn_vbd.yaml's operating point: 16 f32 mixtures and targets
    of 4 s (speech-like targets, noisy mixtures), made with numpy."""
    rng = np.random.default_rng(SEED + 6)
    n = int(TRAIN_SECONDS * 16000)
    target = np.stack([utterance(rng, n)[0] for _ in range(CRN_TRAIN_BATCH)])  # [B, 1, n]
    mixture = (target + 0.1 * rng.standard_normal(target.shape)).astype(np.float32)
    return mixture, target[:, None].astype(np.float32)


def crn_train_phase(dev) -> dict:
    """Three CRN train steps at the config's operating point with the
    kernels (two forward and two backward launches a step), held on the
    first step against the plain loop (fused_rnn = False)."""
    mixture, sources = crn_train_batch()
    fused, g_fused = train_path("crn", dev, mixture, sources, CRN_CONFIG)
    expect_launches("crn train", fused["launches"], lstm_fwd=2 * TRAIN_STEPS,
                    lstm_bwd=2 * TRAIN_STEPS)
    # the backward kernel's share of a step, from the profiled step's kernels
    bwd_ms = sum(t["ms"] for t in fused["top_kernels"] if "lstm_bwd" in t["kernel"])
    fused["lstm_bwd_ms"] = bwd_ms
    fused["lstm_bwd_share_of_step"] = bwd_ms / fused["median_step_ms_2_to_3"]
    fused["lstm_bwd_share_of_busy"] = (bwd_ms / fused["device_busy_ms"]
                                       if fused["device_busy_ms"] else None)
    log(f"crn train: lstm_bwd (profiler) {bwd_ms:.2f} ms a step, "
        f"{fused['lstm_bwd_share_of_step']:.3f} of the median step, "
        + ("not measured" if fused["lstm_bwd_share_of_busy"] is None
           else f"{fused['lstm_bwd_share_of_busy']:.3f}") + " of the device-busy time")
    plain, g_plain = train_path("crn, plain loop", dev, mixture, sources, CRN_CONFIG,
                                fused_rnn=False)
    expect_launches("crn train, plain loop", plain["launches"])
    agreement = first_step_agreement("crn train", plain, g_plain, fused, g_fused,
                                     "kernels vs plain loop")
    return {"fused": fused, "plain": plain, "first_step_agreement": agreement}


def crn_reference_phase(dev) -> dict:
    """The small f32 CRN (n_fft 128: H = 256) with the kernels on the card vs
    the CPU path, which the CPU tests hold against JAX (``card_vs_cpu_step``:
    a served utterance within F32_ATOL, then one train step; each conv bias
    feeds a BatchNorm, so its true gradient is zero: compared at the global
    scale)."""
    cfg = Config({"model": SMALL_CRN, "dset": {"sample_rate": 16000, "norm": "z-score"}})
    wav = utterance(np.random.default_rng(SEED + 7), 12000)
    rng = np.random.default_rng(SEED + 8)
    mixture = (0.5 * rng.standard_normal((2, 1, 3968))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 3968))).astype(np.float32)
    return card_vs_cpu_step("crn reference: small f32 CRN (H 256)", cfg, wav, mixture, sources,
                            {"lstm_fwd": 2}, {"lstm_fwd": 2, "lstm_bwd": 2}, seed=6,
                            model_config=cfg.model,
                            zero_grad=lambda key: key.endswith(".conv.bias"))


# -- the attention kernels and Sepformer ---------------------------------------

def attention_registers() -> dict:
    """Registers and spill bytes of each attention kernel variant, from the
    ptxas report of the build (``mha_fwd_mma<32>``: the bf16 forward at
    depth tile 32; ``simt``: the f32 kernels)."""
    usage, current = {}, None
    for lib in ("attention_fwd", "attention_bwd"):
        for line in _build.build_log(lib).splitlines():
            found = re.search(
                r"Function properties for \S*?(mha_(?:fwd|bwd)_(?:mma|simt))ILi(\d+)E", line)
            if found:
                current = f"{found.group(1)}<{found.group(2)}>"
                usage[current] = {}
            elif current and "spill stores" in line:
                spills = re.findall(r"(\d+) bytes spill (stores|loads)", line)
                usage[current].update({f"spill_{kind}": int(n) for n, kind in spills})
            elif current and "Used" in line and "registers" in line:
                usage[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
                current = None
    return usage


def mha_work(batch, heads, length, depth, itemsize, backward=False):
    """(FLOPs, bytes) of one attention launch: Q K^T and P V (forward, 4 L^2 D
    a head), plus dP, dV, dQ and dK (backward, 10 L^2 D); q, k, v in and o
    out (forward), q, k, v, g in and dq, dk, dv out (backward), once each."""
    flops = (10.0 if backward else 4.0) * batch * heads * length * length * depth
    nbytes = (7.0 if backward else 4.0) * batch * heads * depth * length * itemsize
    return flops, nbytes


def chunked(fn, tensors, chunk=MHA_SLICE):
    """``fn`` over the sequences in slices of ``chunk`` (the plain versions'
    f32 [B', H, L, L] tensors do not fit at the full serving batch)."""
    return [fn(*(t[i:i + chunk] for t in tensors)) for i in range(0, tensors[0].shape[0], chunk)]


def attention_kernel_phase(dev) -> dict:
    """Both attention kernels vs their plain versions at Sepformer's intra
    (L 250) and inter (L 66) shapes (H 8, D 32) on MHA_SLICE sequences, in
    bf16 and f32, and at a ragged small case (L 50, D 16, B' 3, H 2); then
    their times at the full serving B' (forward: 12,672 intra, 48,000 inter
    sequences) and the training B' (backward: 264, 1,000), the plain
    versions' (in slices of MHA_SLICE sequences) and, as the library
    yardstick, F.scaled_dot_product_attention on [B', H, L, D]: forward for
    the forward kernel, forward + backward for the backward kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(batch, heads, length, depth, dtype, n):
        return [torch.randn(batch, heads * depth, length, device=dev, generator=gen).to(dtype)
                for _ in range(n)]

    checks = []
    for tag, batch, heads, length, depth in MHA_CHECKED:
        for dtype in (bf16, f32):
            q, k, v, g = inputs(batch, heads, length, depth, dtype, 4)
            got, want = attn_k.mha_fwd(q, k, v, heads), attn_k.fused_mha_packed_plain(q, k, v,
                                                                                     heads)
            grads, want_grads = attn_k.mha_bwd(q, k, v, g, heads), attn_k.mha_bwd_plain(
                q, k, v, g, heads)
            torch.cuda.synchronize()
            atol, rtol, grad_tol = MHA_TOL[dtype]
            diff = (got.float() - want.float()).abs()
            fwd_ok = bool((diff <= atol + rtol * want.float().abs()).all())
            rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(grads, want_grads)]
            row = {"case": tag, "batch": batch, "heads": heads, "length": length, "depth": depth,
                   "dtype": str(dtype), "max_abs_err": diff.max().item(), "grad_rel_err": rel,
                   "grad_max_abs_err": max((a.float() - b.float()).abs().max().item()
                                           for a, b in zip(grads, want_grads))}
            checks.append(row)
            log(f"attention {tag} B' {batch} H {heads} L {length} D {depth} {dtype}: forward max "
                f"abs err {row['max_abs_err']:.3e} (|d| <= {atol:g} + {rtol:g}|ref|); dq, dk, dv "
                f"within {[f'{r:.2e}' for r in rel]} of their largest (bound {grad_tol:g})")
            if not fwd_ok or not max(rel) <= grad_tol:
                fail(f"attention kernels ({tag}, {dtype}) disagree with their plain versions: "
                     f"{row}")
            del q, k, v, g, got, want, grads, want_grads

    timed = {}
    for tag, batch, length, backward in MHA_TIMED:
        heads, depth = 8, 32
        q, k, v, g = inputs(batch, heads, length, depth, bf16, 4)
        q4, k4, v4, g4 = (t.reshape(batch, heads, depth, length).transpose(2, 3).contiguous()
                          for t in (q, k, v, g))
        if backward:
            ms = cuda_ms(lambda: attn_k.mha_bwd(q, k, v, g, heads), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: chunked(
                lambda *t: attn_k.mha_bwd_plain(*t, heads), (q, k, v, g)), reps=2, warmup=1)
            q4.requires_grad_(), k4.requires_grad_(), v4.requires_grad_()
            library = cuda_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), reps=10, warmup=2)
        else:
            ms = cuda_ms(lambda: attn_k.mha_fwd(q, k, v, heads), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: chunked(
                lambda *t: attn_k.fused_mha_packed_plain(*t, heads), (q, k, v)), reps=2, warmup=1)
            with torch.no_grad():
                library = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps=10,
                                  warmup=2)
        flops, nbytes = mha_work(batch, heads, length, depth, 2, backward)
        row = {"case": tag, "batch": batch, "heads": heads, "length": length, "depth": depth,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library, "gflop": flops / 1e9,
               "gbytes": nbytes / 1e9, "flops_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
               "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        row["bound_by"] = ("operations" if row["flops_bound_ms"] > row["bytes_bound_ms"]
                           else "bytes")
        timed[tag] = row
        log(f"mha_{'bwd' if backward else 'fwd'} {tag}: B' {batch}, H 8, L {length}, D 32 bf16; "
            f"kernel {ms:.3f} ms ({row['gbytes'] / ms:.3f} TB/s, {row['gflop'] / ms:.1f} "
            f"TFLOP/s), plain {plain_ms:.3f} ms, F.scaled_dot_product_attention "
            f"{'forward + backward ' if backward else ''}{library:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        del q, k, v, g, q4, k4, v4, g4

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    err = {name: max(r[key] for r in checks) for name, key in (("fwd", "max_abs_err"),
                                                               ("bwd", "grad_max_abs_err"))}
    return {
        "mha_fwd": {
            "name": "mha_fwd", "route": "cuda",
            "source": "speech_enhancement_torch/kernels/csrc/attention_fwd.cu",
            "replaces": "speech_enhancement_tpu/ops/pallas/attention.py:115",
            "shape": "Sepformer intra serve: B' 12672, H 8, L 250, D 32 bf16 (one layer)",
            "tolerance": "bf16 |d| <= 2^-9 + 2^-7|ref|; f32 1e-5 + 1e-4|ref|",
            "max_abs_err": err["fwd"], **{k: timed["intra serve"][k] for k in keys},
            "cases": [timed["intra serve"], timed["inter serve"]], "checks": checks},
        "mha_bwd": {
            "name": "mha_bwd", "route": "cuda",
            "source": "speech_enhancement_torch/kernels/csrc/attention_bwd.cu",
            "replaces": "speech_enhancement_tpu/ops/pallas/attention.py:137",
            "shape": "Sepformer intra train: B' 264, H 8, L 250, D 32 bf16 (one layer)",
            "tolerance": "bf16 2^-7, f32 1e-4 of each gradient's largest",
            "max_abs_err": err["bwd"], **{k: timed["intra train"][k] for k in keys},
            "cases": [timed["intra train"], timed["inter train"]]},
    }


def sepformer_stage_split(model, cfg, mixture, dev) -> dict:
    """CUDA-event split of one request's model call: encoder, the attention
    modules of the intra and of the inter stacks (projections and core,
    timed by hooks around each), the rest of the mask net, decoder."""
    window = int(cfg.dset.sample_rate * cfg.model.segment)
    stride = int(cfg.model.win_length)
    x = torch.from_numpy(mixture[0]).to(dev)  # [C, T]
    x = (x - x.mean()) / (x.std() + 1e-9)
    n_win = -(-(x.shape[-1] - window) // stride) + 1
    n_win = -(-n_win // 4) * 4
    wav = extract_windows(x, window, stride, n_win).contiguous()  # [N, C, W]
    spans = {"intra": [], "inter": []}
    handles = []
    for block in model.masknet.dual_mdl:
        for kind in spans:
            for layer in getattr(block, f"{kind}_mdl").mdl.layers:
                def pre(module, args):
                    module.t0 = torch.cuda.Event(enable_timing=True)
                    module.t0.record()

                def post(module, args, out, kind=kind):
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    spans[kind].append((module.t0, end))

                handles += [layer.self_att.register_forward_pre_hook(pre),
                            layer.self_att.register_forward_hook(post)]
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            for kind in spans:
                spans[kind].clear()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            events[0].record()
            mix_w = model.encode(wav)
            events[1].record()
            mask = model.mask(mix_w)
            events[2].record()
            out = model.decode(mix_w, mask, window)
            events[3].record()
            torch.cuda.synchronize()
    for handle in handles:
        handle.remove()
    attention = {kind: sum(a.elapsed_time(b) for a, b in pairs) for kind, pairs in spans.items()}
    ms = {"encoder": events[0].elapsed_time(events[1]),
          "intra attention": attention["intra"], "inter attention": attention["inter"],
          "mask net rest": events[1].elapsed_time(events[2]) - sum(attention.values()),
          "decoder": events[2].elapsed_time(events[3]),
          "total": events[0].elapsed_time(events[3])}
    if out.shape != (n_win, model.num_spk) + tuple(wav.shape[1:]) or not torch.isfinite(out).all():
        fail(f"Sepformer stage split: output {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")

    def call():
        with torch.inference_mode():
            model(wav)

    busy_ms, top = device_busy(call)
    return {"windows": n_win, "ms": ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / ms["total"] if busy_ms else None, "top_kernels": top,
            "layout_ms": sepformer_layout_copies(model, mix_w)}


def sepformer_layout_copies(model, mix_w) -> dict:
    """CUDA-event times, in one request's first intra and first inter
    attention layer, of the copies around the kernel: the wrapper's
    ``.contiguous()`` of the transposed q, k and v (kernels/attention.py,
    mha_fwd) and the copy of the transposed output that the out projection
    reads (models/sepformer.py, MultiheadAttention.forward), beside the
    kernel; and each times the 16 layers of its kind a request runs."""
    from speech_enhancement_torch.models.sepformer import _dense

    block = model.masknet.dual_mdl[0]
    captured = {}

    def capture(kind):
        def hook(module, args):
            captured.setdefault(kind, (module, args[0]))
        return hook

    handles = [getattr(block, f"{kind}_mdl").mdl.layers[0].self_att.register_forward_pre_hook(
        capture(kind)) for kind in ("intra", "inter")]
    with torch.inference_mode():
        model.mask(mix_w)
        torch.cuda.synchronize()
        for handle in handles:
            handle.remove()
        out = {}
        for kind, (module, x) in captured.items():
            att, cd, heads = module.att, module.dtype, module.nhead
            x = x.to(cd)
            q, k, v = (_dense(x, w, b, cd) for w, b in zip(att.in_proj_weight.chunk(3),
                                                            att.in_proj_bias.chunk(3)))
            packed = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            o = attn_k.mha_fwd(*packed, heads)
            row = {"batch": q.shape[0], "length": q.shape[1], "width": q.shape[2],
                   "qkv_contiguous_ms": cuda_ms(
                       lambda: [t.transpose(1, 2).contiguous() for t in (q, k, v)], reps=10),
                   "kernel_ms": cuda_ms(lambda: attn_k.mha_fwd(*packed, heads), reps=10),
                   "out_transpose_ms": cuda_ms(lambda: o.transpose(1, 2).contiguous(), reps=10)}
            layers = len(model.masknet.dual_mdl) * len(getattr(block, f"{kind}_mdl").mdl.layers)
            row["copies_per_request_ms"] = layers * (row["qkv_contiguous_ms"] +
                                                     row["out_transpose_ms"])
            out[kind] = row
    return out


def sepformer_slice_phase(dev) -> dict:
    """configs/sepformer_clarity.yaml at full width (bf16, fused_attention)
    serving three stereo 10 s requests (32 forward attention launches each),
    held against the same weights on flax's attention (fused_attention =
    False)."""
    rng = np.random.default_rng(SEED)
    n = int(SECONDS * 16000)
    requests = [np.concatenate([utterance(rng, n), utterance(rng, n)], axis=1)
                for _ in range(N_REQUESTS)]
    return serve_family("sepformer serve", dev, SEP_CONFIG, requests,
                        {"mha_fwd": SEP_LAUNCHES * N_REQUESTS}, sepformer_stage_split,
                        plain=(("fused_attention", False),))


def sepformer_train_batch():
    """configs/sepformer_clarity.yaml's operating point: 4 stereo mixtures of
    4 s, each the sum of two speech-like stereo sources plus noise, made with
    numpy: (mixture [4, 2, n], sources [4, 2, 2, n])."""
    return stereo_pair_batch(SEP_TRAIN_BATCH, SEED + 10)


def sepformer_train_phase(dev) -> dict:
    """Three Sepformer train steps at the config's operating point (si-sdr
    with PIT, Adam 1.5e-4, clip 5) with the attention kernels (32 forward
    and 32 backward launches a step), held on the first step against flax's
    attention (fused_attention = False)."""
    mixture, sources = sepformer_train_batch()
    fused, g_fused = train_path("sepformer", dev, mixture, sources, SEP_CONFIG, "si-sdr",
                                SEP_OPTIM)
    expect_launches("sepformer train", fused["launches"], mha_fwd=SEP_LAUNCHES * TRAIN_STEPS,
                    mha_bwd=SEP_LAUNCHES * TRAIN_STEPS)
    plain, g_plain = train_path("sepformer, flax attention", dev, mixture, sources, SEP_CONFIG,
                                "si-sdr", SEP_OPTIM, fused_attention=False)
    expect_launches("sepformer train, flax attention", plain["launches"])
    agreement = first_step_agreement("sepformer train", plain, g_plain, fused, g_fused,
                                     "kernels vs flax attention")
    return {"fused": fused, "plain": plain, "first_step_agreement": agreement}


def sepformer_reference_phase(dev) -> dict:
    """The small f32 Sepformer (D 16) with the attention kernels on the card
    vs the CPU path, which the CPU tests hold against JAX
    (``card_vs_cpu_step``: a served stereo utterance within F32_ATOL, then
    one si-sdr PIT train step)."""
    cfg = Config({"model": SMALL_SEP, "dset": {"sample_rate": 16000, "norm": "z-score"}})
    rng = np.random.default_rng(SEED + 11)
    wav = np.concatenate([utterance(rng, 12000), utterance(rng, 12000)], axis=1)
    sources = (0.5 * rng.standard_normal((2, 2, 2, 2000))).astype(np.float32)
    result = card_vs_cpu_step("sepformer reference: small f32 Sepformer (D 16)", cfg, wav,
                              sources.sum(axis=1), sources, {"mha_fwd": 2},
                              {"mha_fwd": 2, "mha_bwd": 2}, seed=8, loss_name="si-sdr",
                              optim=SEP_OPTIM, use_pit=True)
    if result["served_shape"] != (1, 2, 2, 12000):
        fail(f"small f32 Sepformer served shape {result['served_shape']}")
    return result


# -- the recurrent paths: mel-rnn, rnn-stft-mask training, Sepformer's options,
# DCCRN's real LSTM ---------------------------------------------------------------

MEL_CONFIG = os.path.join(ROOT, "configs", "mel_rnn_vbd.yaml")
MASK_TRAIN_BATCH = 8  # configs/rnn_stft_mask_clarity.yaml solver.batch_size: stereo, 2 speakers
DCCRN_TRAIN_BATCH = 16  # configs/dccrn_vbd.yaml solver.batch_size
REMAT_MIN_COSINE = 0.9999  # remat recomputes the same layers: the same gradients but rounding


def stft_model_split(model, cfg, mixture, dev) -> dict:
    """CUDA-event split of one request's call for an stft-domain model
    without stages of its own (mel-rnn): STFT, model, mask + iSTFT; and the
    device-busy share of the call."""
    window = int(cfg.dset.sample_rate * cfg.model.segment)
    stride = int(cfg.model.win_length)
    x = torch.from_numpy(mixture[0]).to(dev)
    x = (x - x.mean()) / (x.std() + 1e-9)
    n_win = -(-(x.shape[-1] - window) // stride) + 1
    n_win = -(-n_win // 4) * 4
    wav = extract_windows(x, window, stride, n_win).contiguous()  # [N, C, W]
    names = ["stft", "model", "istft"]
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            events[0].record()
            spec = stft_custom(wav, cfg.model)
            events[1].record()
            masked = model(spec)
            events[2].record()
            out = istft_custom(masked, window, cfg.model)
            events[3].record()
            torch.cuda.synchronize()
    ms = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}
    ms["total"] = events[0].elapsed_time(events[-1])

    def call():
        with torch.inference_mode():
            istft_custom(model(stft_custom(wav, cfg.model)), window, cfg.model)

    busy_ms, top = device_busy(call)
    if not torch.isfinite(out).all():
        fail("stft model split: non-finite output")
    return {"windows": n_win, "ms": ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / ms["total"] if busy_ms else None, "top_kernels": top}


def mel_rnn_phase(dev) -> dict:
    """configs/mel_rnn_vbd.yaml at full width (two LSTM layers of 256, f32,
    fused_rnn): three 10 s requests through evaluate_utterance (two forward
    launches each) against the plain loop within F32_ATOL of the peak; the
    same width served once with rnn_type gru and once with rnn (plain loops,
    no launch); three train steps at B 16 x 4 s (mse, Adam 3e-4, clip 5; two
    forward and two backward launches a step), the first held against the
    plain loop's."""
    rng = np.random.default_rng(SEED + 12)
    requests = [utterance(rng, int(SECONDS * 16000)) for _ in range(N_REQUESTS)]
    served = serve_family("mel-rnn serve", dev, MEL_CONFIG, requests,
                          {"lstm_fwd": 2 * N_REQUESTS}, stft_model_split, f32=True)
    other_types = {}
    for kind in ("gru", "rnn"):
        cfg, model, spec = load_model(dev, MEL_CONFIG, rnn_type=kind)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs, times = serve(model, spec, cfg, requests[:1], dev)
        if any(read_launches().values()):
            fail(f"mel-rnn serve, rnn_type {kind}: launched {read_launches()}")
        if outs[0].shape != requests[0].shape or not np.isfinite(outs[0]).all():
            fail(f"mel-rnn serve, rnn_type {kind}: output {outs[0].shape}, finite "
                 f"{np.isfinite(outs[0]).all()}")
        other_types[kind] = {"params": sum(p.numel() for p in model.parameters()),
                             "request_ms": 1e3 * times[0],
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"mel-rnn serve, rnn_type {kind} (plain loop): {other_types[kind]}")
        del model
    mixture, sources = crn_train_batch()  # 16 mono 4 s items, the config's batch
    fused, g_fused = train_path("mel-rnn", dev, mixture, sources, MEL_CONFIG)
    expect_launches("mel-rnn train", fused["launches"], lstm_fwd=2 * TRAIN_STEPS,
                    lstm_bwd=2 * TRAIN_STEPS)
    plain, g_plain = train_path("mel-rnn, plain loop", dev, mixture, sources, MEL_CONFIG,
                                steps=1, detail=False, fused_rnn=False)
    expect_launches("mel-rnn train, plain loop", plain["launches"])
    agreement = first_step_agreement("mel-rnn train", plain, g_plain, fused, g_fused,
                                     "kernels vs plain loop")
    return {"serve": served, "other_types": other_types, "train": fused, "plain_train": plain,
            "first_step_agreement": agreement}


def stereo_pair_batch(batch: int, seed: int):
    """``batch`` stereo mixtures of 4 s, each the sum of two speech-like
    stereo sources plus noise, made with numpy: (mixture [B, 2, n],
    sources [B, 2, 2, n])."""
    rng = np.random.default_rng(seed)
    n = int(TRAIN_SECONDS * 16000)
    sources = np.stack([np.stack([np.concatenate([utterance(rng, n)[0] for _ in range(2)])
                                  for _ in range(2)]) for _ in range(batch)])
    mixture = sources.sum(axis=1) + 0.05 * rng.standard_normal((batch, 2, n))
    return mixture.astype(np.float32), sources.astype(np.float32)


def rnn_stft_mask_train_phase(dev) -> dict:
    """configs/rnn_stft_mask_clarity.yaml at full width (three bidirectional
    LSTM layers of 896, bf16, fused_rnn) training at its operating point
    (B 8 stereo x 4 s, two speakers, mse with PIT, Adam 3e-4, clip 5): three
    steps with drop_out 0 (six forward and six backward launches a step,
    three of each reversed), the first held against the plain loop's; then
    three steps with the config's drop_out 0.5, finite. Not through the
    CLI: the config sets ``ha:``, which the Solver refuses until the ha/
    slice."""
    mixture, sources = stereo_pair_batch(MASK_TRAIN_BATCH, SEED + 13)
    fused, g_fused = train_path("rnn-stft-mask (drop_out 0)", dev, mixture, sources, MASK_CONFIG,
                                drop_out=0.0)
    expect_launches("rnn-stft-mask train", fused["launches"], lstm_fwd=6 * TRAIN_STEPS,
                    lstm_bwd=6 * TRAIN_STEPS)
    if fused["reverse_launches"] != {"lstm_fwd": 3 * TRAIN_STEPS, "lstm_bwd": 3 * TRAIN_STEPS}:
        fail(f"rnn-stft-mask train: reversed launches {fused['reverse_launches']}, want "
             f"{3 * TRAIN_STEPS} of each")
    plain, g_plain = train_path("rnn-stft-mask (drop_out 0), plain loop", dev, mixture, sources,
                                MASK_CONFIG, steps=1, detail=False, drop_out=0.0,
                                fused_rnn=False)
    expect_launches("rnn-stft-mask train, plain loop", plain["launches"])
    agreement = first_step_agreement("rnn-stft-mask train", plain, g_plain, fused, g_fused,
                                     "kernels vs plain loop")
    dropped, _ = train_path("rnn-stft-mask (drop_out 0.5, the config's)", dev, mixture, sources,
                            MASK_CONFIG, detail=False, falling=False)
    expect_launches("rnn-stft-mask train, drop_out 0.5", dropped["launches"],
                    lstm_fwd=6 * TRAIN_STEPS, lstm_bwd=6 * TRAIN_STEPS)
    return {"train": fused, "plain_train": plain, "first_step_agreement": agreement,
            "dropout_train": dropped}


def sepformer_options_phase(dev) -> dict:
    """configs/sepformer_clarity.yaml at full width and B 4 (si-sdr with
    PIT), one train step each with attention_type RelPosMHAXL (plain
    PyTorch: no attention launch), with RNN intra and inter blocks (plain
    loops: no launch), and with remat on and off on the same batch and
    weights: remat launches the attention forward twice a layer (the
    recompute), its gradients agree with remat off's (cosine >=
    REMAT_MIN_COSINE), and both peaks are kept.

    RelPosMHAXL runs 4 + 4 layers a dual block, not 8 + 8: without the
    sinusoidal positions a chunk's zero-padded frames reach the first
    intra layers' LayerNorm (eps 1e-6) as all-zero rows, and the gradient
    grows about a thousandfold a layer back through them, so at 8 layers
    the f32 global norm overflows, in the JAX package as here (the
    small-model gradients are held against it in
    tests/test_torch_sepformer_options.py)."""
    mixture, sources = sepformer_train_batch()
    rows, grads = {}, {}
    for tag, overrides, steps, fwd, bwd in (
            ("RelPosMHAXL, 4 + 4 layers", {"attention_type": "RelPosMHAXL",
                                           "intra_numlayers": 4, "inter_numlayers": 4}, 1, 0, 0),
            ("rnn blocks", {"intra_block": "rnn", "inter_block": "rnn"}, 1, 0, 0),
            ("remat off", {}, 2, SEP_LAUNCHES, SEP_LAUNCHES),
            ("remat", {"remat": True}, 2, 2 * SEP_LAUNCHES, SEP_LAUNCHES)):
        rows[tag], grads[tag] = train_path(f"sepformer {tag}", dev, mixture, sources, SEP_CONFIG,
                                           "si-sdr", SEP_OPTIM, steps=steps, detail=False,
                                           **overrides)
        expect_launches(f"sepformer {tag}", rows[tag]["launches"], mha_fwd=steps * fwd,
                        mha_bwd=steps * bwd)
    agreement = first_step_agreement("sepformer remat", rows["remat off"], grads["remat off"],
                                     rows["remat"], grads["remat"], "remat vs remat off",
                                     REMAT_MIN_COSINE)
    log(f"sepformer remat: peak {rows['remat']['peak_mem_gib']:.2f} GiB against "
        f"{rows['remat off']['peak_mem_gib']:.2f} without; the second step "
        f"{rows['remat']['step_ms'][1]:.1f} ms against {rows['remat off']['step_ms'][1]:.1f}")
    return {**rows, "remat_agreement": agreement}


def dccrn_real_lstm_phase(dev) -> dict:
    """configs/dccrn_vbd.yaml with use_clstm = False (a real LSTM of 128 over
    the flattened bottleneck, no kernel, as in JAX) on both execution paths:
    one 10 s request each (the unfused path launches the STFT and mask-E
    kernels, the fused one the block kernels too) and one train step each
    at B 16 x 4 s; then the small f32 model on the card vs the CPU on both
    paths."""
    rng = np.random.default_rng(SEED + 14)
    request = [utterance(rng, int(SECONDS * 16000))]
    n = int(TRAIN_SECONDS * 16000)
    wire_m = encode_wire_int16((0.1 * rng.standard_normal((DCCRN_TRAIN_BATCH, 1, n))
                                ).astype(np.float32))
    wire_s = encode_wire_int16((0.1 * rng.standard_normal((DCCRN_TRAIN_BATCH, 1, 1, n))
                                ).astype(np.float32))
    result = {}
    for fused in (False, True):
        tag = f"dccrn real LSTM {'fused' if fused else 'unfused'}"
        cfg, model, spec = load_model(dev, use_clstm=False, use_fused_blocks=fused)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs, times = serve(model, spec, cfg, request, dev)
        blocks = {"conv_block": 6, "deconv_block": 6} if fused else {}
        expect_launches(f"{tag} serve", read_launches(), stft=1, mask_e=1, **blocks)
        if outs[0].shape != request[0].shape or not np.isfinite(outs[0]).all():
            fail(f"{tag} serve: output {outs[0].shape}, finite {np.isfinite(outs[0]).all()}")
        serve_row = {"params": sum(p.numel() for p in model.parameters()),
                     "request_ms": 1e3 * times[0],
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"{tag} serve (one 10 s request, with its warm-up): {serve_row}")
        del model
        train, _ = train_path(tag, dev, wire_m, wire_s, steps=1, detail=False, use_clstm=False,
                              use_fused_blocks=fused)
        expect_launches(f"{tag} train", train["launches"],
                        **(BLOCK_STEP if fused else {"stft": 1, "mask_e": 1}))
        result[tag] = {"serve": serve_row, "train": train}
    # the batch as train_reference_phase draws it (a generator of its own)
    rng = np.random.default_rng(SEED + 15)
    mixture = (0.5 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 8000))).astype(np.float32)
    wav = (0.5 * np.random.default_rng(SEED + 16).standard_normal((1, 1, 8000))).astype(
        np.float32)
    for fused in (False, True):
        cfg = Config({"model": dict(SMALL_FUSED, use_clstm=False, use_fused_blocks=fused,
                                    segment=0.25, sample_rate=16000, win_length=512),
                      "dset": {"sample_rate": 16000, "norm": "z-score"}})
        blocks = {"conv_block": 6, "deconv_block": 6} if fused else {}
        result[f"small {'fused' if fused else 'unfused'}"] = card_vs_cpu_step(
            f"small f32 dccrn real LSTM {'fused' if fused else 'unfused'}", cfg, wav, mixture,
            sources, dict(stft=1, mask_e=1, **blocks), BLOCK_STEP if fused else
            {"stft": 1, "mask_e": 1},
            zero_grad=lambda key: zero_grad_bias(key, len(SMALL_FUSED["kernel_num"])))
    return result


# -- the rest of the zoo: dnn, unet, wav-unet, dcunet, tcn, conv-tasnet, demucs

# (family, shipped config, its train batch: mono VBD items or stereo Clarity
# pairs of two speakers); the parameter counts are tests/test_torch_zoo_params.py's
ZOO = (("dnn", "dnn_vbd.yaml", 2699781), ("unet", "unet_vbd.yaml", 1959142),
       ("wav-unet", "wav_unet_vbd.yaml", 10132802), ("dcunet", "dcunet_vbd.yaml", 1966270),
       ("tcn", "tcn_vbd.yaml", 535617), ("conv-tasnet", "conv_tasnet_clarity.yaml", 1012508),
       ("demucs", "demucs_clarity.yaml", 133751012))
ZOO_REQUESTS = 2  # 10 s each, the first warms up
# lstm_fwd launches of one Demucs call at configs/demucs_clarity.yaml: BLSTMs
# in encoder layers 4 and 5 x 2 DConv depths x 2 LSTM layers x 2 directions
DEMUCS_LAUNCHES = 16
ZOO_STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
# the small f32 models of the CPU tests (tests/test_torch_{dnn,unet,...}.py)
ZOO_SMALL = {
    "dnn": dict(n_layers=3, hidden_layer=64, drop_out=0.0),
    "unet": dict(unet_layer=2),
    "wav-unet": dict(unet_nlayers=3, channels_interval=4),
    # n_fft 256: at 128 and 512 on 4000 samples the decoder's output is
    # zero-padded to the input's (T, F), where mask E's sqrt and atan2 of a
    # zero mask (zero head biases at init) give NaN gradients, in JAX too
    "dcunet": dict(model_complexity=8, n_fft=256, hop_length=64, win_length=256),
    "tcn": dict(tcn_channels=8, tcn_hidden=16, tcn_blocks=3, tcn_repeats=2),
    "conv-tasnet": dict(N=16, L=8, B=8, H=16, P=3, X=3, R=2, audio_channels=2),
    "demucs": dict(channels=8, depth=3, norm_starts=1, norm_groups=2, dconv_attn=2,
                   dconv_lstm=2, fused_rnn=True),
}
# a gradient that is zero in exact arithmetic holds rounding residue on both
# sides: a conv or Linear bias a BatchNorm follows, LocalState's key bias;
# and UNet's last one-channel BatchNorm scale, whose output a one-channel
# conv and BatchNorm renormalise (its gradient is 7e-7 of the largest leaf,
# and f32 against f64 on the CPU differ by 13% of it)
ZOO_ZERO_GRAD = {
    "dnn": lambda key: key.endswith("model.0.bias"),
    "unet": lambda key: key == "outconv.conv.double_conv.1.weight",
    "wav-unet": lambda key: key.endswith(("main.0.bias", "middle.0.bias")),
    "dcunet": lambda key: key.startswith(("encoder", "decoder")) and key.endswith(".bias")
    and ".bn." not in key,
    "demucs": lambda key: key.endswith(".key.bias"),
}


def no_dropout(model) -> None:
    """UNet's dropout is not a config key: rate 0 for a card-vs-CPU step."""
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0


def set_fused_rnn(model, fused: bool) -> None:
    """Route every LSTM stack of ``model`` through the kernels or the plain loop."""
    from speech_enhancement_torch.ops.rnn import RNNStack

    for module in model.modules():
        if isinstance(module, RNNStack):
            module.fused = fused


def zoo_card_vs_cpu(name: str, path: str) -> dict:
    """The family's small f32 model on the card vs the CPU: one request and
    one train step with the config's loss (``card_vs_cpu_step``)."""
    cfg = load_config(path)
    channels = int(cfg.dset.audio_channels)
    multi = name in ("conv-tasnet", "demucs")
    small = Config({"model": {"name": name, **ZOO_STFT, **ZOO_SMALL[name], "segment": 0.25,
                              "sample_rate": 16000},
                    "dset": {"sample_rate": 16000, "norm": "z-score",
                             "audio_channels": channels}})
    rng = np.random.default_rng(SEED + 40)
    n_src = 2 if multi else 1
    wav = (0.5 * rng.standard_normal((1, channels, 9000))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, n_src, channels, 4000))).astype(np.float32)
    mixture = (sources.sum(axis=1) + 0.05 * rng.standard_normal((2, channels, 4000))).astype(
        np.float32)
    stft_domain = name in ("dnn", "unet", "dcunet")
    launches = 8 if name == "demucs" else 0  # one BLSTM layer of the small Demucs: 2 x 2 x 2
    return card_vs_cpu_step(
        f"zoo {name}: small f32 model", small, wav, mixture, sources,
        {"lstm_fwd": launches}, {"lstm_fwd": launches, "lstm_bwd": launches}, seed=SEED + 41,
        loss_name=str(cfg.optim.loss), use_pit=multi,
        model_config=small.model if stft_domain else None,
        zero_grad=ZOO_ZERO_GRAD.get(name, lambda key: False),
        prepare=no_dropout if name == "unet" else None)


def zoo_serve(tag, model, spec, cfg, requests, dev, want_lstm=0) -> tuple:
    """``requests`` through evaluate_utterance: the launches, the output's
    shape, the warm request's ms, the peak and the device-busy share."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, times = serve(model, spec, cfg, requests, dev)
    expect_launches(tag, read_launches(), lstm_fwd=want_lstm * len(requests))
    n_src = len(cfg.model.sources) if spec.multi_speaker else None
    for out, req in zip(outs, requests):
        shape = req.shape[:1] + ((n_src,) if n_src else ()) + req.shape[1:]
        if out.shape != shape or not np.isfinite(out).all():
            fail(f"{tag}: output {out.shape} (want {shape}), finite {np.isfinite(out).all()}")
    ms = 1e3 * statistics.mean(times[1:])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    busy_ms, top = device_busy(lambda: evaluate_utterance(requests[0], model, spec, cfg,
                                                          device=dev))
    row = {"request_ms": [1e3 * t for t in times], "warm_ms": ms, "rtf": ms / 1e3 / SECONDS,
           "peak_mem_gib": peak_gib, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / ms if busy_ms else None, "top_kernels": top[:4]}
    share = row["device_busy_share"]
    log(f"{tag}: {len(requests)} requests of {SECONDS:g} s ({requests[0].shape[1]} channel(s)); "
        f"request ms {[round(x, 1) for x in row['request_ms']]} (the first warms up); warm "
        f"{ms:.1f} ms, RTF {row['rtf']:.4f}; peak {peak_gib:.2f} GiB; device busy "
        f"{busy_ms:.1f} ms ({'not measured' if share is None else f'{share:.3f}'} of the warm "
        "request); top kernels " + "; ".join(f"{t['kernel'][:60]} {t['ms']:.2f} ms x{t['count']}"
                                             for t in top[:4]))
    return outs, row


def zoo_family(dev, name: str, file: str, want_params: int, requests: dict, batches: dict
               ) -> dict:
    """One family of ``zoo_phase``: its parameters, its small model card vs
    CPU, two requests and three train steps (demucs also with fused_rnn)."""
    path = os.path.join(ROOT, "configs", file)
    row = {"config": f"configs/{file}", "card_vs_cpu": zoo_card_vs_cpu(name, path)}
    cfg, model, spec = load_model(dev, path)
    row["params"] = sum(p.numel() for p in model.parameters())
    log(f"zoo {name}: {row['params']} parameters at configs/{file} (the CPU tests pin "
        f"{want_params}), compute dtype {model.compute_dtype}")
    if row["params"] != want_params:
        fail(f"zoo {name}: {row['params']} parameters, the CPU tests pin {want_params}")
    reqs = requests["stereo" if spec.multi_speaker else "mono"]
    outs, row["serve"] = zoo_serve(f"zoo {name} serve", model, spec, cfg, reqs, dev)
    if name == "demucs":
        set_fused_rnn(model, True)
        fused_outs, row["serve_fused"] = zoo_serve(
            "zoo demucs serve, fused_rnn", model, spec, cfg, reqs, dev,
            want_lstm=DEMUCS_LAUNCHES)
        row["serve_agreement"] = agree(fused_outs, outs, "zoo demucs serve: kernels vs "
                                       "plain loop")
        log(f"zoo demucs serve: kernels vs plain loop {row['serve_agreement']}")
    del model, outs
    optim = cfg.optim.to_dict()
    mixture, sources = batches[name if name == "demucs" else
                               "stereo" if spec.multi_speaker else "mono"]
    dropout = name in ("dnn", "unet")  # the loss need not fall under dropout
    row["train"], g_plain = train_path(f"zoo {name}", dev, mixture, sources, path,
                                       loss_name=str(cfg.optim.loss), optim=optim,
                                       falling=not dropout)
    expect_launches(f"zoo {name} train", row["train"]["launches"])
    if name == "demucs":
        row["train_fused"], g_fused = train_path(
            "zoo demucs, fused_rnn", dev, mixture, sources, path,
            loss_name=str(cfg.optim.loss), optim=optim, detail=False, fused_rnn=True)
        expect_launches("zoo demucs train, fused_rnn", row["train_fused"]["launches"],
                        lstm_fwd=2 * DEMUCS_LAUNCHES * TRAIN_STEPS,
                        lstm_bwd=DEMUCS_LAUNCHES * TRAIN_STEPS)
        row["first_step_agreement"] = first_step_agreement(
            "zoo demucs train", row["train"], g_plain, row["train_fused"], g_fused,
            "kernels vs plain loop")
    torch.cuda.empty_cache()
    return row


def zoo_inputs():
    """Two 10 s requests, mono and stereo; the train batches: 16 mono VBD
    items of 4 s (dnn to tcn), 16 stereo pairs of two speakers (conv-tasnet)
    and 8 (demucs), as the configs' solver.batch_size."""
    rng = np.random.default_rng(SEED + 42)
    n = int(SECONDS * 16000)
    requests = {"mono": [utterance(rng, n) for _ in range(ZOO_REQUESTS)],
                "stereo": [np.concatenate([utterance(rng, n)[:, 0] for _ in range(2)])[None]
                           for _ in range(ZOO_REQUESTS)]}
    batches = {"mono": crn_train_batch(), "stereo": stereo_pair_batch(16, SEED + 43),
               "demucs": stereo_pair_batch(8, SEED + 44)}
    return requests, batches


def zoo_models_cli() -> float:
    """``python -m speech_enhancement_torch.models --all`` on the card: every
    family builds and runs one forward; returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "speech_enhancement_torch.models", "--all",
                           "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    for line in proc.stdout.splitlines():
        log(f"models CLI: {line}")
    if proc.returncode != 0 or proc.stdout.count("device=cuda") != 12:
        fail(f"python -m speech_enhancement_torch.models --all: rc {proc.returncode}\n"
             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    seconds = time.perf_counter() - t0
    log(f"models CLI on the card: twelve families in {seconds:.1f} s (one process, with its "
        "start)")
    return seconds


def zoo_phase(dev) -> dict:
    """The seven families at the full width of their shipped configs: each
    family's parameter count against the CPU tests' pin, its small f32 model
    on the card vs the CPU, two 10 s requests through evaluate_utterance
    (192 windows; stereo for conv-tasnet and demucs), and three train steps
    at the config's batch and loss (B 16 x 4 s, mono VBD items; conv-tasnet
    B 16 stereo, two speakers, si-sdr with PIT; demucs B 8 with remat, l1
    with PIT) with the step split and the device-busy share. Demucs also
    serves and trains with ``fused_rnn = True`` against its plain loop:
    DEMUCS_LAUNCHES forward launches a call, and in training with remat as
    many again (the recomputed forward) and DEMUCS_LAUNCHES backward ones.
    Last, ``python -m speech_enhancement_torch.models --all`` on the card."""
    requests, batches = zoo_inputs()
    result = {name: zoo_family(dev, name, file, want, requests, batches)
              for name, file, want in ZOO}
    result["models_cli_s"] = zoo_models_cli()
    return result


# -- the wide LSTM design on its model paths -----------------------------------

DEMUCS_CONFIG = os.path.join(ROOT, "configs", "demucs_clarity.yaml")
DEMUCS_BOTTLENECK = {"lstm_layers": 2, "fused_rnn": True, "dtype": "float32"}
WIDE_REQUESTS = 2  # 10 s each, the first warms up


def f32_step_agreement(tag: str, ref: dict, g_ref, other: dict, g_other) -> dict:
    """Two f32 paths' first train steps on the same batch and weights: loss
    and grad norm within LEAF_RTOL relatively, every gradient element within
    LEAF_RTOL of the largest (the small models' card-vs-CPU bound; a
    leaf's true gradient may be zero, so the global scale)."""
    loss_rel = abs(other["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    norm_rel = abs(other["grad_norms"][0] - ref["grad_norms"][0]) / ref["grad_norms"][0]
    grad_rel = ((g_other - g_ref).abs().max() / g_ref.abs().max()).item()
    agreement = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "grad_rel": grad_rel}
    log(f"{tag}: kernels vs plain loop, first step: loss {loss_rel:.2e}, grad norm "
        f"{norm_rel:.2e} relative, gradients within {grad_rel:.2e} of the largest (bound "
        f"{LEAF_RTOL} each)")
    if not max(agreement.values()) <= LEAF_RTOL:
        fail(f"{tag}: kernels vs plain loop disagree on the first step: {agreement}")
    return agreement


def wide_designs(shapes) -> dict:
    """The design the library takes at each (kernel, T, B, H) of a model's
    f32 recurrences; fails unless every one is the wide design."""
    got = {}
    for kernel, batch, hidden in shapes:
        ask = lstm_k.lstm_fwd_design if kernel == "fwd" else lstm_k.lstm_bwd_design
        got[f"{kernel} B {batch} H {hidden}"] = ask(torch.float32, hidden, batch)[0]
    if set(got.values()) != {"wide"}:
        fail(f"the wide design is not what these shapes take: {got}")
    return got


def wide_lstm_phase(dev) -> dict:
    """Rows 9 and 10's wide design on the model paths that need it, each
    against the same weights on the plain loop (``fused_rnn = False``) at
    the f32 bounds: CRN at configs/crn_vbd.yaml's width with its class
    default ``dtype: float32`` (two LSTM layers of 1792: two forward
    launches a request, two forward and two backward a step), one warm-up
    and one 10 s request through evaluate_utterance (B 192) and one train
    step at B 16; Demucs at configs/demucs_clarity.yaml's width with its
    bottleneck BLSTM (``lstm_layers: 2``, 2048 units) and ``fused_rnn``, in
    f32 (so the comparison holds at the f32 bounds; the shipped bf16
    config's bottleneck is f32 too), one warm-up and one stereo 10 s
    request (DEMUCS_LAUNCHES + 4 forward launches) and one PIT step at B 8
    (remat relaunches the DConv BLSTMs' forward: 2 DEMUCS_LAUNCHES + 4
    forward, DEMUCS_LAUNCHES + 4 backward)."""
    result = {"designs": {
        "crn": wide_designs([("fwd", 192, 1792), ("fwd", 16, 1792), ("bwd", 16, 1792)]),
        "demucs": wide_designs([("fwd", 192, 2048), ("fwd", 8, 2048), ("bwd", 8, 2048)])}}
    log(f"wide lstm: designs at the models' shapes {result['designs']}")
    rng = np.random.default_rng(SEED + 60)
    n = int(SECONDS * 16000)
    mono = [utterance(rng, n) for _ in range(WIDE_REQUESTS)]
    stereo = [np.concatenate([utterance(rng, n)[:, 0] for _ in range(2)])[None]
              for _ in range(WIDE_REQUESTS)]
    mixture, sources = crn_train_batch()
    runs = (("crn f32", CRN_CONFIG, mono, 2, (2, 2), {"dtype": "float32"}, (mixture, sources)),
            ("demucs bottleneck", DEMUCS_CONFIG, stereo, DEMUCS_LAUNCHES + 4,
             (2 * DEMUCS_LAUNCHES + 4, DEMUCS_LAUNCHES + 4), DEMUCS_BOTTLENECK,
             stereo_pair_batch(8, SEED + 61)))
    for tag, path, requests, serve_fwd, (train_fwd, train_bwd), overrides, batch in runs:
        cfg, model, spec = load_model(dev, path, **overrides)
        params = sum(p.numel() for p in model.parameters())
        outs, row = zoo_serve(f"{tag} serve", model, spec, cfg, requests, dev,
                              want_lstm=serve_fwd)
        del model
        torch.cuda.empty_cache()
        cfg, plain_model, spec = load_model(dev, path, **{**overrides, "fused_rnn": False})
        reset_launches()
        plain_outs, plain_times = serve(plain_model, spec, cfg, requests, dev)
        expect_launches(f"{tag} serve, plain loop", read_launches())
        del plain_model
        torch.cuda.empty_cache()
        row.update(params=params, plain_request_ms=[1e3 * t for t in plain_times],
                   agreement=f32_serve_agreement(f"{tag} serve", outs, plain_outs))
        log(f"{tag} serve: {params} parameters; plain loop request ms "
            f"{[round(x, 1) for x in row['plain_request_ms']]}; kernels vs plain loop "
            f"{row['agreement']}")
        row["launches"] = {"lstm_fwd": serve_fwd * len(requests), "lstm_bwd": 0}
        optim = cfg.optim.to_dict()
        loss_name = str(cfg.optim.loss)
        fused, g_fused = train_path(f"{tag}", dev, *batch, path, loss_name=loss_name,
                                    optim=optim, steps=1, detail=False, **overrides)
        expect_launches(f"{tag} train", fused["launches"], lstm_fwd=train_fwd,
                        lstm_bwd=train_bwd)
        torch.cuda.empty_cache()
        plain, g_plain = train_path(f"{tag}, plain loop", dev, *batch, path, loss_name=loss_name,
                                    optim=optim, steps=1, detail=False,
                                    **{**overrides, "fused_rnn": False})
        expect_launches(f"{tag} train, plain loop", plain["launches"])
        result[tag] = {"serve": row, "train": fused, "plain_train": plain,
                       "first_step_agreement": f32_step_agreement(f"{tag} train", plain, g_plain,
                                                                  fused, g_fused)}
        del g_fused, g_plain
        torch.cuda.empty_cache()
    return result


# -- the system's own entry point: data layer, Solver and CLI ----------------

# -- streaming serving and the hearing-aid chain --------------------------------

STREAM_BATCHES = (1, 64)  # one stream, and 64 parallel streams a step
# a small f32 stream on the card vs the same model's offline forward on the
# card, over the interior: the CPU tests' bound (tests/test_torch_streaming_*)
STREAM_F32_FRAC = 2e-4
SMALL_STREAM_DCCRN = {"name": "dccrn", "kernel_num": [16, 32, 64], "rnn_units": 64,
                      "dtype": "float32"}
# the amplified signals (tanh-clipped, |x| <= 1) card vs CPU, absolute, and
# the better-ear scores, relative: tests/test_torch_ha.py's bounds. The
# inputs put every score inside HA_SCORE_RANGE, so the relative bound can fail
HA_AMP_ATOL, HA_SCORE_RTOL, HA_SCORE_RANGE = 1e-5, 1e-4, (0.02, 0.98)
HA_SECONDS, HA_SCENES = 4.0, 2


@contextlib.contextmanager
def tf32_allowed():
    """TF32 allowed for convolutions (cuDNN's default) and matmuls inside,
    the flags as they were after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def timed_step(streamer):
    """A stand-in for ``streamer.step`` that records each call's ms on the
    host clock from a synchronize to a synchronize (``.ms``) and the last
    state it returned (``.state``)."""
    def step(state, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = streamer.step(state, chunk)
        torch.cuda.synchronize()
        step.ms.append(1e3 * (time.perf_counter() - t0))
        step.state = state
        return state, out
    step.ms, step.state = [], None
    return step


def stream_offline(family: str, model, cfg, wav: torch.Tensor) -> torch.Tensor:
    """The same model's offline forward on the card: [B, T] -> [B, T]."""
    with torch.inference_mode():
        if family == "dccrn":
            return model(wav)
        spec = model(stft_custom(wav[:, None], cfg.model))
        return istft_custom(spec, wav.shape[-1], cfg.model)[:, 0]


def stream_family(tag: str, dev, family: str, cfg, model, batches, f32: bool) -> dict:
    """Stream 10 s requests at each batch of ``batches`` through the port's
    streamer, check the launches (DCCRN: the STFT and mask-E kernels once a
    chunk; CRN with fused_rnn: the LSTM forward twice a chunk), hold the
    stream against the offline forward over the interior (all but the
    final ``latency`` samples for DCCRN, the final ``win`` for CRN), and
    time it: each step's ms, the device-busy share of one steady step, the
    peak memory."""
    from speech_enhancement_torch.serve import CRNStreamer, DCCRNStreamer

    if family == "dccrn":
        streamer = DCCRNStreamer(model)
        per_chunk = {"stft": 1, "mask_e": 1}
        cut = streamer.latency
    else:
        streamer = CRNStreamer(model)
        per_chunk = {"lstm_fwd": 2} if model.fused_rnn else {}
        cut = streamer.win
    n = int(SECONDS * 16000)
    chunk_audio_ms = 1e3 * streamer.chunk_samples / 16000
    rng = np.random.default_rng(SEED + 11)
    results = {}
    for batch in batches:
        wav = torch.from_numpy(np.concatenate([utterance(rng, n)[0] for _ in range(batch)])
                               ).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        step = timed_step(streamer)
        got = streamer.enhance(wav, step=step).cpu().numpy()
        ms, state = step.ms, step.state
        launches = read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        want = dict.fromkeys(COUNTED, 0)
        want.update({k: v * len(ms) for k, v in per_chunk.items()})
        if launches != want:
            fail(f"{tag} B {batch}: launches {launches}, want {want} ({len(ms)} chunks)")
        ref = stream_offline(family, model, cfg, wav).float().cpu().numpy()
        interior = n - cut
        if f32:
            err = float(np.abs(got[:, :interior] - ref[:, :interior]).max())
            peak = float(np.abs(ref).max())
            agreement = {"max_err": err, "peak": peak}
            if not np.isfinite(got).all() or err > STREAM_F32_FRAC * peak:
                fail(f"{tag} B {batch}: stream vs offline beyond {STREAM_F32_FRAC} of the "
                     f"peak: {agreement}")
        else:
            agreement = agree([got[:, :interior]], [ref[:, :interior]],
                              f"{tag} B {batch}: stream vs offline")[0]
        tail_err = float(np.abs(got[:, interior:] - ref[:, interior:]).max())
        chunk = torch.zeros((batch, streamer.chunk_samples), device=dev)
        busy_ms, top = device_busy(lambda: streamer.step(state, chunk))
        median = statistics.median(ms[1:])
        results[f"B{batch}"] = {
            "chunks": len(ms), "chunk_ms": ms, "median_chunk_ms": median,
            "rtf": median / chunk_audio_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / median if busy_ms else None, "top_kernels": top,
            "peak_mem_gib": peak_gib, "launches": launches, "agreement": agreement,
            "tail_max_err": tail_err}
        share = results[f"B{batch}"]["device_busy_share"]
        log(f"{tag} B {batch}: {len(ms)} chunks of {streamer.chunk_samples} samples "
            f"({chunk_audio_ms:g} ms) over {SECONDS:g} s; step ms median {median:.3f} (first "
            f"{ms[0]:.1f}, min {min(ms):.3f}, max {max(ms[1:]):.3f}), RTF "
            f"{median / chunk_audio_ms:.4f}; one steady step device busy {busy_ms:.3f} ms "
            f"({'not measured' if share is None else f'{share:.3f}'}); peak {peak_gib:.3f} GiB; "
            f"launches {({k: v for k, v in launches.items() if v})}; stream vs offline interior "
            f"{agreement}, final {cut} samples max err {tail_err:.4g}; top kernels "
            + "; ".join(f"{t['kernel']} {t['ms']:.3f} ms x{t['count']}" for t in top[:4]))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag}: {n_params} params, algorithmic latency {streamer.latency} samples = "
        f"{1e3 * streamer.latency / 16000:g} ms at 16 kHz")
    return {"params": n_params, "latency_samples": streamer.latency,
            "chunk_samples": streamer.chunk_samples, "batches": results}


def stream_kernel_shapes(dev) -> dict:
    """Rows 1 and 9 at the stream's shapes against their plain versions,
    timed beside them: the DCCRN chunk STFT over [300 tail | 1600] samples,
    CRN's LSTM forward at T 16 with a carried, non-zero h0 / c0 (bf16,
    H 1792), at B 1 and B 64; the design each takes."""
    basis = torch.from_numpy(_stft_bases(400, 512)[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for batch in STREAM_BATCHES:
        x = torch.randn((batch, 1900), generator=gen, device=dev)
        err = float((stft_kernel(x, basis, 100, 400) - stft_plain(x, basis, 100, 400)).abs().max())
        if err > STFT_ATOL:
            fail(f"stream shapes: STFT kernel at B {batch} x 1900 off by {err}")
        dim = basis.shape[1]
        flops = 2.0 * batch * 16 * dim * 400
        nbytes = 4.0 * (x.numel() + basis.numel() + batch * 16 * dim)
        design = stft_design(batch, 1900, 100, 400, dim)[0]
        by_ops = (3 * flops / TF32_FLOPS_PER_S if design == "tc" else flops / F32_FLOPS_PER_S)
        out[f"stft B{batch}"] = {
            "design": design, "max_abs_err": err,
            "ms": cuda_ms(lambda: stft_kernel(x, basis, 100, 400)),
            "plain_ms": cuda_ms(lambda: stft_plain(x, basis, 100, 400)),
            "bound_ms": 1e3 * max(by_ops, nbytes / HBM_BYTES_PER_S),
            "bound_by": "operations" if by_ops > nbytes / HBM_BYTES_PER_S else "bytes"}
        x_proj, w_hh, h0, c0 = lstm_inputs(gen, 16, batch, 1792, torch.bfloat16, dev, state=True)
        worst, mean = lstm_close(lstm_k.lstm_fwd(x_proj, w_hh, h0, c0),
                                 lstm_k.fused_lstm_plain(x_proj, w_hh, h0, c0), bf16=True)
        if not np.isfinite(mean):
            fail(f"stream shapes: LSTM forward at T 16, B {batch}, H 1792 beyond its bounds")
        flops, nbytes = lstm_work(16, batch, 1792)
        out[f"lstm_fwd B{batch}"] = {
            "design": lstm_k.lstm_fwd_design(torch.bfloat16, 1792, batch)[0],
            "max_abs_err": worst,
            "ms": cuda_ms(lambda: lstm_k.lstm_fwd(x_proj, w_hh, h0, c0)),
            "plain_ms": cuda_ms(lambda: lstm_k.fused_lstm_plain(x_proj, w_hh, h0, c0)),
            "bound_ms": 1e3 * max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S),
            "bound_by": ("operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
                         else "bytes")}
    for name, row in out.items():
        log(f"stream shapes: {name}: design {row['design']}, max abs err vs plain "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return out


def stream_phase(dev) -> dict:
    """Streaming serving (serve/streaming.py) on the card: rows 1 and 9 at
    the stream's shapes; DCCRN (configs/dccrn_vbd.yaml) and CRN
    (configs/crn_vbd.yaml, fused_rnn) at full width with seeded weights in
    bf16, each streaming a 10 s request at B 1 and at B 64 in 16-frame
    chunks, held to their offline forwards within the serving bounds
    (mean <= 2%, worst <= 20% of the RMS); and a small f32 DCCRN and CRN
    within STREAM_F32_FRAC of the offline peak."""
    out = {"kernel_shapes": stream_kernel_shapes(dev)}
    for family, path in (("dccrn", CONFIG), ("crn", CRN_CONFIG)):
        cfg, model, _ = load_model(dev, path)
        out[family] = stream_family(f"stream {family} ({os.path.basename(path)}, bf16)", dev,
                                    family, cfg, model, STREAM_BATCHES, f32=False)
        del model
    for family, small in (("dccrn", SMALL_STREAM_DCCRN), ("crn", SMALL_CRN)):
        cfg = Config({"model": small})
        model, _ = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(SEED))
        out[f"small_{family}"] = stream_family(f"stream small f32 {family}", dev, family, cfg,
                                               model.eval(), (2,), f32=True)
    return out


def ha_phase(dev) -> dict:
    """The Clarity hearing-aid chain (ha/): a synthetic HA config
    (``make_ha_config``: 44.1 kHz, two listeners, one a scene) and
    ``ClarityScorer`` on the card and on the CPU for two 4 s, 16 kHz stereo
    utterances: amplified signals within HA_AMP_ATOL, the four better-ear
    scores within HA_SCORE_RTOL of the CPU's and inside HA_SCORE_RANGE. ``main``
    runs the phase under ``tf32_allowed()``, as a user's process runs the
    chain. The first utterance is scored on the card
    in this thread for the timing (the chain's seconds, ending in the copy
    to the host, and the host ear model's); the other three scorings run in
    threads beside it. Then the card chain alone, five times on the host
    clock, and its parts by CUDA events."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from speech_enhancement_torch.data.synthetic import make_ha_config
    from speech_enhancement_torch.ha.scoring import ClarityScorer

    tmp = tempfile.mkdtemp(prefix="se_torch_ha_")
    try:
        scenes = [f"S{i:05d}" for i in range(1, HA_SCENES + 1)]
        ha_yaml = make_ha_config(tmp, scenes=scenes, n_listeners=2, fs=44100, seed=SEED)
        card = ClarityScorer(ha_yaml, input_sr=16000, device=dev)
        host = ClarityScorer(ha_yaml, input_sr=16000, device="cpu")
        rng = np.random.default_rng(SEED + 13)
        n = int(HA_SECONDS * 16000)
        items = []
        for scene in scenes:
            # at a tenth of utterance()'s level, which the NAL-R gains and
            # the compressor leave unclipped: on the CPU the scores of these
            # inputs lie in [0.05, 0.9]
            clean = 0.1 * np.concatenate([utterance(rng, n)[0], utterance(rng, n)[0]])  # [2, T]
            noise = rng.standard_normal(clean.shape).astype(np.float32)
            items.append((clean, clean + 0.003 * noise, clean + 0.001 * noise,
                          f"{scene}_mix_CH1"))
        listener = card.listeners_for_scene(scenes[0])[0]
        card.amplify_for_listener(card._resample(items[0][2]), listener)  # first-call set-up
        torch.cuda.synchronize()
        with ThreadPoolExecutor(max_workers=3) as pool:
            futures = ([pool.submit(host.score, *item) for item in items]
                       + [pool.submit(card.score, *item) for item in items[1:]])
            timed = card.score(*items[0])
            results = [f.result() for f in futures]
        on_host, on_card = results[:HA_SCENES], [timed] + results[HA_SCENES:]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("haspi_enhance", "hasqi_enhance", "haspi_mixture", "hasqi_mixture")
    amp_err = max(float(np.abs(c["amplified"] - h["amplified"]).max())
                  for c, h in zip(on_card, on_host))
    score_err = max(abs(c[k] - h[k]) / abs(h[k]) for c, h in zip(on_card, on_host) for k in keys)
    low, high = HA_SCORE_RANGE
    if amp_err > HA_AMP_ATOL or score_err > HA_SCORE_RTOL or not all(
            low <= c[k] <= high for c in on_card for k in keys):
        fail(f"ha: card vs CPU amplified max err {amp_err}, scores max err {score_err}; card "
             f"{[{k: c[k] for k in keys} for c in on_card]}, CPU "
             f"{[{k: h[k] for k in keys} for h in on_host]}")
    clean, mixture, enhanced, name = items[0]

    def chain():
        """What ``score`` runs on the card for one utterance and listener:
        the three resamples, both signals' chains, the copies to the host."""
        card._resample(clean).cpu()
        for signal in (enhanced, mixture):
            card.amplify_for_listener(card._resample(signal), listener).cpu()

    chain_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain()
        chain_ms.append(1e3 * (time.perf_counter() - t0))
    sig = card._resample(enhanced)
    x = card.enhancer.apply(card.enhancer.build(listener["audiogram_levels_l"],
                                                np.asarray(listener["audiogram_cfs"], float)),
                            sig[:1])
    parts = {"resample": cuda_ms(lambda: card._resample(enhanced), reps=10),
             "amplify (one listener, both ears)": cuda_ms(lambda: card.amplify_for_listener(sig, listener),
                                                          reps=10),
             "compressor (one ear)": cuda_ms(lambda: card.compressor(x), reps=10)}
    result = {"scores_card": [{k: c[k] for k in keys} for c in on_card],
              "amp_max_err": amp_err, "score_max_err": score_err,
              "card_amplify_s": timed["amplify_s"], "host_ear_model_s": timed["ear_model_s"],
              "chain_ms": chain_ms, "chain_part_ms": parts}
    log(f"ha: ClarityScorer card vs CPU on {HA_SCENES} utterances of {HA_SECONDS:g} s (16 kHz "
        f"stereo -> 44.1 kHz, one listener a scene): amplified max err {amp_err:.3g}, scores "
        f"max err {score_err:.3g}; card scores {result['scores_card']}")
    log(f"ha: one utterance scored on the card: {timed['amplify_s'] + timed['ear_model_s']:.3f} "
        f"s = amplification chain {1e3 * timed['amplify_s']:.2f} ms (resample, NAL-R, "
        f"compressor of enhanced and mixture, host clock ending in the copy to the host) + "
        f"host ear model {timed['ear_model_s']:.3f} s (HASPI and HASQI of both, three other "
        f"scorings in threads beside it)")
    log(f"ha: the card chain of one utterance and listener alone (three resamples, NAL-R and "
        f"compressor of enhanced and mixture, copies to the host; host clock from a "
        f"synchronize): median {statistics.median(chain_ms):.2f} ms of "
        f"{[round(v, 2) for v in chain_ms]}; parts by CUDA events "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    return result


# -- data parallelism (parallel/mesh.py) ---------------------------------------

DP_UTTERANCES = 96  # 4 to 5 s each: 67 train (3 steps of 16 an epoch), 14 val, 15 test
DP_STEPS = 3
DP_TIMEOUT = 300    # seconds for each spawn's ranks
# the steps held to JAX's pmean, each on its own kernels: (tag, config,
# model overrides, the kernels its step must launch on every rank)
DP_CASES = (
    ("dccrn cbn_fold", CONFIG, {"cbn_fold": True}, ("stft", "mask_e")),
    ("dccrn fused", CONFIG, {"use_fused_blocks": True},
     ("stft", "mask_e", "conv_block", "deconv_block", "enc_bwd_gz", "enc_bwd_dw", "dec_bwd_gz",
      "dec_bwd_dw")),
    ("crn", CRN_CONFIG, {}, ("lstm_fwd", "lstm_bwd")),
)
# running statistics against the mean of the two half-batch steps' (the
# same kernels in one process): within 1% of each buffer's largest magnitude
DP_STATS_RTOL = 0.01


def strict_f32() -> None:
    """The smoke's f32 setting (main()), in a rank process of its own."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dp_batch(path):
    """The host batch of a ``DP_CASES`` step: the config's batch of 16
    four-second rows (DCCRN: N(0, 0.1^2) on the int16 wire; CRN:
    ``crn_train_batch``), made with numpy from the seed."""
    if path == CRN_CONFIG:
        return crn_train_batch()
    rng = np.random.default_rng(SEED + 11)
    n = int(TRAIN_SECONDS * 16000)
    mixture = (0.1 * rng.standard_normal((DCCRN_TRAIN_BATCH, 1, n))).astype(np.float32)
    target = (0.1 * rng.standard_normal((DCCRN_TRAIN_BATCH, 1, 1, n))).astype(np.float32)
    return encode_wire_int16(mixture), encode_wire_int16(target)


def half_step(model, spec, cfg, mixture, sources, dev):
    """JAX's step on one shard without the pmean: loss, flat gradients and
    the running statistics after the forward (no optimizer step)."""
    model_config = cfg.model if spec.domain == "stft" else None
    mixture, target = adapt(spec, decode_wire(mixture, dev), decode_wire(sources, dev),
                            model_config)
    model.train()
    model.zero_grad(set_to_none=True)
    loss = compute_loss("mse", model(mixture), target, mixture)
    loss.backward()
    grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                       for p in model.parameters()])
    return float(loss.detach()), grads, [b.detach().clone() for b in mesh_lib.batch_stats(model)]


def dp_pair_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of two on card 0 over gloo (CUDA tensors): each of
    ``DP_CASES`` one data-parallel step (DDP, the statistics and the loss
    averaged), its launches read just after. Rank 0 then computes JAX's
    pmean in one process: the two half-batch steps from the same weights,
    gradients and statistics averaged. Both ranks check that their
    parameters and buffers equal rank 0's after the step."""
    strict_f32()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    out = {}
    try:
        dev = torch.device("cuda", 0)
        mesh = mesh_lib.make_mesh(data=world, device=dev)
        for tag, path, overrides, _ in DP_CASES:
            mixture, sources = dp_batch(path)
            cfg, model, spec = load_model(dev, path, **overrides)
            opt = get_optimizer(Config(TRAIN_OPTIM), model.parameters())
            ddp = mesh_lib.shard_train_step(model, mesh)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            loss, norm = train_step(ddp, spec, opt, mesh_lib.shard_batch(mesh, mixture),
                                    mesh_lib.shard_batch(mesh, sources), "mse", device=dev,
                                    model_config=cfg.model if spec.domain == "stft" else None)
            stats = mesh_lib.batch_stats(model)
            mesh_lib.pmean_(stats)
            loss = loss.float().reshape(1)
            mesh_lib.pmean_([loss])
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0)
            launches = read_launches()
            state = torch.cat([t.detach().float().flatten() for t in model.state_dict().values()])
            ref_state = state.clone()
            dist.broadcast(ref_state, src=0)
            row = {"wrapper": type(ddp).__name__, "launches": launches, "loss": float(loss),
                   "grad_norm": float(norm), "step_ms": step_ms,
                   "max_diff_to_rank0": float((state - ref_state).abs().max())}
            if rank == 0:
                grads = flat_grads(model)  # clipped in place if norm > clip: same direction
                _, ref, _ = load_model(dev, path, **overrides)
                init = {k: v.clone() for k, v in ref.state_dict().items()}
                halves = []
                for half in range(world):
                    ref.load_state_dict(init)
                    shard = mesh_lib.Mesh(shape=mesh.shape, rank=half, world_size=world,
                                          data_index=half, device=dev, host_ranks=world)
                    halves.append(half_step(ref, spec, cfg, mesh_lib.shard_batch(shard, mixture),
                                            mesh_lib.shard_batch(shard, sources), dev))
                want_loss = sum(h[0] for h in halves) / world
                want_grads = sum(h[1] for h in halves) / world
                want_norm = float(torch.linalg.vector_norm(want_grads))
                stats_err = max(
                    ((got - sum(h[2][i] for h in halves) / world).abs().max()
                     / max(float(got.abs().max()), 1e-12)).item()
                    for i, got in enumerate(stats))
                row.update(pmean={
                    "loss_rel": abs(float(loss) - want_loss) / abs(want_loss),
                    "grad_norm_rel": abs(float(norm) - want_norm) / want_norm,
                    "grad_cosine": F.cosine_similarity(grads, want_grads, dim=0).item(),
                    "stats_rel": stats_err, "n_stats": len(stats)})
                del ref
            out[tag] = row
            del ddp, model, opt
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"pair{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_main_rank(rank: int, world: int, init_file: str, cfg: dict, out_dir: str) -> None:
    """One rank of ``world`` (one a card) over NCCL: ``main()`` trains the
    config with an explicit mesh, as JAX's ``main(mesh=...)``."""
    from speech_enhancement_torch.main import main as port_main

    strict_f32()
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=world, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(data=world, device=torch.device("cuda", rank))
        reset_launches()
        solver = port_main(Config(cfg), mode="train", return_solver=True,
                           run_dir=os.path.join(out_dir, f"ddp_rank{rank}"), mesh=mesh)
        torch.cuda.synchronize()
        torch.save({"launches": read_launches(), "scores": solver.scores,
                    "epoch_stats": solver.epoch_stats,
                    "wrapper": type(solver._train_model).__name__,
                    "backend": dist.get_backend(), "world_size": dist.get_world_size()},
                   os.path.join(out_dir, f"main{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_phase(dev) -> dict:
    """Data-parallel training (parallel/mesh.py: DDP, ``pmean`` of the
    running statistics and the loss) on the card, in three parts:

    * NCCL with one rank a card (``torch.cuda.device_count()``): ``main()``
      with an explicit mesh trains DCCRN at the full width of
      configs/dccrn_vbd.yaml (bf16, si-sdr, B 16; the STFT and mask-E
      kernels) two epochs of 3 steps on 96 synthetic utterances; the same
      config trains in this process without a group. Compares the Solver's
      step ms (epoch 1) and the checkpoints' keys.
    * Two ranks on card 0 over gloo with CUDA tensors: one step each of
      DCCRN ``cbn_fold`` (rows 1, 2), DCCRN ``use_fused_blocks`` (rows 1 to
      8) and CRN with ``fused_rnn`` (rows 9, 10) at full width, host batch
      16 x 4 s, held to JAX's pmean computed in one process (the smoke's
      first-step bounds; the statistics within DP_STATS_RTOL); the ranks'
      parameters and buffers equal after the step; every kernel of a step
      launched on each rank.
    * ``dryrun_multichip(torch.cuda.device_count())``: DCCRN, Demucs with
      remat and Sepformer with the attention kernels (rows 11, 12), one
      data-parallel step each over NCCL.

    Two processes on one card are not a scaling measurement: the step ms
    here say what DDP costs, not what a second card gains."""
    import shutil
    import tempfile

    from speech_enhancement_torch.data.synthetic import make_voicebank_demand
    from speech_enhancement_torch.main import main as port_main
    from speech_enhancement_torch.parallel.dryrun import FAMILIES, dryrun_multichip

    n_cards = torch.cuda.device_count()
    log(f"dp: backends nccl (main(), dryrun_multichip: {n_cards} rank(s), one a card) and gloo "
        f"(two ranks on card 0, CUDA tensors); torch.cuda.device_count() = {n_cards}")
    tmp = tempfile.mkdtemp(prefix="se_torch_dp_")
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    try:
        # the pair and the dry run (correctness only) run together while this
        # process writes the fixture; the two timed main() runs run alone
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            pair = pool.submit(mesh_lib.spawn, dp_pair_rank, 2,
                               (os.path.join(tmp, "pair_init"), tmp), timeout=DP_TIMEOUT)
            dry = pool.submit(dryrun_multichip, n_cards, timeout=DP_TIMEOUT)
            vbd = make_voicebank_demand(os.path.join(tmp, "vbd"), n_utterances=DP_UTTERANCES,
                                        min_seconds=4.0, max_seconds=5.0, seed=SEED)
            pair.result()
            dry = dry.result()
        lap("gloo_pair_and_dryrun")
        cfg = cli_config(CONFIG, tmp, vbd, epochs=2, all_steps=False, total_steps=DP_STEPS,
                         **{"validation.total_steps": 1, "test.total_steps": 1,
                            "test.num_show": 0})
        cfg.dset.split = [0.7, 0.15, 0.15]
        single = port_main(cfg, mode="train", return_solver=True,
                           run_dir=os.path.join(tmp, "single"))
        lap("single_process_main")
        mesh_lib.spawn(dp_main_rank, n_cards,
                       (os.path.join(tmp, "main_init"), cfg.to_dict(), tmp), timeout=DP_TIMEOUT)
        lap("nccl_main")
        ranks_main = [torch.load(os.path.join(tmp, f"main{r}.pt")) for r in range(n_cards)]
        pairs = [torch.load(os.path.join(tmp, f"pair{r}.pt")) for r in range(2)]
        keys = {name: list(torch.load(os.path.join(tmp, name, "checkpoints", "latest_model.ckpt"),
                                      map_location="cpu")["model"])
                for name in ("single", "ddp_rank0")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # NCCL through main()
    single_ms = 1e3 * single.epoch_stats[1]["train_s"] / single.epoch_stats[1]["train_steps"]
    ddp = ranks_main[0]
    ddp_ms = 1e3 * ddp["epoch_stats"][1]["train_s"] / ddp["epoch_stats"][1]["train_steps"]
    for r, found in enumerate(ranks_main):
        if (found["wrapper"] != "DistributedDataParallel" or found["backend"] != "nccl"
                or [e["train_steps"] for e in found["epoch_stats"]] != [DP_STEPS, DP_STEPS]
                or not np.isfinite(found["scores"]["train_loss"]
                                   + found["scores"]["val_loss"]).all()
                or min(found["launches"]["stft"], found["launches"]["mask_e"]) == 0):
            fail(f"dp: main() on NCCL rank {r}: {found}")
    if (keys["single"] != keys["ddp_rank0"]
            or any(k.startswith("module.") for k in keys["ddp_rank0"])):
        fail(f"dp: checkpoint keys differ: DDP {keys['ddp_rank0'][:4]}..., single "
             f"{keys['single'][:4]}...")
    log(f"dp: main() over NCCL ({n_cards} rank(s)), DCCRN configs/dccrn_vbd.yaml B 16: train "
        f"losses {ddp['scores']['train_loss']}, val {ddp['scores']['val_loss']}; DDP Solver "
        f"{ddp_ms:.1f} ms a step (epoch 1) vs the single-process Solver {single_ms:.1f} ms "
        f"(losses {single.scores['train_loss']}); launches rank 0 {ddp['launches']['stft']} stft + "
        f"{ddp['launches']['mask_e']} mask_e; checkpoint keys equal ({len(keys['single'])}, no "
        "module. prefix)")

    # two ranks on one card, held to the pmean computed in one process
    pair_rows = {}
    for tag, path, overrides, kernels_of_step in DP_CASES:
        r0, r1 = pairs[0][tag], pairs[1][tag]
        agreement = r0["pmean"]
        for r, row in enumerate((r0, r1)):
            missing = [k for k in kernels_of_step if row["launches"][k] == 0]
            if row["wrapper"] != "DistributedDataParallel" or missing:
                fail(f"dp {tag}: rank {r} wrapper {row['wrapper']}, kernels not launched "
                     f"{missing}: {row['launches']}")
            if row["max_diff_to_rank0"] != 0.0:
                fail(f"dp {tag}: rank {r}'s parameters and buffers differ from rank 0's by "
                     f"{row['max_diff_to_rank0']}")
        if (r0["loss"] != r1["loss"] or r0["grad_norm"] != r1["grad_norm"]
                or agreement["loss_rel"] > TRAIN_LOSS_RTOL
                or agreement["grad_norm_rel"] > TRAIN_NORM_RTOL
                or agreement["grad_cosine"] < TRAIN_MIN_COSINE
                or agreement["stats_rel"] > DP_STATS_RTOL):
            fail(f"dp {tag}: two ranks vs JAX's pmean in one process: {agreement}; rank losses "
                 f"{r0['loss']} / {r1['loss']}, grad norms {r0['grad_norm']} / {r1['grad_norm']}")
        pair_rows[tag] = [r0, r1]
        log(f"dp {tag} (two gloo ranks on card 0, host batch 16, {os.path.basename(path)} "
            f"{overrides}): loss {r0['loss']:.6f}, grad norm {r0['grad_norm']:.4f} on both ranks; "
            f"vs pmean in one process: loss {agreement['loss_rel']:.2e} (bound "
            f"{TRAIN_LOSS_RTOL}), grad norm {agreement['grad_norm_rel']:.2e} (bound "
            f"{TRAIN_NORM_RTOL}), cosine {agreement['grad_cosine']:.6f} (bound "
            f"{TRAIN_MIN_COSINE}), {agreement['n_stats']} statistics {agreement['stats_rel']:.2e} "
            f"(bound {DP_STATS_RTOL}); parameters and buffers equal on both ranks; DDP step "
            f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms (first step, two processes and the "
            f"dry run on one card); launches rank 0 "
            + json.dumps({k: v for k, v in r0["launches"].items() if v}) + ", rank 1 "
            + json.dumps({k: v for k, v in r1["launches"].items() if v}))

    # the dry run over NCCL
    for r, found in enumerate(dry):
        if min(found["launches"]["mha_fwd"], found["launches"]["mha_bwd"]) == 0 or any(
                found[f]["step"] != 1 for f in FAMILIES):
            fail(f"dp: dryrun_multichip rank {r}: {found}")
    log(f"dp: dryrun_multichip({n_cards}) over NCCL: " + "; ".join(
        f"{f} loss {dry[0][f]['loss']:.4f} grad norm {dry[0][f]['grad_norm']:.4f}"
        for f in FAMILIES) + "; launches rank 0 "
        + json.dumps({k: v for k, v in dry[0]["launches"].items() if v}))
    log(f"dp: seconds by part {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")

    runs = {f"{tag} rank {r}": pairs[r][tag]["launches"] for tag, *_ in DP_CASES for r in range(2)}
    runs.update({f"main rank {r}": found["launches"] for r, found in enumerate(ranks_main)})
    runs.update({f"dryrun rank {r}": found["launches"] for r, found in enumerate(dry)})
    launches = {name: {run: got[name] for run, got in runs.items() if got[name]}
                for name in COUNTED}
    return {"seconds": seconds, "single_step_ms": single_ms, "ddp_step_ms": ddp_ms,
            "main": ranks_main, "pairs": pair_rows, "dryrun": dry, "launches": launches,
            "n_cards": n_cards}


CLI_UTTERANCES = 184  # 4 to 10 s each: 128 train (8 steps of 16), 27 val, 29 test
CLI_SCENES = 12       # Clarity scenes of 4 s: 8 train (2 steps of 4), 1 val, 3 test


def cli_config(path, tmp, data_root, **solver):
    """The config at ``path`` pointed at a fixture under ``tmp``, with the
    solver overrides ``solver`` (dotted keys into solver.validation/test)."""
    cfg = load_config(path)
    cfg.dset.wav = data_root
    cfg.solver.root = os.path.join(tmp, "runs")
    for key, value in solver.items():
        section, _, field = key.rpartition(".")
        target = cfg.solver if not section else cfg.solver[section]
        target[field] = value
    return cfg


def cli_phase(dev) -> dict:
    """The port's ``main()`` in this process (so the launch counters can be
    read) on fixtures from its own ``data/synthetic.py``, in a temporary
    directory:

    DCCRN at the full width of configs/dccrn_vbd.yaml (bf16, si-sdr, batch
    16, the unfused path: STFT and mask-E kernels) on 184
    VoiceBank-DEMAND-like utterances of 4 to 10 s, split 0.7 / 0.15 / 0.15:
    two epochs of 8 steps with 4 validation batches, then ``--mode test
    --save`` resumed from that run dir on 6 utterances with SI-SDR, STOI and
    PESQ. Checks every artifact, finite losses, both kernels launched in
    both modes, and one enhanced wav against ``evaluate_utterance`` on the
    resumed model. Times a Solver step against a bare ``train_step`` on
    one of its batches, and takes the device-busy share of one more
    training epoch.

    Sepformer at the full width of configs/sepformer_clarity.yaml (batch 4,
    two speakers, si-sdr with PIT) on Clarity scenes of 4 s, with ``ha:``
    set to a synthetic 44.1 kHz hearing-aid config: one epoch of 2 steps,
    then ``--mode test`` resumed on 2 scenes, whose results.csv must hold
    HASPI / HASQI columns in [0, 1]; both attention kernels must launch.

    Then ``python -m speech_enhancement_torch --mode validation`` in a
    subprocess on the DCCRN run; it must exit 0 and print its loss."""
    import shutil
    import tempfile

    from speech_enhancement_torch.config import save_yaml
    from speech_enhancement_torch.data.synthetic import (make_clarity, make_ha_config,
                                                         make_voicebank_demand)
    from speech_enhancement_torch.data.wav_io import read_wav
    from speech_enhancement_torch.main import main as port_main
    from speech_enhancement_torch.train import metrics as metrics_lib

    tmp = tempfile.mkdtemp(prefix="se_torch_cli_")
    seconds, peaks = {}, {}
    torch.cuda.reset_peak_memory_stats()
    clock = [time.perf_counter()]

    def lap(name):
        """Seconds and peak device memory of the part since the last lap."""
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        clock[0] = now

    try:
        vbd = make_voicebank_demand(os.path.join(tmp, "vbd"), n_utterances=CLI_UTTERANCES,
                                    min_seconds=4.0, max_seconds=10.0, seed=SEED)
        clarity = make_clarity(os.path.join(tmp, "clarity"), n_scenes=CLI_SCENES, seconds=4.0,
                               seed=SEED)
        cfg = cli_config(CONFIG, tmp, vbd, epochs=2, all_steps=False, total_steps=8,
                         **{"validation.total_steps": 4, "test.total_steps": 6,
                            "test.metrics": ["sisdr", "stoi", "pesq"], "test.num_show": 0})
        cfg.dset.split = [0.7, 0.15, 0.15]
        lap("fixtures")

        reset_launches()
        train_dir = os.path.join(tmp, "dccrn_train")
        solver = port_main(cfg, mode="train", return_solver=True, run_dir=train_dir)
        train_launches = read_launches()
        scores, stats = solver.scores, solver.epoch_stats
        losses = scores["train_loss"] + scores["val_loss"]
        if len(scores["train_loss"]) != 2 or not np.isfinite(losses).all():
            fail(f"cli: DCCRN train losses {scores}")
        if [e["train_steps"] for e in stats] != [8, 8]:
            fail(f"cli: DCCRN train steps {[e['train_steps'] for e in stats]}, want 8 a epoch")
        files = os.listdir(solver.checkpoint_dir)
        if not ({"latest_model.ckpt", "best_model.ckpt", "state.json"} <= set(files)
                and any(f.startswith("model_") for f in files)):
            fail(f"cli: DCCRN checkpoints {files}")
        if min(train_launches["stft"], train_launches["mask_e"]) == 0:
            fail(f"cli: DCCRN training did not launch the STFT and mask-E kernels: "
                 f"{train_launches}")
        solver_step_ms = 1e3 * stats[1]["train_s"] / stats[1]["train_steps"]
        lap("dccrn_train")

        # the bare train_step on one of the loader's batches, same model
        batch = next(iter(solver.train_loader))
        bare = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = train_step(solver.model, solver.spec, solver.optimizer, batch["mixture"],
                                 batch["sources"], solver.loss_name, device=dev)
            float(loss)
            bare.append(1e3 * (time.perf_counter() - t))
        bare_ms = statistics.median(bare[1:])
        lap("dccrn_bare_steps")
        # the profiler's bookkeeping of some 185,000 launches a step costs
        # minutes over a whole epoch: the profiled epoch is capped at 2
        # steps, and its busy time is set against 2 steps of epoch 1
        solver.config.solver.total_steps = 2
        busy_ms, top = device_busy(lambda: solver._run_one_epoch(2, train=True))
        epoch_ms = solver._epoch_steps * solver_step_ms
        lap("dccrn_profiled_epoch")

        reset_launches()
        cfg.solver.resume = train_dir
        test_dir = os.path.join(tmp, "dccrn_test")
        tester = port_main(cfg, mode="test", return_solver=True, save=True, run_dir=test_dir)
        test_launches = read_launches()
        if min(test_launches["stft"], test_launches["mask_e"]) == 0:
            fail(f"cli: DCCRN test did not launch the STFT and mask-E kernels: {test_launches}")
        with open(os.path.join(test_dir, "results.csv")) as handle:
            rows = handle.read().strip().splitlines()[1:]
        with open(os.path.join(test_dir, "test_summary.json")) as handle:
            summary = json.load(handle)
        wavs = sorted(os.listdir(os.path.join(test_dir, "enhanced")))
        if len(rows) != 6 or len(wavs) != 6 or sorted(summary["enhanced"]) != [
                "pesq", "sisdr", "stoi"] or not all(
                np.isfinite(v) for side in summary.values() for v in side.values()):
            fail(f"cli: DCCRN test artifacts: {len(rows)} rows, {len(wavs)} wavs, {summary}")
        item = tester.test_loader.dataset[0]
        saved, _ = read_wav(os.path.join(test_dir, "enhanced", f"{item['name']}.wav"))
        direct = evaluate_utterance(item["mixture"][None], tester.model, tester.spec, cfg,
                                    device=dev)[0]
        wav_agreement = agree([saved], [direct], "cli: saved wav vs evaluate_utterance")[0]
        timing = tester.test_timing
        pesq_impl = metrics_lib.pesq_backend()[2]
        lap("dccrn_test")

        t = time.perf_counter()
        yaml_path = os.path.join(tmp, "dccrn_cli.yaml")
        save_yaml(cfg, yaml_path)
        proc = subprocess.run(
            [sys.executable, "-m", "speech_enhancement_torch", "--config", yaml_path,
             "--mode", "validation", "--run-dir", os.path.join(tmp, "dccrn_cli")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t
        found = re.search(r"validation loss=(\S+)", proc.stdout)
        if proc.returncode != 0 or not found or not np.isfinite(float(found.group(1))):
            fail(f"cli: python -m speech_enhancement_torch --mode validation exited "
                 f"{proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
        cli_loss = float(found.group(1))
        lap("cli_subprocess")

        # mel-rnn (configs/mel_rnn_vbd.yaml copied, widths as shipped) on the
        # same corpus: two epochs of 4 steps at B 16, then a resumed test
        reset_launches()
        mel_cfg = cli_config(MEL_CONFIG, tmp, vbd, epochs=2, all_steps=False, total_steps=4,
                             **{"validation.total_steps": 2, "test.total_steps": 3,
                                "test.metrics": ["sisdr", "stoi"], "test.num_show": 0})
        mel_cfg.dset.split = [0.7, 0.15, 0.15]
        mel_dir = os.path.join(tmp, "mel_train")
        mel = port_main(mel_cfg, mode="train", return_solver=True, run_dir=mel_dir)
        mel_train_launches = read_launches()
        mel_losses = mel.scores["train_loss"] + mel.scores["val_loss"]
        if ([e["train_steps"] for e in mel.epoch_stats] != [4, 4]
                or not np.isfinite(mel_losses).all()
                or "latest_model.ckpt" not in os.listdir(mel.checkpoint_dir)):
            fail(f"cli: mel-rnn run: {mel.epoch_stats}, {mel.scores}, "
                 f"{os.listdir(mel.checkpoint_dir)}")
        if min(mel_train_launches["lstm_fwd"], mel_train_launches["lstm_bwd"]) == 0:
            fail(f"cli: mel-rnn training did not launch the LSTM kernels: {mel_train_launches}")
        mel_step_ms = 1e3 * mel.epoch_stats[1]["train_s"] / mel.epoch_stats[1]["train_steps"]
        batch = next(iter(mel.train_loader))
        mel_bare = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = train_step(mel.model, mel.spec, mel.optimizer, batch["mixture"],
                                 batch["sources"], mel.loss_name, device=dev,
                                 model_config=mel.config.model)
            float(loss)
            mel_bare.append(1e3 * (time.perf_counter() - t))
        reset_launches()
        mel_cfg.solver.resume = mel_dir
        mel_test_dir = os.path.join(tmp, "mel_test")
        mel_tester = port_main(mel_cfg, mode="test", return_solver=True, run_dir=mel_test_dir)
        mel_test_launches = read_launches()
        with open(os.path.join(mel_test_dir, "results.csv")) as handle:
            mel_rows = handle.read().strip().splitlines()[1:]
        mel_timing = mel_tester.test_timing
        if len(mel_rows) != 3 or mel_test_launches["lstm_fwd"] == 0:
            fail(f"cli: mel-rnn test: {len(mel_rows)} rows, launches {mel_test_launches}")
        lap("mel_rnn")

        reset_launches()
        sep_cfg = cli_config(SEP_CONFIG, tmp, clarity, epochs=1, all_steps=False, total_steps=2,
                             **{"validation.total_steps": 1, "test.total_steps": 2,
                                "test.metrics": ["sisdr", "stoi"], "test.num_show": 0})
        sep_cfg.dset.split = [0.7, 0.1, 0.2]
        # the Clarity hearing-aid columns: a 44.1 kHz HA config, one listener a scene
        sep_cfg.ha = make_ha_config(os.path.join(tmp, "ha"), n_listeners=2, fs=44100, seed=SEED,
                                    scenes=[f"S{i:05d}" for i in range(1, CLI_SCENES + 1)])
        sep_dir = os.path.join(tmp, "sep")
        sep = port_main(sep_cfg, mode="train", return_solver=True, run_dir=sep_dir)
        sep_train_launches = read_launches()
        reset_launches()
        sep_cfg.solver.resume = sep_dir
        sep_test_dir = os.path.join(tmp, "sep_test")
        sep_tester = port_main(sep_cfg, mode="test", return_solver=True, run_dir=sep_test_dir)
        sep_test_launches = read_launches()
        with open(os.path.join(sep_test_dir, "test_summary.json")) as handle:
            sep_summary = json.load(handle)
        with open(os.path.join(sep_test_dir, "results.csv")) as handle:
            sep_rows = list(csv.DictReader(handle))
        ha_cols = ("haspi_enhance", "haspi_mixture", "hasqi_enhance", "hasqi_mixture")
        ha_values = [float(row[col]) for row in sep_rows for col in ha_cols]
        sep_losses = sep.scores["train_loss"] + sep.scores["val_loss"]
        if (not sep.use_pit or sep.epoch_stats[0]["train_steps"] != 2
                or not np.isfinite(sep_losses).all()
                or sep_tester.test_timing["utterances"] != 2 or len(sep_rows) != 2
                or not np.isfinite(sep_summary["enhanced"]["sisdr"])):
            fail(f"cli: Sepformer run: pit {sep.use_pit}, {sep.epoch_stats}, {sep.scores}, "
                 f"{len(sep_rows)} rows, {sep_summary}")
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in ha_values) or not {
                "haspi", "hasqi"} <= set(sep_summary["enhanced"]):
            fail(f"cli: Sepformer --mode test HA columns {ha_values}, summary {sep_summary}")
        if min(sep_train_launches["mha_fwd"], sep_train_launches["mha_bwd"],
               sep_test_launches["mha_fwd"]) == 0:
            fail(f"cli: Sepformer did not launch the attention kernels: train "
                 f"{sep_train_launches}, test {sep_test_launches}")
        lap("sepformer")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    share = busy_ms / epoch_ms if busy_ms else None
    result = {
        "seconds": seconds, "peak_mem_gib": peaks, "dccrn_epoch_wall_s": scores["epoch_wall_s"],
        "dccrn_epoch_stats": stats, "dccrn_solver_step_ms": solver_step_ms,
        "dccrn_bare_step_ms": bare, "dccrn_train_losses": scores,
        "dccrn_epoch_device_busy_ms": busy_ms, "dccrn_epoch_device_busy_share": share,
        "dccrn_test_timing": timing, "dccrn_test_summary": summary, "pesq": pesq_impl,
        "wav_agreement": wav_agreement, "cli_validation_loss": cli_loss, "cli_s": cli_s,
        "launches": {"train": train_launches, "test": test_launches,
                     "sepformer_train": sep_train_launches, "sepformer_test": sep_test_launches},
        "sepformer_epoch_stats": sep.epoch_stats,
        "sepformer_test_timing": sep_tester.test_timing, "sepformer_test_summary": sep_summary,
        "mel_rnn": {"epoch_stats": mel.epoch_stats, "scores": mel.scores,
                    "solver_step_ms": mel_step_ms, "bare_step_ms": mel_bare,
                    "test_timing": mel_timing,
                    "launches": {"train": mel_train_launches, "test": mel_test_launches}},
    }
    log(f"cli: fixtures ({CLI_UTTERANCES} utterances of 4 to 10 s, {CLI_SCENES} Clarity scenes "
        f"of 4 s); seconds by part {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"peak GiB by part {json.dumps({k: round(v, 2) for k, v in peaks.items()})}")
    log(f"cli: DCCRN (configs/dccrn_vbd.yaml, bf16, si-sdr, B 16) train losses "
        f"{scores['train_loss']}, val {scores['val_loss']}; epoch wall s "
        f"{scores['epoch_wall_s']} (epoch 0 warms up); epoch 1: 8 steps in "
        f"{stats[1]['train_s']:.3f} s, validation {stats[1]['val_s']:.3f} s")
    log(f"cli: DCCRN Solver {solver_step_ms:.1f} ms a train step (epoch 1, loader and Solver "
        f"included) vs bare train_step {bare_ms:.1f} ms on one of its batches (calls "
        f"{[round(x, 1) for x in bare]}; the train phase's bare step is at B 128); one more "
        f"training epoch of 2 steps device busy {busy_ms:.1f} ms of {epoch_ms:.1f} "
        f"({'not measured' if share is None else f'{share:.3f}'}); top kernels "
        + "; ".join(f"{t['kernel']} {t['ms']:.1f} ms x{t['count']}" for t in top[:5]))
    per_utt = {k: timing[k] / timing["utterances"] for k in ("wall_s", "device_s", "scoring_s")}
    log(f"cli: DCCRN test (resumed, --save): {timing['utterances']} utterances in "
        f"{timing['wall_s']:.3f} s = {per_utt['wall_s']:.3f} s each: evaluate_utterance "
        f"(device, host clock ending in the fetch) {per_utt['device_s']:.3f} s, host scoring "
        f"(SI-SDR, STOI, PESQ of enhanced and mixture, two threads) {per_utt['scoring_s']:.3f} "
        f"s; PESQ implementation {pesq_impl}; summary {summary}")
    log(f"cli: saved wav vs evaluate_utterance on the resumed model {wav_agreement}; launches "
        f"train {train_launches['stft']} stft + {train_launches['mask_e']} mask_e, test "
        f"{test_launches['stft']} + {test_launches['mask_e']}")
    log(f"cli: python -m speech_enhancement_torch --mode validation: exit 0, validation loss "
        f"{cli_loss:.5f}, {cli_s:.1f} s (a new process: CUDA start, model build, 4 batches)")
    mel_utt = {k: mel_timing[k] / mel_timing["utterances"]
               for k in ("wall_s", "device_s", "scoring_s")}
    log(f"cli: mel-rnn (configs/mel_rnn_vbd.yaml, f32, fused_rnn, B 16) train losses "
        f"{mel.scores['train_loss']}, val {mel.scores['val_loss']}; Solver {mel_step_ms:.1f} ms "
        f"a train step (epoch 1) vs bare train_step {statistics.median(mel_bare[1:]):.1f} ms "
        f"(calls {[round(x, 1) for x in mel_bare]}); test (resumed) "
        f"{mel_timing['utterances']} utterances, {mel_utt['wall_s']:.3f} s each (device "
        f"{mel_utt['device_s']:.3f}, scoring {mel_utt['scoring_s']:.3f}); launches train "
        f"{mel_train_launches['lstm_fwd']} + {mel_train_launches['lstm_bwd']}, test "
        f"{mel_test_launches['lstm_fwd']}")
    sep_timing = sep_tester.test_timing
    log(f"cli: Sepformer (configs/sepformer_clarity.yaml, B 4, PIT) train losses "
        f"{sep.scores['train_loss']}, val {sep.scores['val_loss']}; {sep.epoch_stats}; test "
        f"(--mode test, resumed, ha: 44.1 kHz, one listener a scene) {sep_timing}; summary "
        f"{sep_summary}; mha launches train {sep_train_launches['mha_fwd']} + "
        f"{sep_train_launches['mha_bwd']}, test {sep_test_launches['mha_fwd']}")
    log(f"cli: Sepformer HA scoring per utterance: amplification chain on the card "
        f"{1e3 * sep_timing['ha_amplify_s'] / sep_timing['utterances']:.2f} ms, host ear model "
        f"{sep_timing['ha_ear_model_s'] / sep_timing['utterances']:.3f} s (two scoring threads)")
    return result


# -- rematerialisation with named saves, and the user tools -----------------------

# DCCRN at bench.py's point (cbn_fold), remat off and three JAX policies; a
# name Sepformer tags and one it does not, at its config's B 4
DCCRN_REMAT = (("off", {}), ("remat ''", {"remat": True, "remat_policy": ""}),
               ("conv_out,cbn_stats", {"remat": True, "remat_policy": "conv_out,cbn_stats"}),
               ("cbn_stats", {"remat": True, "remat_policy": "cbn_stats"}))
# (tag, overrides, mha_fwd launches a step): "" recomputes every layer's
# attention in backward, attn_out keeps it (counted on the CPU:
# tests/test_torch_remat.py)
SEP_REMAT = (("off", {}, SEP_LAUNCHES), ("remat ''", {"remat": True}, 2 * SEP_LAUNCHES),
             ("attn_out", {"remat": True, "remat_policy": "attn_out"}, SEP_LAUNCHES))
REMAT_STATS_RTOL = 0.01  # running statistics after one step: 1% of each buffer's scale


def running_stats(model) -> dict:
    return {k: b.detach().float().clone() for k, b in model.named_buffers()
            if k.rsplit(".", 1)[-1] in ("RMr", "RMi", "RVrr", "RVri", "RVii")}


def remat_phase(dev) -> dict:
    """DCCRN at bench.py's point (configs/dccrn_vbd.yaml, bf16, unfused
    ``cbn_fold``, B 128 x 4 s, MSE, Adam 3e-4, clip 5, int16 wire): three
    train steps each with remat off, ``remat_policy`` "", "conv_out,
    cbn_stats" and "cbn_stats"; step ms (median of steps 2 to 3), peak GiB
    and the STFT and mask-E launches a step (once each: both stay outside
    the recomputed blocks). Each first step against remat off's (the
    first-step bounds), and the running statistics after it within
    REMAT_STATS_RTOL of each buffer's scale (a second momentum update on
    the recompute would move them by 0.1 of their change). Then Sepformer
    at its config's B 4: remat off, "" and "attn_out", with the attention
    kernels' launches a step."""
    wire_m, wire_s = train_batch(int(load_config(CONFIG).dset.sample_rate))
    rows, grads, stats = {}, {}, {}
    for tag, options in DCCRN_REMAT:
        rows[tag], grads[tag] = train_path(
            f"dccrn remat {tag}", dev, wire_m, wire_s, detail=False, cbn_fold=True,
            first_step=lambda model, tag=tag: stats.__setitem__(tag, running_stats(model)),
            **options)
        expect_launches(f"dccrn remat {tag}", rows[tag]["launches"], stft=TRAIN_STEPS,
                        mask_e=TRAIN_STEPS)
    result = {"dccrn": {}, "sepformer": {}}
    for tag, row in rows.items():
        entry = remat_entry(row)
        if tag != "off":
            entry["first_step"] = first_step_agreement(f"dccrn remat {tag}", rows["off"],
                                                       grads["off"], row, grads[tag],
                                                       "remat vs remat off")
            worst = max(((stats[tag][k] - v).abs().max() / v.abs().max()).item()
                        for k, v in stats["off"].items())
            if not np.isfinite(worst) or worst > REMAT_STATS_RTOL:
                fail(f"dccrn remat {tag}: running statistics after one step {worst:.2e} of a "
                     f"buffer's scale from remat off's (bound {REMAT_STATS_RTOL})")
            entry["stats_rel"] = worst
        result["dccrn"][tag] = entry
        log(f"remat dccrn {tag}: step {entry['step_ms']:.1f} ms, peak {entry['peak_gib']:.2f} "
            f"GiB, launches a step {entry['launches_a_step']}"
            + (f", statistics {entry['stats_rel']:.2e} of their scale from remat off's"
               if tag != "off" else ""))

    mixture, sources = sepformer_train_batch()
    sep_rows, sep_grads = {}, {}
    for tag, options, fwd in SEP_REMAT:
        sep_rows[tag], sep_grads[tag] = train_path(
            f"sepformer remat {tag}", dev, mixture, sources, SEP_CONFIG, "si-sdr", SEP_OPTIM,
            detail=False, **options)
        expect_launches(f"sepformer remat {tag}", sep_rows[tag]["launches"],
                        mha_fwd=fwd * TRAIN_STEPS, mha_bwd=SEP_LAUNCHES * TRAIN_STEPS)
        entry = remat_entry(sep_rows[tag])
        if tag != "off":
            entry["first_step"] = first_step_agreement(
                f"sepformer remat {tag}", sep_rows["off"], sep_grads["off"], sep_rows[tag],
                sep_grads[tag], "remat vs remat off", REMAT_MIN_COSINE)
        result["sepformer"][tag] = entry
        log(f"remat sepformer {tag}: step {entry['step_ms']:.1f} ms, peak "
            f"{entry['peak_gib']:.2f} GiB, launches a step {entry['launches_a_step']}")
    return result


def remat_entry(row: dict) -> dict:
    """A ``train_path`` row's step ms, peak and launches a step."""
    return {"step_ms": row["median_step_ms_2_to_3"], "peak_gib": row["peak_mem_gib"],
            "launches_a_step": {k: v / TRAIN_STEPS for k, v in row["launches"].items() if v}}


TOOLS_UTTERANCES = 24  # 48 kHz, 4 to 5 s each; 16 of them train
# runs a port module as ``python -m`` would, then prints the kernels'
# launches in the process and whether anything of JAX was imported
TOOL_RUNNER = (
    "import json, runpy, sys\n"
    "module = sys.argv[1]\n"
    "sys.argv = [module] + sys.argv[2:]\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "from speech_enhancement_torch.kernels import counted\n"
    "print('TOOL ' + json.dumps({'launches': {k: w.launches for k, w in counted().items()},\n"
    "    'jax_modules': sorted(m for m in sys.modules if m.split('.')[0] in\n"
    "                          ('jax', 'jaxlib', 'flax', 'speech_enhancement_tpu'))}))\n")


def run_tool(module: str, *args: str, timeout: int = 300) -> dict:
    """``python -m module args`` through TOOL_RUNNER in a subprocess on the
    card; fails unless it exits 0 with no JAX module imported. Returns its
    seconds, stdout and launches."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TOOL_RUNNER, module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t
    found = re.search(r"^TOOL (.*)$", proc.stdout, re.M)
    if proc.returncode != 0 or not found:
        fail(f"tools: {module} {' '.join(args)} exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    report = json.loads(found.group(1))
    if report["jax_modules"]:
        fail(f"tools: {module} imported {report['jax_modules']}")
    return {"seconds": seconds, "stdout": proc.stdout, "launches": report["launches"]}


def tools_phase(dev) -> dict:
    """The user tools on the card, each a subprocess that imports no JAX: a
    synthetic 48 kHz VoiceBank-DEMAND tree (data/synthetic.py) laid out at
    16 kHz by ``python -m speech_enhancement_torch.tools.prepare_data vbd
    --sample-rate 16000`` (resampled on the card); one DCCRN epoch of 2
    steps at the full width of configs/dccrn_vbd.yaml on the prepared tree
    through ``python -m speech_enhancement_torch``; then ``python -m
    speech_enhancement_torch.tools.inference`` on one noisy file of it.
    Checks the prepared tree (every file at 16 kHz, ceil(n / 3) samples),
    the enhanced file (finite, the input's length, within the bf16 serving
    bounds of ``evaluate_utterance`` on the run's checkpoint in this
    process) and that the STFT and mask-E kernels launched in training and
    in the tool."""
    import shutil
    import tempfile

    from speech_enhancement_torch.config import save_yaml
    from speech_enhancement_torch.data.synthetic import make_voicebank_demand
    from speech_enhancement_torch.data.wav_io import read_wav
    from speech_enhancement_torch.train import checkpoints as ckpt

    tmp = tempfile.mkdtemp(prefix="se_torch_tools_")
    try:
        src = make_voicebank_demand(os.path.join(tmp, "vbd48"), n_utterances=TOOLS_UTTERANCES,
                                    sr=48000, min_seconds=4.0, max_seconds=5.0, seed=SEED)
        dst = os.path.join(tmp, "vbd16")
        prep = run_tool("speech_enhancement_torch.tools.prepare_data", "vbd", "--src", src,
                        "--dst", dst, "--sample-rate", "16000")
        summary = json.loads(re.search(r'^(\{"dataset".*)$', prep["stdout"], re.M).group(1))
        if summary.get("noisy_trainset_wav") != TOOLS_UTTERANCES or summary.get(
                "clean_trainset_wav") != TOOLS_UTTERANCES:
            fail(f"tools: prepare_data summary {summary}")
        for kind in ("noisy", "clean"):
            for name in sorted(os.listdir(os.path.join(src, f"{kind}_trainset_wav"))):
                wav48, _ = read_wav(os.path.join(src, f"{kind}_trainset_wav", name))
                wav16, sr = read_wav(os.path.join(dst, f"{kind}_trainset_wav", name))
                if sr != 16000 or wav16.shape[-1] != -(-wav48.shape[-1] // 3) or not (
                        np.isfinite(wav16).all()):
                    fail(f"tools: prepared {kind} {name}: {sr} Hz, {wav16.shape}")

        cfg = cli_config(CONFIG, tmp, dst, epochs=1, all_steps=False, total_steps=2,
                         **{"validation.total_steps": 1, "test.total_steps": 0,
                            "test.num_show": 0})
        cfg.dset.split = [0.7, 0.15, 0.15]
        yaml_path = os.path.join(tmp, "dccrn_tools.yaml")
        save_yaml(cfg, yaml_path)
        run_dir = os.path.join(tmp, "run")
        train = run_tool("speech_enhancement_torch", "--config", yaml_path, "--mode", "train",
                         "--run-dir", run_dir)
        if ckpt.latest_checkpoint(run_dir) is None:
            fail(f"tools: the training run wrote no checkpoint: {train['stdout'][-1500:]}")

        noisy = os.path.join(dst, "noisy_trainset_wav", "p000_000.wav")
        clean = os.path.join(dst, "clean_trainset_wav", "p000_000.wav")
        out = os.path.join(tmp, "enhanced.wav")
        infer = run_tool("speech_enhancement_torch.tools.inference", "--run-dir", run_dir,
                         "--wav", noisy, "--out", out, "--clean", clean)
        got, sr = read_wav(out)
        wav, _ = read_wav(noisy)
        if sr != 16000 or got.shape != wav.shape or not np.isfinite(got).all():
            fail(f"tools: enhanced {got.shape} at {sr} Hz for an input of {wav.shape}")
        scores = re.search(r"scores vs clean: (.*)$", infer["stdout"], re.M)
        if not scores:
            fail(f"tools: inference printed no scores: {infer['stdout'][-800:]}")
        model, spec = build_model(load_config(os.path.join(run_dir, "config.yaml")).model,
                                  device=dev)
        model.load_state_dict(ckpt.model_state(ckpt.latest_checkpoint(run_dir)))
        direct = evaluate_utterance(wav[None], model, spec, cfg, device=dev)[0]
        agreement = agree([got], [direct], "tools: inference tool vs evaluate_utterance")[0]
        for what, row in (("training", train), ("inference", infer)):
            if min(row["launches"]["stft"], row["launches"]["mask_e"]) == 0:
                fail(f"tools: {what} did not launch the STFT and mask-E kernels: "
                     f"{row['launches']}")
        result = {"prepare_s": prep["seconds"], "train_s": train["seconds"],
                  "inference_s": infer["seconds"], "scores": scores.group(1),
                  "agreement": agreement,
                  "launches": {what: {k: v for k, v in row["launches"].items() if v}
                               for what, row in (("prepare", prep), ("train", train),
                                                 ("inference", infer))}}
        log(f"tools: prepare_data {prep['seconds']:.1f} s ({2 * TOOLS_UTTERANCES} files 48 -> "
            f"16 kHz), train {train['seconds']:.1f} s, inference {infer['seconds']:.1f} s "
            f"(subprocesses, with their start); scores {result['scores']}; the tool vs "
            f"evaluate_utterance {agreement}; launches {result['launches']}; no JAX imported")
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card")
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("set torch.backends.cudnn.allow_tf32=False and torch.backends.cuda.matmul.allow_tf32=False")

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(built)} in {build_s:.1f} s (nvcc, sm_90a, one process per source)")
    for name in sorted(built):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    for name, usage in attention_registers().items():
        log(f"attention kernel {name}: {usage['registers']} registers, {usage['spill_stores']} "
            f"bytes of spill stores, {usage['spill_loads']} of spill loads")

    kernel_num = load_config(CONFIG).model.kernel_num
    seconds = {"build": build_s}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    kernels = phase("kernel", kernel_phase, dev)
    kernels.update(phase("block_kernel", block_kernel_phase, dev, kernel_num))
    kernels.update(phase("bwd_kernel", bwd_kernel_phase, dev, kernel_num))
    kernels.update(phase("lstm_kernel", lstm_kernel_phase, dev))
    kernels.update(phase("attention_kernel", attention_kernel_phase, dev))
    phase("grad", grad_phase, dev)
    phase("reference", reference_phase, dev)
    phase("train_reference", train_reference_phase, dev)
    phase("crn_reference", crn_reference_phase, dev)
    phase("sepformer_reference", sepformer_reference_phase, dev)
    unfused, outs, requests = phase("slice", slice_phase, dev)
    fused = phase("fused_slice", fused_slice_phase, dev, outs, requests)
    train = phase("train", train_phase, dev)
    crn = phase("crn_slice", crn_slice_phase, dev)
    crn_train = phase("crn_train", crn_train_phase, dev)
    phase("rnn_stft_mask_slice", rnn_stft_mask_slice_phase, dev)
    sep = phase("sepformer_slice", sepformer_slice_phase, dev)
    sep_train = phase("sepformer_train", sepformer_train_phase, dev)
    phase("mel_rnn", mel_rnn_phase, dev)
    phase("rnn_stft_mask_train", rnn_stft_mask_train_phase, dev)
    phase("sepformer_options", sepformer_options_phase, dev)
    remat = phase("remat", remat_phase, dev)
    phase("dccrn_real_lstm", dccrn_real_lstm_phase, dev)
    phase("zoo", zoo_phase, dev)
    wide = phase("wide_lstm", wide_lstm_phase, dev)
    stream = phase("stream", stream_phase, dev)
    with tf32_allowed():
        phase("ha", ha_phase, dev)
    dp = phase("dp", dp_phase, dev)
    phase("cli", cli_phase, dev)
    tools = phase("tools", tools_phase, dev)
    log(f"seconds by phase {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; total "
        f"{time.perf_counter() - t0:.1f} s")
    # each kernel's launches on the path that is its own: the unfused serve
    # for the STFT and mask E, the fused serve for the block kernels, the
    # fused train steps for their backward kernels, the CRN serve for the
    # LSTM forward and the CRN train steps for the LSTM backward, the
    # Sepformer serve and train steps for the attention forward and backward
    for name, entry in kernels.items():
        source = (unfused["launches"] if name in ("stft", "mask_e") else
                  fused["launches"] if name in ("conv_block", "deconv_block") else
                  crn["launches"] if name == "lstm_fwd" else
                  crn_train["fused"]["launches"] if name == "lstm_bwd" else
                  sep["launches"] if name == "mha_fwd" else
                  sep_train["fused"]["launches"] if name == "mha_bwd" else
                  train["fused"]["launches"])
        entry["launches"] = source[name]
        # the streams' launches (serve/streaming.py), each from its own run
        streamed = {f"{family} {batch}": row["launches"][name] for family in ("dccrn", "crn")
                    for batch, row in stream[family]["batches"].items() if row["launches"][name]}
        if streamed:
            entry["stream_launches"] = streamed
        # the data-parallel runs' launches, each rank's own (dp_phase)
        entry["dp_launches"] = dp["launches"][name]
        # a train step's under each remat policy (remat_phase), and the user
        # tools' subprocesses (tools_phase)
        family = "sepformer" if name.startswith("mha") else "dccrn"
        remat_a_step = {tag: row["launches_a_step"].get(name, 0)
                        for tag, row in remat[family].items()}
        if any(remat_a_step.values()):
            entry["remat_launches_a_step"] = {f"{family} {k}": v for k, v in remat_a_step.items()}
        used = {what: n.get(name, 0) for what, n in tools["launches"].items() if n.get(name)}
        if used:
            entry["tools_launches"] = used
        # the wide design's model paths (wide_lstm_phase): CRN at f32, the
        # Demucs bottleneck
        if name in ("lstm_fwd", "lstm_bwd"):
            entry["wide_launches"] = {f"{tag} {part}": wide[tag][part]["launches"][name]
                                      for tag in ("crn f32", "demucs bottleneck")
                                      for part in ("serve", "train")}

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "stream_launches", "dp_launches",
            "remat_launches_a_step", "tools_launches", "wide_launches", "cases")
    log(json.dumps({"kernels": [{k: e[k] for k in keys if k in e} for e in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
