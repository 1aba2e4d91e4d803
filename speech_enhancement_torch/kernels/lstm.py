"""The LSTM recurrence over pre-projected inputs: CUDA wrappers and plain versions.

Counterpart of speech_enhancement_tpu/ops/pallas/lstm.py (``fused_lstm``,
``_lstm_fwd_call``, ``_lstm_bwd_call``), with the same contract:

* ``x_proj`` [T, B, 4H] time-major, gate order i, f, g, o (``x @ w_ih +
  bias``); ``w_hh`` [H, 4H]; ``h0``, ``c0`` [B, H]; all in one i/o dtype
  (float32 or bfloat16);
* gate math and both carries in f32; the step's product takes h rounded to
  the i/o dtype (as stored in ``h_seq``) and accumulates in f32;
* ``h_seq``, ``c_seq`` and ``gates`` are stored in the i/o dtype, and the
  backward reads them so: in bf16 its gradients see the rounded gates and
  c, as the JAX kernel's do.

``lstm_fwd`` launches ``csrc/lstm_fwd.cu`` for CUDA tensors (one launch for
all T steps, counted in ``lstm_fwd.launches``) and runs
:func:`fused_lstm_plain` for CPU tensors; ``lstm_bwd`` does the same with
``csrc/lstm_bwd.cu`` and :func:`lstm_bwd_plain`. Each kernel has four
designs, which the C code picks from the shapes by plan: a ring path for
bf16 with 16-byte rows, a split-f32 path on tensor cores for f32 with
16-byte rows whose plan fits (``csrc/lstm.cuh``, namespace ``tc``), the
first design for the rest where its slice fits, and the wide design
(namespace ``wide``: part of the slice resident, the rest streamed each
step) for the widths no other design holds; :func:`fwd_ring_plan`,
:func:`bwd_ring_plan`, :func:`f32_plan`, :func:`first_plan_bytes` and
:func:`wide_plan` mirror the C plans, :func:`f32_design` the f32 choice
between the split-f32 and first designs and :func:`lstm_design` the whole
choice, and :func:`lstm_fwd_design` / :func:`lstm_bwd_design` ask the
built library for it. Any other device raises, and there is no fallback
from a kernel to its plain version: a width that needs more than 16 units a
block (H > 2112 on 132 SMs) raises. The kernel sources say what bounds them
and how the weights stay resident.

:func:`fused_lstm` is the autograd Function :class:`FusedLSTM` around them,
whose backward folds ``d_h_last`` into ``d_h_seq``, runs ``lstm_bwd`` with
``dh_T = 0`` and ``dc_T = d_c_last`` and computes ``dw_hh = h_prevᵀ
dgates`` with one ``torch.matmul`` (XLA in the JAX package).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from speech_enhancement_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _visit(steps: int, reverse: bool):
    return range(steps - 1, -1, -1) if reverse else range(steps)


def fused_lstm_plain(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor, reverse: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in PyTorch: (h_seq, c_seq, gates)."""
    dtype = x_proj.dtype
    steps, batch, g4 = x_proj.shape
    w = w_hh.to(dtype).float()
    h, c = h0.to(dtype), c0.to(dtype).float()
    h_seq = x_proj.new_empty((steps, batch, g4 // 4))
    c_seq = torch.empty_like(h_seq)
    gates = torch.empty_like(x_proj)
    for t in _visit(steps, reverse):
        lin = x_proj[t].float() + torch.matmul(h.float(), w)
        li, lf, lg, lo = lin.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(li), torch.sigmoid(lf), torch.tanh(lg), torch.sigmoid(lo)
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(dtype)
        h_seq[t], c_seq[t] = h, c.to(dtype)
        gates[t] = torch.cat([i, f, g, o], dim=-1).to(dtype)
    return h_seq, c_seq, gates


def lstm_bwd_plain(gates: torch.Tensor, c_seq: torch.Tensor, c_prev: torch.Tensor,
                   dout: torch.Tensor, w_hh: torch.Tensor, dh_last: torch.Tensor,
                   dc_last: torch.Tensor, reverse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in PyTorch: (dgates [T, B, 4H] in the
    i/o dtype, dh0, dc0 [B, H] f32), walking the forward's visit order back."""
    dtype = dout.dtype
    steps = gates.shape[0]
    w_t = w_hh.to(dtype).float().t()
    dh, dc = dh_last.float(), dc_last.float()
    dgates = torch.empty_like(gates)
    for t in _visit(steps, not reverse):
        i, f, g, o = gates[t].float().chunk(4, dim=-1)
        tc = torch.tanh(c_seq[t].float())
        dh = dh + dout[t].float()
        d_o = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        di, df, dg = dc * g, dc * c_prev[t].float(), dc * i
        dgt = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                         d_o * o * (1.0 - o)], dim=-1).to(dtype)
        dgates[t] = dgt
        dh = torch.matmul(dgt.float(), w_t)
        dc = dc * f
    return dgates, dh, dc


# -- CUDA -------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "lstm_fwd": ("lstm_fwd", [_I] + [_P] * 8 + [_I] * 4 + [_P]),
    "lstm_bwd": ("lstm_bwd", [_I] + [_P] * 9 + [_I] * 4 + [_P]),
    "lstm_fwd_plan": ("lstm_fwd", [_I] * 4 + [_P]),
    "lstm_bwd_plan": ("lstm_bwd", [_I] * 4 + [_P]),
}
_PLAN_INTS = 20  # the plan entries' out[]
_DESIGNS = {3: "wide", 2: "f32", 1: "ring", 0: "first"}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


# csrc/lstm_fwd.cu, namespace ring
_FWD_RING_STAGES, _FWD_RING_SPAD, _FWD_RING_MAX_KC = 3, 8, 256


def fwd_ring_plan(units: int, hidden: int, batch: int, smem_limit: int):
    """``ring::make_plan`` of ``csrc/lstm_fwd.cu``, line for line: the bf16
    forward's ring plan, or None where no ring fits beside the slice (the
    wide design then takes the width). Change both together."""
    mt = 4 if units > 8 else 2
    hp = _align16(hidden)
    p = {"units": units, "mt": mt, "rows": 4 * units, "hp": hp, "pitch": hp + _FWD_RING_SPAD}
    p["ring_offset"] = _align16(p["rows"] * p["pitch"] * 2)
    nt = (batch + 7) // 8
    best = None
    for w in range(3 if mt == 4 else 6, 0, -1):
        wn = 8 if nt >= 8 else nt
        splits = 1 if nt >= 8 else 8 // nt
        if splits > 1 and w > 1:
            continue
        nb = wn * w * 8
        chunks = (nt * 8 + nb - 1) // nb
        part = (splits - 1) * mt * 16 * nb * 4
        room = smem_limit - p["ring_offset"] - part
        if room <= 0:
            continue
        fit = room // _FWD_RING_STAGES // (nb * 2) - _FWD_RING_SPAD
        if fit < 16:
            continue
        kc = 16
        while 2 * kc <= fit and 2 * kc <= _FWD_RING_MAX_KC and kc < hp:
            kc *= 2
        if best is not None and chunks * w >= best["chunks"] * best["ntw"]:
            continue
        best = {"ntw": w, "wn": wn, "splits": splits, "nb": nb, "chunks": chunks, "kc": kc}
    if best is None:
        return None
    p.update(best)
    p["spitch"] = p["kc"] + _FWD_RING_SPAD
    p["kr"] = (hp + p["kc"] - 1) // p["kc"]
    p["part_offset"] = p["ring_offset"] + _FWD_RING_STAGES * p["nb"] * p["spitch"] * 2
    p["smem_bytes"] = p["part_offset"] + (p["splits"] - 1) * mt * 16 * p["nb"] * 4
    return p


def first_plan_bytes(elem_bytes: int, units: int, rows: int, k: int, batch: int) -> int:
    """The shared memory of the first design's plan (``lstm::make_plan`` of
    ``csrc/lstm.cuh``, line for line): the slice of ``rows`` x ``k``, a
    staged chunk and the f32 partials. Change both together."""
    nb = min((batch + 7) // 8 * 8, 64)
    kc = max(4096 // nb // 64 * 64, 64)
    kc = min(kc, (k + 63) // 64 * 64)
    pitch = (k + kc - 1) // kc * kc + 8
    mt = (rows + 15) // 16
    tiles = mt * (nb // 8)
    splits = min(8 // tiles, kc // 16) if elem_bytes == 2 and tiles < 8 else 1
    out_offset = _align16(rows * pitch * elem_bytes) + _align16(nb * (kc + 8) * elem_bytes)
    return out_offset + splits * mt * 16 * nb * 4


# csrc/lstm.cuh, namespace wide
_WIDE_MAX_S = 4
_WIDE_FIELDS = ("units", "mt", "rows", "k", "kstep", "wn", "wk", "ntw", "nb", "chunks", "kc",
                "kr", "res_rounds", "pitch", "spitch", "stage_offset", "slot_bytes",
                "part_offset", "smem_bytes")


def wide_plan(elem_bytes: int, units: int, mt: int, k: int, batch: int, smem_limit: int):
    """``wide::make_plan`` of ``csrc/lstm.cuh``, line for line: the wide
    design's plan for ``units`` hidden units a block, ``mt`` m16 row tiles
    (4 forward, 1 backward) and a reduction of ``k``, or None where two stage
    slots and the partials alone exceed ``smem_limit``. Change both
    together."""
    if units <= 0 or units > 16 or k <= 0 or batch <= 0:
        return None
    pad = 16 // elem_bytes
    p = {"units": units, "mt": mt, "rows": 4 * units if mt == 4 else units, "k": k,
         "kstep": 8 if elem_bytes == 4 else 16}
    nt = (batch + 7) // 8
    wn = 8
    while wn > nt:
        wn //= 2
    p["wn"], p["wk"] = wn, 8 // wn
    p["ntw"] = min(-(-nt // wn), 3 if mt == 4 else 4)
    p["nb"] = wn * p["ntw"] * 8
    p["chunks"] = -(-batch // p["nb"])
    part = (p["wk"] - 1) * mt * 16 * p["nb"] * 4
    s = _WIDE_MAX_S
    while s > 1 and (2 * (p["rows"] + p["nb"]) * (p["kstep"] * p["wk"] * s + pad) * elem_bytes
                     + part > smem_limit // 2):
        s //= 2
    p["kc"] = p["kstep"] * p["wk"] * s
    p["kr"] = -(-k // p["kc"])
    p["spitch"] = p["kc"] + pad
    p["slot_bytes"] = (p["rows"] + p["nb"]) * p["spitch"] * elem_bytes
    room = smem_limit - 2 * p["slot_bytes"] - part
    if room < 0:
        return None
    p["res_rounds"] = min(max((room // (p["rows"] * elem_bytes) - pad) // p["kc"], 0), p["kr"])
    p["pitch"] = p["res_rounds"] * p["kc"] + pad
    p["stage_offset"] = p["rows"] * p["pitch"] * elem_bytes if p["res_rounds"] else 0
    p["part_offset"] = p["stage_offset"] + 2 * p["slot_bytes"]
    p["smem_bytes"] = p["part_offset"] + part
    return {key: p[key] for key in _WIDE_FIELDS}

# csrc/lstm_bwd.cu, namespace ring
_RING_KCS, _RING_MIN_STAGES, _RING_MAX_STAGES, _RING_MAX_MW = (64, 32, 16), 3, 8, 4
_RING_PART_PITCH, _RING_ROUND_K, _RING_CHUNK_K = 24, 32, 256
_RING_FIELDS = ("units", "nt", "kc", "kr", "pitch", "stages", "wm", "wk", "mw", "nb", "chunks",
                "rpw", "region", "ring_offset", "ppt", "smem_bytes")


def bwd_ring_plan(units: int, hidden: int, batch: int, smem_limit: int):
    """``ring::make_plan`` of ``csrc/lstm_bwd.cu``, line for line: the bf16
    backward's ring plan for ``units`` hidden units a block, or None where
    the kernel takes the first design (no ring fits beside the slice, or
    more than 16 x 256 (b, u) pairs a block). Change both together."""
    if units <= 0 or units > 16:
        return None
    pairs = batch * units
    ppt = 1 if pairs <= 256 else 4 if pairs <= 4 * 256 else 16 if pairs <= 16 * 256 else 0
    if ppt == 0:
        return None
    k = 4 * hidden
    best, best_cost, best_flight = None, 0, 0
    for kc in _RING_KCS:
        kr = -(-k // kc)
        pitch = kr * kc + 8
        ring_offset = -(-units * pitch * 2 // 16) * 16
        region_max = (smem_limit - ring_offset) // 8 // 16 * 16
        wm = 1
        while wm <= 8:
            wk = 8 // wm
            for mw in range(1, _RING_MAX_MW + 1):
                slab = mw * 16 * kc * 2
                part = mw * 16 * _RING_PART_PITCH * 4
                stages = min(region_max // slab, _RING_MAX_STAGES)
                if stages < _RING_MIN_STAGES:
                    continue
                region = max(stages * slab, part)
                if region > region_max:
                    continue
                nb = wm * mw * 16
                chunks = -(-batch // nb)
                rpw = -(-kr // wk)
                cost = chunks * (mw * rpw * (kc + _RING_ROUND_K) + _RING_CHUNK_K)
                flight = (stages - 1) * slab
                if best_cost > 0 and (cost > best_cost
                                      or (cost == best_cost and flight <= best_flight)):
                    continue
                best_cost, best_flight = cost, flight
                best = {"units": units, "nt": 2 if units > 8 else 1, "kc": kc, "kr": kr,
                        "pitch": pitch, "stages": stages, "wm": wm, "wk": wk, "mw": mw,
                        "nb": nb, "chunks": chunks, "rpw": rpw, "slab_bytes": slab,
                        "region": region, "ring_offset": ring_offset, "ppt": ppt,
                        "smem_bytes": ring_offset + 8 * region}
            wm *= 2
    return best


# csrc/lstm.cuh, namespace tc (the split-f32 designs)
_TC_KC, _TC_SP, _TC_MIN_STAGES, _TC_MAX_STAGES = 32, 36, 3, 8
_TC_ROUND_K, _TC_CHUNK_K = 8, 64
_TC_FIELDS = ("units", "nt", "cols", "k", "kr", "stages", "wm", "wk", "mw", "nb", "chunks",
              "rpw", "pitch", "slab_bytes", "region", "ring_offset", "ppt", "smem_bytes")


def f32_plan(units: int, nt: int, cols: int, k: int, batch: int, smem_limit: int):
    """``tc::make_plan`` of ``csrc/lstm.cuh``, line for line: the split-f32
    plan of ``units`` hidden units a block with ``nt`` n8 column tiles of
    which the slice stores ``cols`` columns, a reduction of ``k``, or None
    where the kernel takes the first design. Change both together."""
    if units <= 0 or cols > 8 or not 1 <= nt <= 4:
        return None
    pairs = batch * units
    ppt = 1 if pairs <= 256 else 4 if pairs <= 4 * 256 else 16 if pairs <= 16 * 256 else 0
    if ppt == 0:
        return None
    kr = -(-k // _TC_KC)
    ring_offset = kr * (_TC_KC // 8) * nt * cols * 64
    if ring_offset >= smem_limit:
        return None
    region_max = (smem_limit - ring_offset) // 8 // 16 * 16
    pitch = 16 * (nt // 2) + 8
    best, best_cost, best_flight = None, 0, 0
    wm = 1
    while wm <= 8:
        wk = 8 // wm
        for mw in range(1, (4 if nt <= 2 else 2) + 1):
            slab = mw * 16 * _TC_SP * 4
            part = mw * 16 * pitch * 4
            stages = min(region_max // slab, _TC_MAX_STAGES)
            if stages < _TC_MIN_STAGES:
                continue
            region = max(stages * slab, part)
            if region > region_max:
                continue
            nb = wm * mw * 16
            chunks = -(-batch // nb)
            rpw = -(-kr // wk)
            cost = chunks * (mw * rpw * (_TC_KC + _TC_ROUND_K) + _TC_CHUNK_K)
            flight = (stages - 1) * slab
            if best_cost > 0 and (cost > best_cost
                                  or (cost == best_cost and flight <= best_flight)):
                continue
            best_cost, best_flight = cost, flight
            best = {"units": units, "nt": nt, "cols": cols, "k": k, "kr": kr, "stages": stages,
                    "wm": wm, "wk": wk, "mw": mw, "nb": nb, "chunks": chunks, "rpw": rpw,
                    "pitch": pitch, "slab_bytes": slab, "region": region,
                    "ring_offset": ring_offset, "ppt": ppt,
                    "smem_bytes": ring_offset + 8 * region}
        wm *= 2
    return best


def f32_design(kernel: str, hidden: int, batch: int, sms: int, smem_limit: int,
               aligned: bool = True):
    """The f32 choice of ``csrc/lstm_fwd.cu`` (``kernel`` "fwd") or
    ``lstm_bwd.cu`` ("bwd") on a card of ``sms`` SMs and ``smem_limit``
    bytes a block between the split-f32 and the first design, as their
    ``choose`` makes it: ("f32", plan), ("first", None), or None where the
    grid does not fit (more than 16 units a block); :func:`lstm_design`
    sends a "first" whose plan exceeds ``smem_limit`` to the wide design.
    The forward's split-f32 design wants 16-byte rows of h_prev (H % 4 == 0)
    and, with ``aligned``, h0, h_seq and w_hhᵀ at 16-byte addresses; the
    backward's wants dgates and w_hh there (its rows of 4H floats are)."""
    units = -(-hidden // sms)
    if units > 16:
        return None
    if kernel == "fwd":
        plan = (f32_plan(units, (units + 1) // 2, 8, hidden, batch, smem_limit)
                if aligned and hidden % 4 == 0 else None)
    else:
        plan = f32_plan(units, 1, units, 4 * hidden, batch, smem_limit) if aligned else None
    return ("f32", plan) if plan is not None else ("first", None)


def lstm_design(kernel: str, dtype: torch.dtype, hidden: int, batch: int, sms: int,
                smem_limit: int, aligned: bool = True):
    """The whole choice of ``csrc/lstm_fwd.cu`` (``kernel`` "fwd") or
    ``lstm_bwd.cu`` ("bwd") on a card of ``sms`` SMs and ``smem_limit``
    bytes a block, as their ``choose`` makes it: ("ring", plan), ("f32",
    plan), ("first", None), ("wide", plan), or None where the grid does not
    fit (more than 16 units a block). The wide design takes exactly the
    shapes the others refuse: a bf16 forward whose ring does not fit beside
    its slice, and every shape that would fall to a first design whose plan
    exceeds ``smem_limit``. ``aligned`` as in :func:`f32_design`."""
    units = -(-hidden // sms)
    if units > 16:
        return None
    elem_bytes = 2 if dtype == torch.bfloat16 else 4
    k = hidden if kernel == "fwd" else 4 * hidden
    rows16 = aligned and k % (16 // elem_bytes) == 0
    if elem_bytes == 4:
        got = f32_design(kernel, hidden, batch, sms, smem_limit, aligned)
        if got[0] == "f32":
            return got
        refused = False
    elif kernel == "fwd":
        plan = fwd_ring_plan(units, hidden, batch, smem_limit) if rows16 else None
        if plan is not None:
            return "ring", plan
        refused = rows16  # no ring beside the slice
    else:
        plan = bwd_ring_plan(units, hidden, batch, smem_limit) if rows16 else None
        if plan is not None:
            return "ring", plan
        refused = False
    rows = 4 * units if kernel == "fwd" else units
    if not refused and first_plan_bytes(elem_bytes, units, rows, k, batch) <= smem_limit:
        return "first", None
    plan = wide_plan(elem_bytes, units, 4 if kernel == "fwd" else 1, k, batch, smem_limit)
    return None if plan is None else ("wide", plan)


def _design(name: str, dtype: torch.dtype, hidden: int, batch: int, aligned: bool):
    out = (ctypes.c_int * _PLAN_INTS)()
    code = _entry(f"{name}_plan")(int(dtype == torch.bfloat16), hidden, batch, int(aligned),
                                  ctypes.addressof(out))
    _build.check(_build.library(name), code, f"{name}_plan")
    if out[0] < 0:
        raise RuntimeError(f"{name}: H {hidden} needs more than 16 units a block (cooperative "
                           "grid does not fit)")
    design = _DESIGNS[out[0]]
    if design == "first" or (design == "ring" and name == "lstm_fwd"):
        return design, None
    fields = {"f32": _TC_FIELDS, "ring": _RING_FIELDS, "wide": _WIDE_FIELDS}[design]
    return design, dict(zip(fields, out[1:]))


def lstm_fwd_design(dtype: torch.dtype, hidden: int, batch: int, aligned: bool = True):
    """("wide", plan), ("f32", plan), ("ring", None) or ("first", None): the
    design ``csrc/lstm_fwd.cu`` takes on the current card for these shapes
    (``aligned``: h0, h_seq and w_hhᵀ at 16-byte addresses), as its
    ``lstm_fwd_plan`` entry reports; raises where the grid does not fit.
    Needs a card."""
    return _design("lstm_fwd", dtype, hidden, batch, aligned)


def lstm_bwd_design(dtype: torch.dtype, hidden: int, batch: int, aligned: bool = True):
    """("wide", plan), ("f32", plan), ("ring", plan) or ("first", None): the
    design ``csrc/lstm_bwd.cu`` takes on the current card for these shapes
    (``aligned``: dgates and w_hh at 16-byte addresses), as its
    ``lstm_bwd_plan`` entry reports; raises for a width whose grid does not
    fit. Needs a card."""
    return _design("lstm_bwd", dtype, hidden, batch, aligned)


@functools.cache
def _entry(name: str):
    library, argtypes = _ENTRIES[name]
    fn = getattr(_build.library(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(what: str, tensors) -> bool:
    """True for CUDA tensors of one device and one supported dtype (checked);
    False for CPU tensors; raises otherwise."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: tensors on {sorted({str(t.device) for t in tensors})}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {device}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    return True


def _launch(name: str, args: list, like: torch.Tensor) -> None:
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        code = _entry(name)(*args, stream)
    _build.check(_build.library(_ENTRIES[name][0]), code, f"{name} launch")


def _barrier(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(2, dtype=torch.int32, device=like.device)


def _check_fwd(x_proj, w_hh, h0, c0) -> None:
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4 or x_proj.shape[0] == 0:
        raise ValueError(f"lstm_fwd: want x_proj [T > 0, B, 4H], got {tuple(x_proj.shape)}")
    steps, batch, g4 = x_proj.shape
    hidden = g4 // 4
    if w_hh.shape != (hidden, g4) or h0.shape != (batch, hidden) or c0.shape != (batch, hidden):
        raise ValueError(f"lstm_fwd: w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}, c0 "
                         f"{tuple(c0.shape)} for x_proj {tuple(x_proj.shape)}")


def lstm_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
             reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h_seq, c_seq, gates) of the recurrence, all in x_proj's dtype.

    A CUDA tensor launches ``csrc/lstm_fwd.cu`` once for all T steps
    (counted in ``lstm_fwd.launches``, and the reversed ones also in
    ``lstm_fwd.reverse_launches``); a CPU tensor runs
    :func:`fused_lstm_plain`. Not differentiable: use :func:`fused_lstm`.
    """
    _check_fwd(x_proj, w_hh, h0, c0)
    if not _on_cuda("lstm_fwd", [x_proj, w_hh, h0, c0]):
        return fused_lstm_plain(x_proj, w_hh, h0, c0, reverse)
    steps, batch, g4 = x_proj.shape
    x_proj, h0 = x_proj.contiguous(), h0.contiguous()
    w_t = w_hh.t().contiguous()  # [4H, H]: the kernel's rows are gate columns
    c = c0.float().contiguous().clone()
    h_seq = x_proj.new_empty((steps, batch, g4 // 4))
    c_seq = torch.empty_like(h_seq)
    gates = torch.empty_like(x_proj)
    bar = _barrier(x_proj)
    _launch("lstm_fwd", [int(x_proj.dtype == torch.bfloat16), x_proj.data_ptr(), w_t.data_ptr(),
                         h0.data_ptr(), c.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
                         gates.data_ptr(), bar.data_ptr(), steps, batch, g4 // 4,
                         int(reverse)], x_proj)
    lstm_fwd.launches += 1
    lstm_fwd.reverse_launches += int(reverse)
    return h_seq, c_seq, gates


def lstm_bwd(gates: torch.Tensor, c_seq: torch.Tensor, c_prev: torch.Tensor,
             dout: torch.Tensor, w_hh: torch.Tensor, dh_last: torch.Tensor,
             dc_last: torch.Tensor, reverse: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dgates [T, B, 4H] in the i/o dtype, dh0, dc0 [B, H] f32).

    gates [T, B, 4H], c_seq, c_prev, dout [T, B, H] and w_hh [H, 4H] in one
    i/o dtype; dh_last, dc_last [B, H] (any float dtype, read as f32). A
    CUDA tensor launches ``csrc/lstm_bwd.cu`` once for all T steps (counted
    in ``lstm_bwd.launches``, and the reversed ones also in
    ``lstm_bwd.reverse_launches``); a CPU tensor runs :func:`lstm_bwd_plain`.
    """
    if gates.dim() != 3 or gates.shape[-1] % 4 or gates.shape[0] == 0:
        raise ValueError(f"lstm_bwd: want gates [T > 0, B, 4H], got {tuple(gates.shape)}")
    steps, batch, g4 = gates.shape
    hidden = g4 // 4
    seq = (steps, batch, hidden)
    if (c_seq.shape != seq or c_prev.shape != seq or dout.shape != seq
            or w_hh.shape != (hidden, g4) or dh_last.shape != (batch, hidden)
            or dc_last.shape != (batch, hidden)):
        shapes = [tuple(t.shape) for t in (c_seq, c_prev, dout, w_hh, dh_last, dc_last)]
        raise ValueError(f"lstm_bwd: shapes {shapes} for gates {tuple(gates.shape)}")
    if not _on_cuda("lstm_bwd", [gates, c_seq, c_prev, dout, w_hh]):
        return lstm_bwd_plain(gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last, reverse)
    if dh_last.device != gates.device or dc_last.device != gates.device:
        raise ValueError("lstm_bwd: dh_last and dc_last must be on the sequences' device")
    gates, c_seq, c_prev, dout = (t.contiguous() for t in (gates, c_seq, c_prev, dout))
    w = w_hh.contiguous()  # [H, 4H]: the kernel's rows are hidden units of dh
    dh = dh_last.float().contiguous().clone()
    dc = dc_last.float().contiguous().clone()
    dgates = torch.empty_like(gates)
    bar = _barrier(gates)
    _launch("lstm_bwd", [int(gates.dtype == torch.bfloat16), gates.data_ptr(), c_seq.data_ptr(),
                         c_prev.data_ptr(), dout.data_ptr(), w.data_ptr(), dh.data_ptr(),
                         dc.data_ptr(), dgates.data_ptr(), bar.data_ptr(), steps,
                         batch, hidden, int(reverse)], gates)
    lstm_bwd.launches += 1
    lstm_bwd.reverse_launches += int(reverse)
    return dgates, dh, dc


lstm_fwd.launches = 0
lstm_fwd.reverse_launches = 0
lstm_bwd.launches = 0
lstm_bwd.reverse_launches = 0


def shift_prev(seq: torch.Tensor, first: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Each step's "previous" carry along time (``_shift_prev``): t-1 (t = 0:
    ``first``) forward, t+1 (t = T-1: ``first``) reversed."""
    if reverse:
        return torch.cat([seq[1:], first[None]], dim=0)
    return torch.cat([first[None], seq[:-1]], dim=0)


class FusedLSTM(torch.autograd.Function):
    """(h_seq, h_last, c_last) of the recurrence with exact gradients for
    (x_proj, w_hh, h0, c0), as the JAX custom VJP of ``fused_lstm``."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, reverse):
        h_seq, c_seq, gates = lstm_fwd(x_proj, w_hh, h0, c0, reverse)
        ctx.save_for_backward(w_hh, h0, c0, h_seq, c_seq, gates)
        ctx.reverse = reverse
        edge = 0 if reverse else -1
        return h_seq, h_seq[edge].clone(), c_seq[edge].clone()

    @staticmethod
    def backward(ctx, d_hseq, d_hlast, d_clast):
        w_hh, h0, c0, h_seq, c_seq, gates = ctx.saved_tensors
        reverse = ctx.reverse
        edge = 0 if reverse else -1
        d_hseq = torch.zeros_like(h_seq) if d_hseq is None else d_hseq.to(h_seq.dtype).clone()
        if d_hlast is not None:  # h_last is h_seq[edge], rounded to the i/o dtype
            d_hseq[edge] = d_hseq[edge] + d_hlast.to(d_hseq.dtype)
        d_clast = torch.zeros_like(c0, dtype=torch.float32) if d_clast is None else d_clast
        c_prev = shift_prev(c_seq, c0.to(c_seq.dtype), reverse)
        dh_last = torch.zeros(c0.shape, dtype=torch.float32, device=c0.device)
        dgates, dh0, dc0 = lstm_bwd(gates, c_seq, c_prev, d_hseq, w_hh, dh_last,
                                    d_clast.float(), reverse)
        h_prev = shift_prev(h_seq, h0.to(h_seq.dtype), reverse)
        hidden = h_seq.shape[-1]
        # f32 accumulation, rounded once to w_hh's dtype (cuBLAS accumulates
        # a bf16 product in f32)
        dw_hh = torch.matmul(h_prev.reshape(-1, hidden).t(), dgates.reshape(-1, 4 * hidden))
        return dgates, dw_hh.to(w_hh.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype), None


def fused_lstm(x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
               reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSTM recurrence over pre-projected inputs: (h_seq [T, B, H] in time
    order, h_last, c_last), where h_last / c_last are h_seq / c_seq at the
    last visited step (t = 0 when ``reverse``), in the i/o dtype.
    Differentiable in all four tensors (:class:`FusedLSTM`)."""
    return FusedLSTM.apply(x_proj, w_hh, h0, c0, reverse)
