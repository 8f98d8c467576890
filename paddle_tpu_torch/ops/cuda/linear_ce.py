"""Bind and launch the hand-written fused linear cross-entropy forward
(kernel #11 of the port, `csrc/linear_ce.cu`, CUDA C++ for sm_90a). The
library is built and loaded by `build.py`.

The wrapper checks device, dtypes, shapes, contiguity and alignment,
raises ValueError on what the kernel does not take (bf16 "vh", the main
path, reads x and w through TMA tensor maps: `check_view`'s rules),
allocates the outputs and the partial-triple scratch, launches on
PyTorch's current stream and raises RuntimeError when the launch reports
an error. It never falls back to another implementation. Each launch adds
one to ``LAUNCHES["linear_ce_fwd"]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import LAUNCHES, load_library, raise_on_error
from .flash_attention import check_view

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUT_CODE = {"hv": 0, "vh": 1}
# (tokens, vocabulary) per tile: bf16 "vh" (the wgmma kernel lce_wg),
# bf16 "hv" (lce_bf16_hv) and f32
WG_TILE = (128, 256)
_TILE = {torch.bfloat16: (64, 128), torch.float32: (64, 64)}


def wg_schedule(t, v, sms):
    """The persistent bf16 "vh" kernel's walk, as `lce_wg` computes it:
    tile = token tile + n_tt * vocabulary tile, CTA c of `grid` taking
    tiles c, c + grid, ...; returns (n_tt, n_vt, grid). Its partial
    triples are one per (token, vocabulary tile): nsplit = n_vt."""
    n_tt, n_vt = -(-t // WG_TILE[0]), -(-v // WG_TILE[1])
    return n_tt, n_vt, min(n_tt * n_vt, sms)


def splits(t, v, dtype, layout, sms):
    """(nsplit, vocabulary tiles per split) of the [3, nsplit, T] partial
    triples. bf16 "vh": one split per 256-wide vocabulary tile (the
    persistent kernel writes each tile's triple). The other forms split
    the vocabulary walk of each token tile over enough CTAs for about four
    of them per SM; split s takes tiles [s * tps, min((s + 1) * tps,
    n_vt))."""
    if dtype == torch.bfloat16 and layout == "vh":
        return wg_schedule(t, v, sms)[1], 1
    bt, bv = _TILE[dtype]
    n_tt, n_vt = -(-t // bt), -(-v // bv)
    want = max(1, min(n_vt, -(-4 * sms // n_tt), 65535))
    tps = -(-n_vt // want)
    return -(-n_vt // tps), tps


def linear_ce_fwd_cuda(x, w, labels, *, w_layout="vh"):
    """x [T, H], w [V, H] ("vh") or [H, V] ("hv") in x's dtype, labels [T]
    integer. Returns (loss [T] f32, lse [T] f32)."""
    if w_layout not in _LAYOUT_CODE:
        raise ValueError(f"w_layout must be 'vh' or 'hv'; got {w_layout!r}")
    if x.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"x [T, H], w 2-D and labels [T] expected; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"x and w must share float32 or bfloat16; got "
                         f"{x.dtype}, {w.dtype}")
    T, H = x.shape
    V, Hw = (w.shape[0], w.shape[1]) if w_layout == "vh" else \
        (w.shape[1], w.shape[0])
    if Hw != H or labels.shape[0] != T:
        raise ValueError(f"x [T={T}, H={H}] does not match w "
                         f"{tuple(w.shape)} ({w_layout!r}) or labels "
                         f"{tuple(labels.shape)}")
    if T < 1 or V < 1 or H < 1 or max(T * H, V * H) >= 2 ** 62:
        raise ValueError(f"bad sizes T={T}, H={H}, V={V}")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA linear cross-entropy kernel needs CUDA "
                         f"tensors; x is on {x.device}")
    for t in (w, labels):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}; found "
                             f"{t.device}")
    x = x.contiguous()
    w = w.contiguous()
    labels = labels.to(torch.int32).contiguous()
    if x.dtype == torch.bfloat16:
        # the kernel stages 16-byte chunks: H, and V of an [H, V] head,
        # in whole chunks of 8 (zero columns change no logit; the padded
        # vocabulary columns are masked by V)
        if H % 8:
            x = F.pad(x, (0, (-H) % 8))
            w = F.pad(w, (0, (-H) % 8) if w_layout == "vh"
                      else (0, 0, 0, (-H) % 8))
            H = x.shape[1]
        if w_layout == "hv" and V % 8:
            w = F.pad(w, (0, (-V) % 8))
    if any(t.data_ptr() % 16 for t in (x, w)):
        x, w = x.clone(), w.clone()     # fresh allocations are aligned
    if x.dtype == torch.bfloat16 and w_layout == "vh":
        check_view(x, "x")
        check_view(w, "w")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit, tps = splits(T, V, x.dtype, w_layout, sms)
    lib = load_library("linear_ce")
    loss = torch.empty(T, dtype=torch.float32, device=x.device)
    lse = torch.empty(T, dtype=torch.float32, device=x.device)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # an [H, V] head padded above: its rows lie w.shape[1] apart
    ldw = w.shape[1] if w_layout == "hv" else H
    rc = lib.pt_linear_ce_partial(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(), T, H,
        V, ldw, _LAYOUT_CODE[w_layout], _DTYPE_CODE[x.dtype], nsplit, tps,
        stream)
    if rc == 0:
        rc = lib.pt_linear_ce_merge(part.data_ptr(), loss.data_ptr(),
                                    lse.data_ptr(), T, nsplit, stream)
        stage = "merge"
    else:
        stage = "tile"
    raise_on_error(lib, rc, f"linear_ce_fwd {stage}",
                   f"; T={T} H={H} V={V} layout={w_layout} dtype={x.dtype} "
                   f"nsplit={nsplit} tiles/split={tps}")
    LAUNCHES["linear_ce_fwd"] += 1
    return loss, lse
