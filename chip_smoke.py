#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written paged-attention
kernels from the checkout's sources (one nvcc per source, in parallel),
holds each against its plain PyTorch version (phase 2), checks engine
parity between the kernel route and the plain route on the card, for the
plain paged engine and for the prefix-cache + chunked-prefill +
speculative engine (phase 3), serves gpt3-1.3b (24 layers, bf16, seeded
random weights) through the paged ServingEngine with an fp and an int8 KV
pool (phase 4), then through the prefix-cache, speculative-decode and
chunked-prefill paths (phase 5). Each phase prints one JSON line; any
failure exits non-zero. The line before the last is the card's name and
power limit from nvidia-smi; the last line is {"ok": true, "device":
{...}} with the number of devices the smoke used. Without a CUDA device,
or without the package beside it, it exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TENSOR_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
#                                  (NVIDIA data sheet)
CSRC = "paddle_tpu_torch/ops/cuda/csrc/"
KERNEL_SOURCE = {
    "paged_attention": CSRC + "paged_attention.cu",
    "paged_attention_q8": CSRC + "paged_attention.cu",
    "paged_prefix_attention": CSRC + "paged_prefix_attention.cu",
    "paged_prefix_attention_q8": CSRC + "paged_prefix_attention.cu",
}
REPLACES = {
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:383",
    "paged_attention_q8": "paddle_tpu/ops/pallas/paged_attention.py:148",
    "paged_prefix_attention": "paddle_tpu/ops/pallas/paged_attention.py:306",
    "paged_prefix_attention_q8":
        "paddle_tpu/ops/pallas/paged_attention.py:344",
}
# the main path's decode shapes: gpt3-1.3b heads, ServingConfig(max_batch=8,
# prompt_cap=128, max_new_tokens=128, kv_block=16) -> 16-block table rows
# and 8 * 16 + 1 pool blocks
B, H, D, BS, MB, NB = 8, 16, 128, 16, 16, 129
LENS = [0, 1, 7, 16, 100, 200, 255, 256]   # empty, 1, partial, one block, full
# multi-token windows: decode (1), a spec_k=8 verify window (9), a
# prefill_chunk=32 window (32) and a prompt_cap suffix prefill (128)
WINDOWS = (1, 9, 32, 128)
# the window whose time the kernels line reports: the shape each kernel
# launches most often in phase 5 (spec verify for #3, the int8 suffix
# prefill for #4)
LINE_WINDOW = {"paged_prefix_attention": 9, "paged_prefix_attention_q8": 128}


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing
def timer(torch, device):
    """Median device time (ms) of fn over n calls, each from a cold L2:
    a 256 MiB write precedes every timed call (the decode step streams
    the weights and 23 other layers' caches between two calls)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device=device)

    def run(fn, n=50):
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(n):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)

    return run


# ------------------------------------------------- phase 2 inputs
def kernel_inputs(torch, device, dtype, q8):
    """Pools holding each row's lens[b] positions in blocks scattered
    through the pool; table entries past ceil(lens/bs) are trash block 0."""
    from paddle_tpu_torch.ops.attention import quantize_kv
    g = torch.Generator(device=device).manual_seed(11)
    perm = torch.randperm(NB - 1, generator=g, device=device) + 1
    tables = perm.view(B, MB).to(torch.int32)
    lens = torch.tensor(LENS, dtype=torch.int32, device=device)
    used = (torch.arange(MB, device=device)[None] * BS) < lens[:, None]
    tables = torch.where(used, tables, torch.zeros_like(tables)).contiguous()
    q = torch.randn(B, 1, H, D, generator=g, device=device).to(dtype)
    k = torch.randn(NB, BS, H, D, generator=g, device=device)
    v = torch.randn(NB, BS, H, D, generator=g, device=device)
    if q8:
        kc, ks = quantize_kv(k)
        vc, vs = quantize_kv(v)
        return q, (kc.contiguous(), ks.contiguous(), vc.contiguous(),
                   vs.contiguous()), tables, lens
    return q, (k.to(dtype), v.to(dtype)), tables, lens


def bound(q, pools, lens, q8):
    """Least time for the work these inputs need: the KV rows of live
    positions (plus scales for int8), q, out, tables and lens, each moved
    once, against 4 f32 flops per cached element read on the CUDA cores."""
    n = int(lens.sum())
    kv_item = 1 if q8 else pools[0].element_size()
    kv_bytes = 2 * n * H * D * kv_item + (2 * n * H * 4 if q8 else 0)
    qo_bytes = 2 * q.numel() * q.element_size()
    meta = B * MB * 4 + B * 4
    by_bytes = (kv_bytes + qo_bytes + meta) / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * n * H * D / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def gathered(torch, q, pools, tables, q8):
    """q, K and V as [B, H, *, D] for scaled_dot_product_attention: the
    table gathered into contiguous K and V (int8 pools dequantized into
    q's dtype first)."""
    from paddle_tpu_torch.ops.attention import _paged_gather
    if q8:
        kc, ks, vc, vs = pools
        k = (_paged_gather(kc, tables).float()
             * _paged_gather(ks, tables)[..., None]).to(q.dtype)
        v = (_paged_gather(vc, tables).float()
             * _paged_gather(vs, tables)[..., None]).to(q.dtype)
    else:
        k, v = _paged_gather(pools[0], tables), _paged_gather(pools[1],
                                                              tables)
    return tuple(t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))


def sdpa_call(torch, q, pools, tables, lens, q8):
    """The yardstick: one scaled_dot_product_attention call over the
    gathered table with the decode mask. Only the call itself is timed."""
    import torch.nn.functional as F
    qh, k, v = gathered(torch, q, pools, tables, q8)
    cols = torch.arange(k.shape[2], device=q.device)
    mask = (cols[None] < lens.clamp_min(1)[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_kernels(torch, device, card):
    """Each kernel against its plain version at the main path's decode
    shapes; times of kernel, plain version and the SDPA yardstick."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    run = timer(torch, device)
    cases = [("paged_attention", torch.bfloat16, 2e-2),
             ("paged_attention", torch.float32, 1e-5),
             ("paged_attention_q8", torch.bfloat16, 2e-2),
             ("paged_attention_q8", torch.float32, 1e-5)]
    rows, results = [], {}
    for name, dtype, tol in cases:
        q8 = name.endswith("q8")
        q, pools, tables, lens = kernel_inputs(torch, device, dtype, q8)
        if q8:
            def kern():
                return K.paged_attention_q8_cuda(q, *pools, tables, lens)

            def plain():
                return A.paged_attention_reference_q8(q, *pools, tables,
                                                      lens)
        else:
            def kern():
                return K.paged_attention_cuda(q, *pools, tables, lens)

            def plain():
                return A.paged_attention_reference(q, *pools, tables, lens)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        live = lens > 0
        close = torch.allclose(got.float(), want.float(), atol=tol,
                               rtol=tol)
        zeros = bool((got[~live] == 0).all())
        finite = bool(torch.isfinite(got.float()).all())
        row = {"kernel": name, "dtype": str(dtype).split(".")[-1],
               "tol": tol, "max_abs_err": float(err.max()),
               "allclose": close, "empty_rows_zero": zeros,
               "finite": finite}
        check(close and zeros and finite,
              f"{name} {row['dtype']}: kernel disagrees with its plain "
              f"version: {row}")
        if dtype == torch.bfloat16:      # the main path's working type
            bms, by = bound(q, pools, lens, q8)
            row.update(ms=run(kern), plain_ms=run(plain),
                       library_ms=run(sdpa_call(torch, q, pools, tables,
                                                lens, q8)),
                       bound_ms=bms, bound_by=by)
            results[name] = row
        rows.append(row)
    emit({"phase": "kernels_vs_plain", "ok": True, "card": card,
          "shapes": {"B": B, "H": H, "D": D, "bs": BS, "MB": MB, "NB": NB,
                     "lens": LENS},
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows})
    return results


# --------------------------------------- phase 2: multi-token kernels
def window_starts(s):
    """Per-row window offsets: a dummy slot (0, trash table), a block
    boundary (16), a crossing (15), the bench's system-prompt length (96),
    mid-table offsets, and a row whose frontier passes the table's extent
    (start + S > MB * bs)."""
    return [0, 16, 15, 96, 40, 130, 7, MB * BS - s + 3]


def prefix_inputs(torch, device, dtype, q8, s):
    """Full tables of distinct scattered blocks, except: row 0 is a dummy
    slot (all-trash table) and every other row's entries past the block of
    start + s // 2 are trash block 0, so padding query rows reach trash
    entries inside their frontier. Pools are random everywhere, trash
    block included."""
    from paddle_tpu_torch.ops.attention import quantize_kv
    g = torch.Generator(device=device).manual_seed(12 + s)
    perm = torch.randperm(NB - 1, generator=g, device=device) + 1
    tables = perm.view(B, MB).to(torch.int32)
    start = torch.tensor(window_starts(s), dtype=torch.int32, device=device)
    used = -(-(start.long() + max(1, s // 2)) // BS)
    keep = torch.arange(MB, device=device)[None] < used[:, None]
    keep[0] = False
    keep[-1] = True
    tables = torch.where(keep, tables, torch.zeros_like(tables)).contiguous()
    q = torch.randn(B, s, H, D, generator=g, device=device).to(dtype)
    k = torch.randn(NB, BS, H, D, generator=g, device=device)
    v = torch.randn(NB, BS, H, D, generator=g, device=device)
    if q8:
        kc, ks = quantize_kv(k)
        vc, vs = quantize_kv(v)
        return q, (kc.contiguous(), ks.contiguous(), vc.contiguous(),
                   vs.contiguous()), tables, start
    return q, (k.to(dtype), v.to(dtype)), tables, start


def prefix_bound(torch, q, pools, tables, start, q8):
    """Least time for one window call on these inputs: the distinct pool
    rows up to each batch row's frontier (K and V, plus their scales for
    int8), q, out, tables and start, each moved once, against 4 flops per
    attended (query row, column, head, element) at the bf16 tensor-core
    peak."""
    s = q.shape[1]
    width = MB * BS
    cols = torch.arange(width, device=q.device)
    n_cols = (start.long() + s).clamp(max=width)
    live = cols[None] < n_cols[:, None]
    phys = tables.long()[:, cols // BS] * BS + cols % BS
    n_rows = int(torch.unique(phys[live]).numel())
    kv_item = 1 if q8 else pools[0].element_size()
    kv_bytes = 2 * n_rows * H * D * kv_item + (2 * n_rows * H * 4 if q8
                                               else 0)
    qo_bytes = 2 * q.numel() * q.element_size()
    meta = B * MB * 4 + B * 4
    by_bytes = (kv_bytes + qo_bytes + meta) / HBM_BYTES_PER_S * 1e3
    row = torch.arange(s, device=q.device)
    attended = (start.long()[:, None] + row[None] + 1).clamp(max=width)
    flops = 4 * int(attended.sum()) * H * D
    by_ops = flops / TENSOR_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def prefix_sdpa_call(torch, q, pools, tables, start, q8):
    """The yardstick for #3/#4: one scaled_dot_product_attention call over
    the gathered table with `paged_prefix_mask` as the attention mask.
    Only the call itself is timed."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import paged_prefix_mask
    qh, k, v = gathered(torch, q, pools, tables, q8)
    mask = paged_prefix_mask(q.shape[1], k.shape[2], start)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_prefix_kernels(torch, device, card):
    """Kernels #3 and #4 against their plain versions (f32 scores, the
    kernels' function) over every window size and dtype, every query row
    compared; times, bound and the SDPA
    yardstick in bf16; and the S = 1, start = lens - 1 window against the
    decode kernel #1 in f32."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    run = timer(torch, device)
    rows, results = [], {}
    for name in ("paged_prefix_attention", "paged_prefix_attention_q8"):
        q8 = name.endswith("q8")
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            for s in WINDOWS:
                q, pools, tables, start = prefix_inputs(torch, device, dtype,
                                                        q8, s)
                if q8:
                    def kern():
                        return K.paged_prefix_attention_q8_cuda(
                            q, *pools, tables, start)

                    def plain():
                        return A.paged_prefix_attention_reference_q8(
                            q, *pools, tables, start)
                else:
                    def kern():
                        return K.paged_prefix_attention_cuda(
                            q, *pools, tables, start)

                    def plain():
                        return A.paged_prefix_attention_reference(
                            q, *pools, tables, start)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                close = torch.allclose(got.float(), want.float(), atol=tol,
                                       rtol=tol)
                finite = bool(torch.isfinite(got.float()).all())
                row = {"kernel": name, "dtype": str(dtype).split(".")[-1],
                       "S": s, "start": window_starts(s), "tol": tol,
                       "max_abs_err": float(err.max()), "allclose": close,
                       "finite": finite}
                check(close and finite,
                      f"{name} {row['dtype']} S={s}: kernel disagrees with "
                      f"its plain version: {row}")
                if dtype == torch.bfloat16:     # the main path's type
                    bms, by = prefix_bound(torch, q, pools, tables, start,
                                           q8)
                    row.update(ms=run(kern), plain_ms=run(plain),
                               library_ms=run(prefix_sdpa_call(
                                   torch, q, pools, tables, start, q8)),
                               bound_ms=bms, bound_by=by)
                    if s == LINE_WINDOW[name]:
                        results[name] = row
                rows.append(row)
    # S = 1 at start = lens - 1 is decode: the same inputs through #1
    decode = []
    for q8 in (False, True):
        q, pools, tables, lens = kernel_inputs(torch, device, torch.float32,
                                               q8)
        lens = lens.clamp_min(1)
        if q8:
            a = K.paged_prefix_attention_q8_cuda(q, *pools, tables, lens - 1)
            b = K.paged_attention_q8_cuda(q, *pools, tables, lens)
        else:
            a = K.paged_prefix_attention_cuda(q, *pools, tables, lens - 1)
            b = K.paged_attention_cuda(q, *pools, tables, lens)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        decode.append({"q8": q8, "max_abs_err": err, "tol": 1e-6})
        check(torch.allclose(a, b, atol=1e-6, rtol=1e-6),
              f"S=1 window at start=lens-1 differs from the decode kernel "
              f"(q8={q8}): max abs err {err}")
    emit({"phase": "prefix_kernels_vs_plain", "ok": True, "card": card,
          "shapes": {"B": B, "H": H, "D": D, "bs": BS, "MB": MB, "NB": NB,
                     "S": list(WINDOWS)},
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "decode_equivalence_f32": decode})
    return results


# ------------------------------------------- phase 3: engine parity
@contextlib.contextmanager
def plain_route():
    """Test-only, this phase only: the model's attention calls the plain
    PyTorch versions on the card instead of the kernels. It swaps the names
    gpt.py imported; nothing in the package offers this."""
    import paddle_tpu_torch.models.gpt as G
    from paddle_tpu_torch.ops import attention as A
    names = ("paged_attention", "paged_attention_q8",
             "paged_prefix_attention", "paged_prefix_attention_q8")
    saved = {n: getattr(G, n) for n in names}
    for n in names:
        setattr(G, n, getattr(A, n + "_reference")
                if not n.endswith("q8")
                else getattr(A, n[:-3] + "_reference_q8"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(G, n, fn)


def serve(torch, model, cfg_kw, prompts, warm=False):
    from paddle_tpu_torch import ServingConfig, ServingEngine
    eng = ServingEngine(model, ServingConfig(**cfg_kw))
    if warm:
        eng.warmup_prefix_cache(model.config.vocab_size, clear=False)
    reqs = [eng.submit(p) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    check(all(r.status == "done" for r in reqs),
          f"requests not done: {[r.status for r in reqs]}")
    return [r.tokens for r in reqs], eng


def divergences(torch, model, device, prompts, chains_a, chains_b):
    """For each request whose chains differ: the first differing position
    and the argmax margin there, from a cache-free forward of the prompt
    plus the common prefix (a margin near 0 is a near-tie)."""
    import numpy as np
    out = []
    for i, (a, b) in enumerate(zip(chains_a, chains_b)):
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0])
        seq = np.concatenate([prompts[i], a[:j]])[None]
        with torch.no_grad():
            logits = model(torch.from_numpy(seq).to(device))[0, -1]
        out.append({"request": i, "position": j,
                    "argmax_margin": abs(float(logits[int(a[j])]
                                               - logits[int(b[j])]))})
    return out


def phase_engine_parity(torch, device, card):
    """Kernel route against plain route through the engine at gpt3-1.3b
    widths, 2 layers, f32: the plain paged engine on longtail traffic, and
    the prefix-cache + chunked-prefill + speculative engine on repeated
    traffic after its warmup (with its cache-off twin on the kernel
    route). Chains must be equal, or the argmax margin at the first
    divergence below 1e-3."""
    from paddle_tpu_torch import GPTForCausalLM, gpt_config, \
        repeated_traffic, synthetic_traffic
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    cfg = gpt_config("gpt3-1.3b", num_layers=2)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=1)
    out = {"phase": "engine_parity", "card": card,
           "model": cfg_line(cfg, "float32"), "cache": {}, "prefix_spec": {}}
    legs = [("cache", [t["prompt"] for t in synthetic_traffic(
        8, prompt_cap=128, vocab_size=cfg.vocab_size, rate=1e9, seed=5,
        length_dist="longtail")], {}, False),
        # served twice over: requests queued behind the first eight
        # admit on their chains (zero prefill) and draft from them
        ("prefix_spec", [t["prompt"] for t in repeated_traffic(
            8, n_prompts=2, prompt_len=128, vocab_size=cfg.vocab_size,
            rate=1e9, seed=5)] * 2,
         dict(kv_block=16, prefix_cache=True, spec_decode=True, spec_k=4,
              prefill_chunk=32), True)]
    for leg, prompts, extra, warm in legs:
        for cache_dtype in (None, "int8"):
            kw = dict(max_batch=8, prompt_cap=128, max_new_tokens=32,
                      decode_chunk=8, paged=True, cache_dtype=cache_dtype,
                      **extra)
            K.reset_launch_counts()
            kern, eng = serve(torch, model, kw, prompts, warm)
            launches = dict(K.LAUNCHES)
            K.reset_launch_counts()
            with plain_route():
                plain, _ = serve(torch, model, kw, prompts, warm)
            check(sum(K.LAUNCHES.values()) == 0,
                  "plain route launched a kernel")
            q8 = "_q8" if cache_dtype else ""
            names = ["paged_attention" + q8]
            if warm:
                names.append("paged_prefix_attention" + q8)
            for name in names:
                check(launches[name] > 0,
                      f"kernel route never launched {name}")
            diverged = divergences(torch, model, device, prompts, kern,
                                   plain)
            for d in diverged:
                check(d["argmax_margin"] < 1e-3,
                      f"{leg} {cache_dtype}: greedy chains diverge: {d}")
            res = {"requests": len(prompts), "tokens_each": 32,
                   "equal_chains": len(prompts) - len(diverged),
                   "diverged": diverged, "kernel_launches": launches}
            if warm:
                c = eng.metrics.counters
                check(c["spec_windows"] > 0 and c["prefix_hit"] > 0,
                      f"{leg} {cache_dtype}: no verify window or no "
                      f"prefix hit: {c}")
                res.update(spec_windows=c["spec_windows"],
                           spec_accepted=c["spec_accepted"],
                           spec_proposed=c["spec_proposed"],
                           prefix_hit=c["prefix_hit"],
                           prefill_tokens_saved=c["prefill_tokens_saved"])
                # the cache-off twin on the kernel route: fp32 #1 and #3
                # sum in different orders, so near-ties may flip
                twin, _ = serve(torch, model, {
                    k: v for k, v in kw.items()
                    if k not in ("prefix_cache", "spec_decode", "spec_k",
                                 "prefill_chunk")}, prompts)
                tdiv = divergences(torch, model, device, prompts, kern,
                                   twin)
                res["cache_off_twin"] = {
                    "equal_chains": len(prompts) - len(tdiv),
                    "diverged": tdiv}
            out[leg][str(cache_dtype)] = res
    del model
    torch.cuda.empty_cache()
    out["ok"] = True
    emit(out)


def cfg_line(cfg, dtype):
    return {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "vocab": cfg.vocab_size, "dtype": dtype}


# -------------------------------------------- phase 4: the main path
def run_traffic(torch, eng, prompts, *, expect=(), want=128):
    """The measured run: launch counts and peak memory reset just before
    it, every prompt submitted with the queue kept below max_batch, the
    engine stepped until idle. Checks every request finished `done` with
    `want` tokens in range and every kernel in `expect` launched. Returns
    (requests, seconds, launches, peak bytes)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    vocab = eng.model.config.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p))
        while eng.queue_depth >= eng.config.max_batch:
            eng.step()
    while eng.busy:
        eng.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    for name in expect:
        check(counts[name] > 0, f"the run never launched {name}")
    check(all(r.status == "done" for r in reqs),
          f"not all done: {[r.status for r in reqs]}")
    check(all(r.tokens.shape == (want,) for r in reqs),
          f"a request did not produce {want} tokens")
    check(all(0 <= int(r.tokens.min()) and int(r.tokens.max()) < vocab
              for r in reqs), "token id out of range")
    return reqs, dt, counts, torch.cuda.max_memory_allocated()


def add_launches(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def latency_line(s, dt):
    return {"tokens_out": s["tokens_out_total"], "seconds": dt,
            "tokens_per_s": s["tokens_out_total"] / dt,
            "ttft_p50_s": s["ttft_seconds"]["p50"],
            "ttft_p99_s": s["ttft_seconds"]["p99"],
            "tpot_p50_s": s["tpot_seconds"]["p50"],
            "engine_steps": s["batches_total"]}


def phase_serving(torch, model, card, launches):
    """gpt3-1.3b bf16 through the paged engine, bench_decode_paged's
    configuration: 24 longtail requests, queue kept below max_batch."""
    from paddle_tpu_torch import (ServingConfig, ServingEngine,
                                  ServingMetrics, synthetic_traffic)
    cfg = model.config
    traffic = synthetic_traffic(24, prompt_cap=128,
                                vocab_size=cfg.vocab_size, rate=1e9, seed=3,
                                length_dist="longtail")
    runs = {}
    for cache_dtype in (None, "int8"):
        eng = ServingEngine(model, ServingConfig(
            max_batch=8, prompt_cap=128, max_new_tokens=128,
            decode_chunk=32, paged=True, cache_dtype=cache_dtype))
        for item in traffic[:2]:          # warm cuBLAS and the allocator
            eng.submit(item["prompt"], max_new_tokens=33)
        eng.drain()
        eng.metrics = ServingMetrics()
        name = "paged_attention_q8" if cache_dtype else "paged_attention"
        reqs, dt, counts, peak = run_traffic(
            torch, eng, [t["prompt"] for t in traffic], expect=[name])
        add_launches(launches, counts)
        runs[str(cache_dtype)] = {
            "requests": len(reqs), **latency_line(eng.summary(), dt),
            "e2e_p50_s": eng.summary()["e2e_seconds"]["p50"],
            "peak_mem_bytes": peak, "kernel_launches": counts,
            "attention_launches_per_decode_step": cfg.num_layers,
            "decode_steps": counts[name] // cfg.num_layers,
            "first_tokens": [int(t) for t in reqs[0].tokens[:8]]}
    emit({"phase": "serving_gpt3_1.3b", "ok": True, "card": card,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {"max_batch": 8, "prompt_cap": 128,
                     "max_new_tokens": 128, "decode_chunk": 32,
                     "paged": True, "kv_block": 16, "requests": 24,
                     "traffic": "synthetic_traffic longtail seed=3"},
          "runs": runs})
    prof = profile_decode(torch, model, traffic)
    emit({"phase": "profile_decode_chunk", "ok": True, "card": card,
          **prof})


def profile_decode(torch, model, traffic):
    """Device busy share and the largest kernels over one engine step of
    the main path (8 admissions plus one 32-step decode chunk)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import ServingConfig, ServingEngine
    eng = ServingEngine(model, ServingConfig(
        max_batch=8, prompt_cap=128, max_new_tokens=128, decode_chunk=32,
        paged=True))
    for item in traffic[:8]:
        eng.submit(item["prompt"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    # kernel records only: a CPU op's device time repeats its kernels'
    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, t, _ in events)
    top = sorted(events, key=lambda x: -x[1])[:8]
    eng.drain()
    return {"wall_s": wall,
            "device_busy_s": busy_us / 1e6 if busy_us else None,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
            "top_device_ops": [{"op": k, "device_ms": t / 1e3, "count": c}
                               for k, t, c in top]}


# ------------------------- phase 5: prefix, spec and chunked at width
def phase_prefix_spec(torch, model, card, launches):
    """gpt3-1.3b bf16 through the three slice-2 paths at the repo's own
    bench configurations (bench_decode_paged_prefix, bench_decode_spec)
    and phase 4's with prefill_chunk=32. Requests are cut (24 and 32),
    widths are not."""
    import numpy as np
    from paddle_tpu_torch import (ServingConfig, ServingEngine,
                                  ServingMetrics, repeated_traffic,
                                  shared_prefix_traffic, synthetic_traffic)
    cfg = model.config
    vocab = cfg.vocab_size
    base = dict(max_batch=8, prompt_cap=128, max_new_tokens=128,
                decode_chunk=32, paged=True, kv_block=16)
    out = {"phase": "prefix_spec_chunked_gpt3_1.3b", "card": card,
           "model": cfg_line(cfg, "bfloat16")}

    # -- prefix_gpt3_1.3b: 4 system prompts of 96 tokens, random suffixes
    shared = shared_prefix_traffic(24, n_prefixes=4, prefix_len=96,
                                   prompt_cap=128, vocab_size=vocab,
                                   rate=1e9, seed=3)
    runs = {}
    for leg, prefix, cache_dtype, expect in (
            ("off", False, None, ["paged_attention"]),
            ("on", True, None, ["paged_prefix_attention",
                                "paged_attention"]),
            ("on_int8", True, "int8", ["paged_prefix_attention_q8",
                                       "paged_attention_q8"])):
        eng = ServingEngine(model, ServingConfig(
            **base, cache_dtype=cache_dtype, prefix_cache=prefix,
            kv_blocks=8 * 16 + 1 + (24 * 8 if prefix else 0)))
        if prefix:
            eng.warmup_prefix_cache(vocab)
        else:
            eng.submit(np.random.RandomState(1).randint(1, vocab, (128,)))
            eng.drain()
        eng.metrics = ServingMetrics()
        reqs, dt, counts, peak = run_traffic(
            torch, eng, [t["prompt"] for t in shared], expect=expect)
        add_launches(launches, counts)
        s = eng.summary()
        hits, misses = s["prefix_hit_total"], s["prefix_miss_total"]
        runs[leg] = {"requests": len(reqs), **latency_line(s, dt),
                     "hit_rate": hits / max(hits + misses, 1),
                     "prefill_tokens_saved": s["prefill_tokens_saved_total"],
                     "peak_mem_bytes": peak, "kernel_launches": counts}
    out["prefix"] = {"config": {**base, "requests": 24,
                                "traffic": "shared_prefix_traffic 4x96 "
                                           "seed=3"}, "runs": runs}

    # -- spec_gpt3_1.3b: 4 prompts repeated verbatim, trie drafts, k=8
    repeat = [t["prompt"] for t in repeated_traffic(
        32, n_prompts=4, prompt_len=128, vocab_size=vocab, rate=1e9,
        seed=3)]
    kv_blocks = 8 * (-(-(128 + 128 - 1) // 16)) \
        + 4 * (-(-(128 + 128) // 16)) + 16
    runs, chains = {}, {}
    for leg, spec in (("off", False), ("on", True)):
        eng = ServingEngine(model, ServingConfig(
            **base, kv_blocks=kv_blocks, prefix_cache=True,
            spec_decode=spec, spec_k=8))
        eng.warmup_prefix_cache(vocab)
        eng.metrics = ServingMetrics()
        expect = ["paged_prefix_attention"] if spec else ["paged_attention"]
        reqs, dt, counts, peak = run_traffic(torch, eng, repeat,
                                             expect=expect)
        add_launches(launches, counts)
        s = eng.summary()
        c = eng.metrics.counters
        acc = eng.metrics.hists["spec_accept_len"]
        chains[leg] = [r.tokens for r in reqs]
        runs[leg] = {"requests": len(reqs), **latency_line(s, dt),
                     "peak_mem_bytes": peak, "kernel_launches": counts,
                     "spec_windows": c["spec_windows"],
                     "accept_rate": c["spec_accepted"] / c["spec_proposed"]
                     if c["spec_proposed"] else None,
                     "accept_len_p50": acc.percentile(0.5)
                     if acc.count else None,
                     "drafts_trie": c["spec_drafts_trie"]}
    out["spec"] = {
        "config": {**base, "kv_blocks": kv_blocks, "prefix_cache": True,
                   "spec_k": 8, "requests": 32,
                   "traffic": "repeated_traffic 4x128 seed=3"},
        "runs": runs,
        # bf16 #1 and #3 differ at near-ties, so this is reported only
        "equal_chains_off_vs_on": sum(
            bool(np.array_equal(a, b))
            for a, b in zip(chains["off"], chains["on"]))}

    # -- chunked_gpt3_1.3b: phase 4's traffic with prefill_chunk=32
    traffic = synthetic_traffic(24, prompt_cap=128, vocab_size=vocab,
                                rate=1e9, seed=3, length_dist="longtail")
    eng = ServingEngine(model, ServingConfig(**base, prefill_chunk=32))
    for item in traffic[:2]:
        eng.submit(item["prompt"], max_new_tokens=33)
    eng.drain()
    eng.metrics = ServingMetrics()
    reqs, dt, counts, peak = run_traffic(
        torch, eng, [t["prompt"] for t in traffic],
        expect=["paged_prefix_attention", "paged_attention"])
    add_launches(launches, counts)
    out["chunked"] = {"config": {**base, "prefill_chunk": 32,
                                 "requests": 24,
                                 "traffic": "synthetic_traffic longtail "
                                            "seed=3"},
                      "run": {"requests": len(reqs),
                              **latency_line(eng.summary(), dt),
                              "peak_mem_bytes": peak,
                              "kernel_launches": counts}}
    out["ok"] = True
    emit(out)


def main() -> int:
    if not (REPO / "paddle_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: paddle_tpu_torch/ not found beside this "
              "script; run it from a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

    from paddle_tpu_torch.ops.cuda import paged_attention as K
    t0 = time.perf_counter()
    libs = K.build()
    for name in libs:
        K.load_library(name)
    log = (K.BUILD_DIR / "nvcc.log").read_text() if \
        (K.BUILD_DIR / "nvcc.log").exists() else ""
    emit({"phase": "build", "ok": True, "card": card,
          "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs.values()],
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kern = phase_kernels(torch, device, card)
    kern.update(phase_prefix_kernels(torch, device, card))
    phase_engine_parity(torch, device, card)
    from paddle_tpu_torch import GPTForCausalLM, gpt_config
    model = GPTForCausalLM(gpt_config("gpt3-1.3b"), device=device,
                           dtype=torch.bfloat16, seed=0)
    launches = {}
    phase_serving(torch, model, card, launches)
    phase_prefix_spec(torch, model, card, launches)

    rows = []
    for name in ("paged_attention", "paged_attention_q8",
                 "paged_prefix_attention", "paged_prefix_attention_q8"):
        r = kern[name]
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the full-width paths")
        rows.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCE[name],
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    check(not any(m == "jax" or m.startswith(("jax.", "paddle_tpu."))
                  or m == "paddle_tpu" for m in sys.modules),
          "JAX or the JAX package was imported")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card_line(), flush=True)
    # the smoke runs on exactly one device, cuda:0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
