#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written paged-attention
kernels from the checkout's sources, holds each against its plain PyTorch
version, checks engine parity between the kernel route and the plain route
on the card, then serves gpt3-1.3b (24 layers, bf16, seeded random weights)
through the paged ServingEngine with an fp and an int8 KV pool. Each phase
prints one JSON line; any failure exits non-zero. The line before the last
is the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits 2 and prints no result.
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
KERNEL_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu"
REPLACES = {
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:383",
    "paged_attention_q8": "paddle_tpu/ops/pallas/paged_attention.py:148",
}
# the main path's decode shapes: gpt3-1.3b heads, ServingConfig(max_batch=8,
# prompt_cap=128, max_new_tokens=128, kv_block=16) -> 16-block table rows
# and 8 * 16 + 1 pool blocks
B, H, D, BS, MB, NB = 8, 16, 128, 16, 16, 129
LENS = [0, 1, 7, 16, 100, 200, 255, 256]   # empty, 1, partial, one block, full


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


def sdpa_call(torch, q, pools, tables, lens, q8):
    """The yardstick: one scaled_dot_product_attention call over the
    table gathered into a contiguous [B, H, MB*bs, D] buffer (int8 pools
    dequantized into q's dtype first). Only the call itself is timed."""
    import torch.nn.functional as F
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
    k = k.permute(0, 2, 1, 3).contiguous()
    v = v.permute(0, 2, 1, 3).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()
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


# ------------------------------------------- phase 3: engine parity
@contextlib.contextmanager
def plain_route():
    """Test-only, this phase only: the model's decode attention calls the
    plain PyTorch versions on the card instead of the kernels. It swaps
    the names gpt.py imported; nothing in the package offers this."""
    import paddle_tpu_torch.models.gpt as G
    from paddle_tpu_torch.ops import attention as A
    saved = G.paged_attention, G.paged_attention_q8
    G.paged_attention = A.paged_attention_reference
    G.paged_attention_q8 = A.paged_attention_reference_q8
    try:
        yield
    finally:
        G.paged_attention, G.paged_attention_q8 = saved


def serve(torch, model, cfg_kw, prompts):
    from paddle_tpu_torch import ServingConfig, ServingEngine
    eng = ServingEngine(model, ServingConfig(**cfg_kw))
    reqs = [eng.submit(p) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    check(all(r.status == "done" for r in reqs),
          f"requests not done: {[r.status for r in reqs]}")
    return [r.tokens for r in reqs]


def phase_engine_parity(torch, device, card):
    import numpy as np
    from paddle_tpu_torch import GPTForCausalLM, gpt_config, \
        synthetic_traffic
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    cfg = gpt_config("gpt3-1.3b", num_layers=2)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=1)
    prompts = [t["prompt"] for t in synthetic_traffic(
        8, prompt_cap=128, vocab_size=cfg.vocab_size, rate=1e9, seed=5,
        length_dist="longtail")]
    out = {"phase": "engine_parity", "card": card,
           "model": cfg_line(cfg, "float32"), "cache": {}}
    for cache_dtype in (None, "int8"):
        kw = dict(max_batch=8, prompt_cap=128, max_new_tokens=32,
                  decode_chunk=8, paged=True, cache_dtype=cache_dtype)
        K.reset_launch_counts()
        kern = serve(torch, model, kw, prompts)
        launches = dict(K.LAUNCHES)
        K.reset_launch_counts()
        with plain_route():
            plain = serve(torch, model, kw, prompts)
        check(sum(K.LAUNCHES.values()) == 0,
              "plain route launched a kernel")
        name = "paged_attention_q8" if cache_dtype else "paged_attention"
        check(launches[name] > 0, f"kernel route never launched {name}")
        diverged = []
        for i, (a, b) in enumerate(zip(kern, plain)):
            if np.array_equal(a, b):
                continue
            j = int(np.nonzero(a != b)[0][0])
            seq = np.concatenate([prompts[i], a[:j]])[None]
            with torch.no_grad():
                logits = model(torch.from_numpy(seq).to(device))[0, -1]
            margin = abs(float(logits[int(a[j])] - logits[int(b[j])]))
            diverged.append({"request": i, "position": j,
                             "argmax_margin": margin})
            check(margin < 1e-3, f"{name}: greedy chains diverge at "
                  f"request {i} token {j} with margin {margin}")
        out["cache"][str(cache_dtype)] = {
            "requests": len(prompts), "tokens_each": 32,
            "equal_chains": len(prompts) - len(diverged),
            "diverged": diverged, "kernel_launches": launches}
    del model
    torch.cuda.empty_cache()
    out["ok"] = True
    emit(out)


def cfg_line(cfg, dtype):
    return {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "vocab": cfg.vocab_size, "dtype": dtype}


# -------------------------------------------- phase 4: the main path
def phase_serving(torch, device, card):
    """gpt3-1.3b bf16 through the paged engine, bench_decode_paged's
    configuration: 24 longtail requests, queue kept below max_batch."""
    from paddle_tpu_torch import (GPTForCausalLM, ServingConfig,
                                  ServingEngine, ServingMetrics, gpt_config,
                                  synthetic_traffic)
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    cfg = gpt_config("gpt3-1.3b")
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    traffic = synthetic_traffic(24, prompt_cap=128,
                                vocab_size=cfg.vocab_size, rate=1e9, seed=3,
                                length_dist="longtail")
    launches = {}
    runs = {}
    for cache_dtype in (None, "int8"):
        eng = ServingEngine(model, ServingConfig(
            max_batch=8, prompt_cap=128, max_new_tokens=128,
            decode_chunk=32, paged=True, cache_dtype=cache_dtype))
        for item in traffic[:2]:          # warm cuBLAS and the allocator
            eng.submit(item["prompt"], max_new_tokens=33)
        eng.drain()
        eng.metrics = ServingMetrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = []
        for item in traffic:
            reqs.append(eng.submit(item["prompt"]))
            while eng.queue_depth >= 8:
                eng.step()
        while eng.busy:
            eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        name = "paged_attention_q8" if cache_dtype else "paged_attention"
        check(counts[name] > 0, f"main path never launched {name}")
        check(all(r.status == "done" for r in reqs),
              f"not all done: {[r.status for r in reqs]}")
        check(all(r.tokens.shape == (128,) for r in reqs),
              "a request did not produce 128 tokens")
        check(all(0 <= int(r.tokens.min()) and int(r.tokens.max())
                  < cfg.vocab_size for r in reqs), "token id out of range")
        s = eng.summary()
        steps = s["batches_total"]
        runs[str(cache_dtype)] = {
            "requests": len(reqs), "tokens_out": s["tokens_out_total"],
            "seconds": dt, "tokens_per_s": s["tokens_out_total"] / dt,
            "ttft_p50_s": s["ttft_seconds"]["p50"],
            "ttft_p99_s": s["ttft_seconds"]["p99"],
            "tpot_p50_s": s["tpot_seconds"]["p50"],
            "e2e_p50_s": s["e2e_seconds"]["p50"],
            "engine_steps": steps,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches": counts,
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
    return launches


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
    lib = K.build()
    K.load_library()
    log = (K.BUILD_DIR / "nvcc.log").read_text() if \
        (K.BUILD_DIR / "nvcc.log").exists() else ""
    emit({"phase": "build", "ok": True, "card": card,
          "seconds": time.perf_counter() - t0, "library": lib.name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:16],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kern = phase_kernels(torch, device, card)
    phase_engine_parity(torch, device, card)
    launches = phase_serving(torch, device, card)

    rows = []
    for name in ("paged_attention", "paged_attention_q8"):
        r = kern[name]
        rows.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches.get(name, 0),
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
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
