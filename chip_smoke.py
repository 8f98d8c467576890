#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
the checkout's sources (one nvcc per source, in parallel) and reads the
redesigned ones back with cuobjdump: #6's bf16 kernels, #9's
instantiations of them, #11's bf16 "vh" kernel and #5's bf16 "nk" kernel
must contain warpgroup MMAs (HGMMA) and TMA loads (UTMALDG), the bf16
tile kernel of #3 and #4 tensor-core MMAs, #1/#2's partition kernel
16-byte loads, #10's plan-driven kernels be present with their 16-byte
or cp.async loads, #8's kernels with 16-byte loads, and their
instantiations at head dims 64, 80 and 128 (#11's only one; every one of
#5's and #8's; #10's at 32) spill nothing (phase 1). The kernels: the
paged-attention kernels #1-#4, the weight-only int8 GEMM #5, flash
attention #6 (forward, dQ and dK/dV passes), the fused linear
cross-entropy forward #11, the fused short-sequence MHA #9 (forward and
backward), the window-batched fused MHA with bias #10 (forward, and
backward with d(bias)), the fused LayerNorm #8 (forward, backward) and
packed flash attention #7 (#6's kernels on the packed [B, S, nh * 128]
layout, one d(qkv)). It holds each against its plain PyTorch version
(phase 2; #1-#4 also at head dim 80, bitwise repeatable and with a
control that drops each row's last pool block, #6 bitwise
repeatable forward and backward and also at gpt3-2.7b's head dim 80, #11
also at bert-base's MLM head and gpt3-2.7b's, bitwise repeatable, with a
control that drops the head's last 256 vocabulary rows, #9
at bert-base and vit-l16 shapes with dropout, lengths and causal, its kept
sets read back, bf16 bitwise repeatable, #10 at swin-t's four stages and swin-b's last with the
model's own bias, bitwise repeatable, its live-block plan equal to the
plain one, on a bias with scattered live entries, and in f32, #5
bitwise repeatable with its ratio to torch.matmul reported, #8 at gpt3-1.3b's,
gpt3-2.7b's, bert-base's, vit-l16's, a Swin patch merge's and one
32768-wide LayerNorm input for the four affine cases, its backward
bitwise repeatable, #7 at gpt3-1.3b's training shape, equal to #6 on the
same data), checks parity between
the kernel route and the plain route on the card for the paged engine,
the prefix-cache + chunked-prefill + speculative engine (at gpt3-1.3b and
at gpt3-2.7b's head dim 80), static decode, the padded engine, the paged
engine with int8 weights and the model-drafted spec engine (phase 3),
serves gpt3-1.3b (24 layers, bf16, seeded random weights) through the
paged ServingEngine with an fp and an int8 KV pool (phase 4), then through
the prefix-cache, speculative-decode and chunked-prefill paths (phase 5),
then through static decode (bf16, int8 weights, int8 weights + int8 KV),
the padded engine, the paged engine with int8 weights and a spec engine
drafted by gpt3-125m (phase 6), then through the host spill tier and the
serving ops surface (serving_ops_gpt3_1.3b: pool block round trips into
pinned memory, bitwise, fp and int8; phase 5's shared-prefix traffic
through a trie of 8 device blocks spilling into a 64-block host tier,
every rehydrated block bitwise equal to its bytes before the spill,
chains equal to an ample cache's or differing at a near-tie, the
auditor clean and the pool conserved; phase 4's traffic through a
prefix + spec + spill engine under serve_telemetry with an SLO, the
prober, the audits and a flight recorder, every route scraped over
loopback meanwhile and linted, the memory ledger's sum and owners
checked; three probe cycles passing or failing only at a near-tie; a
corruption control that must fail prefix_hit outright and pin a capture
that /profilez serves with #1 or #3 in its KernelView; the graceful
drain; the same traffic without the surface). Phase 7 is training: the kernel route
against the plain route for the loss, every gradient and 5-step AdamW
trajectories at gpt3-1.3b widths cut to 2 layers, for BERT MLM and ViT at
bert-base and vit-l16 widths cut to 2 layers, and for Swin at swin-t's
width cut to depths 2/2/2/2, and for GPT under the opt-ins
PADDLE_TPU_FUSED_LN=1 and PADDLE_TPU_FLASH_PACKED=1 (#8, #7), also with
save_qkv recompute and int8 moments; dist_one_card runs the multi-GPU
slice's paths one card can run: #11's vocab-parallel route at gpt3-1.3b's
head over 2 and 4 in-process vocabulary shards in bf16 and f32 against
whole-vocabulary #11 and the plain version (a control that drops a shard
must fail), and TrainStep on a world-size-1 NCCL mesh {"dp": 1, "mp": 1}
at gpt3-1.3b widths cut to 2 layers, bitwise equal to the same steps
without a mesh; then bench_gpt's configuration at
full width (gpt3-1.3b, bf16, B=3, S=2048, AdamW with bf16 moments), the
same under both opt-ins, the same again with every telemetry option of
TrainStep against none (observability_train_gpt3_1.3b: a Profiler
window whose KernelView counts #6 and #11 as the launch counters do and
whose DeviceView matches torch.profiler's key_averages() within 2%, the
numerics stats tree, a poisoned parameter named, skipped bitwise,
dumped and replayed, the flight recorder's pinned capture, the goodput
report conserved, the memory ledger's exact owners, the cost a step),
_bench_gpt27's (gpt3-2.7b, bf16, B=6, S=1024,
save_qkv recompute, int8 moments), bench_bert's
(bert-base, bf16, B=32, S=512, dropout), bench_vit's (vit-l16 at 224^2,
bf16, B=64) and bench_swin's (swin-t at 224^2, bf16, B=32), each timed
and profiled. Then ResNet-50 (no kernel of ours; cuDNN's convolutions
and batch norms): resnet_parity holds ResNet-50 at 1000 classes on 64^2
images, B=16, the card against the CPU and channels-last against NCHW on
the card (logits, loss, every gradient, the running statistics, eval
logits; f32 gradients against the CPU's f64 on the f32 run's own ReLU
branches), and every optimizer and clip for 5 steps card against CPU over
ResNet-50's parameter kinds (f32 and bf16; DGCMomentum also over 2^24 + 1
elements; an f32 case outside its limits runs again on both sides, and
passes only if the CPU's run did not reproduce itself while the card's
did and agrees with the CPU's second run); train_resnet50_nhwc and
train_resnet50_nchw run bench_resnet50's configuration (resnet50, bf16,
224^2, B=64, Momentum(lr=0.1)) under FLAGS_conv_channels_last on and
off, each timed and profiled, with the optimizer update's launches
counted. Then GPT with MoE blocks, ERNIE and the incubate layers (no
kernel of their own): moe_parity holds a gpt3-350m-wide GPT cut to 4
layers (2 MoE blocks of 8 experts, top-2 gshard, capacity factor 1.0,
B=2, S=1024), kernel route against plain route, for the loss with the
router aux loss and every gradient in f32 and bf16 (the plain route
replaying the kernel route's expert routing), 5-step AdamW
trajectories, the index dispatch against the one-hot route with their
drop rates, and 32-token greedy chains through the paged engine;
ernie_parity holds ERNIE MLM at ernie-3.0-medium's width cut to 2 layers
(f32 and bf16) and the incubate FusedTransformerEncoderLayer and
FusedMultiTransformer at bert-base width on #9 against the plain route,
with the stack's static-cache decode (fp and int8) against its growing
cache; train_gpt_moe and train_gpt_moe_dense run bench_moe's
configuration (gpt3-350m bf16, 8 experts every 2nd layer, B=8, S=1024,
AdamW with bf16 moments) and its dense twin, with the active-parameter
MFU, the routing overhead and the drop rate; train_ernie-3.0-medium runs
ERNIE with bench_bert's settings; each timed and profiled. Every profiled
table comes from the port's trace analysis of the capture's chrome trace
(`profiler.trace_analysis`), held against torch.profiler's own
key_averages() within 2%. Each phase prints one JSON line; any failure exits non-zero
(resnet_parity prints its record, then names what failed last). The line
before the last is the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}} with the number of devices
the smoke used. Without a CUDA device, or without the package beside it,
it exits 2 and prints no result.

    python3 chip_smoke.py --parity-repeats N

runs resnet_parity alone N times, each run's record followed by a line
that lists its reruns and failures, and exits 1 if any run failed.

    python3 chip_smoke.py --multi-gpu

is the multi-GPU run (with fewer than 4 CUDA devices it exits 2 and
prints no result). It builds the kernels, then starts 4 ranks with
`distributed.spawn`, one a card, NCCL. Each rank holds TrainStep(mesh=...)
at dp2 x mp2 and at dp1 x mp4 against the single-card step from the same
weights (gpt3-1.3b widths cut to 2 layers, f32, 3 AdamW steps, the clip
active, a loss mask uneven across the dp halves): losses within 1e-5
relative, every gathered parameter within 1e-4 of its tensor's max,
replicated parameters bitwise equal across mp ranks, #6 and #11 (through
its vocab-parallel route) launched on every rank. Then it trains
gpt3-6.7b at dp2 x mp2 (bf16, global B = 8, S = 2048, AdamW with bf16
moments; bench_gpt_dp's DP+TP cell): tokens/s in all and a card, ms a
step, MFU over 989 TFLOP/s a card, peak memory a card, and from one
profiled step on rank 0 the NCCL kernels' device time and share and the
device's idle share. No rank imports JAX. Its last line is the default
run's with the count of devices it used.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import logging
import math
import re
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
    "int8_matmul": CSRC + "int8_matmul.cu",
    "flash_fwd": CSRC + "flash_attention.cu",
    "flash_bwd_dq": CSRC + "flash_attention.cu",
    "flash_bwd_dkv": CSRC + "flash_attention.cu",
    "linear_ce_fwd": CSRC + "linear_ce.cu",
    "fused_mha_fwd": CSRC + "fused_mha.cu",
    "fused_mha_bwd": CSRC + "fused_mha.cu",
    "fused_mha_bias_fwd": CSRC + "fused_mha_bias.cu",
    "fused_mha_bias_bwd": CSRC + "fused_mha_bias.cu",
    "layer_norm_fwd": CSRC + "layer_norm.cu",
    "layer_norm_bwd": CSRC + "layer_norm.cu",
    "flash_packed_fwd": CSRC + "flash_attention.cu",
    "flash_packed_bwd_dq": CSRC + "flash_attention.cu",
    "flash_packed_bwd_dkv": CSRC + "flash_attention.cu",
}
REPLACES = {
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:383",
    "paged_attention_q8": "paddle_tpu/ops/pallas/paged_attention.py:148",
    "paged_prefix_attention": "paddle_tpu/ops/pallas/paged_attention.py:306",
    "paged_prefix_attention_q8":
        "paddle_tpu/ops/pallas/paged_attention.py:344",
    "int8_matmul": "paddle_tpu/ops/pallas/int8_matmul.py:62",
    # flash_attention (def :320): the forward, dQ and dK/dV pallas_calls
    "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:113",
    "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:220",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:238",
    # linear_cross_entropy (def :232): the forward pallas_call
    "linear_ce_fwd": "paddle_tpu/ops/pallas/linear_ce.py:111",
    # fused_mha (def :355): the forward and the backward pallas_calls
    "fused_mha_fwd": "paddle_tpu/ops/pallas/fused_mha.py:249",
    "fused_mha_bwd": "paddle_tpu/ops/pallas/fused_mha.py:295",
    # fused_mha_bias (def :161): the forward and the backward pallas_calls
    "fused_mha_bias_fwd": "paddle_tpu/ops/pallas/fused_mha_bias.py:108",
    "fused_mha_bias_bwd": "paddle_tpu/ops/pallas/fused_mha_bias.py:136",
    # fused_layer_norm (def :207): the forward and the backward pallas_calls
    "layer_norm_fwd": "paddle_tpu/ops/pallas/layer_norm.py:125",
    "layer_norm_bwd": "paddle_tpu/ops/pallas/layer_norm.py:168",
    # flash_attention_packed (def :683): the forward, dQ and dK/dV
    # pallas_calls of the packed layout
    "flash_packed_fwd": "paddle_tpu/ops/pallas/flash_attention.py:472",
    "flash_packed_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:610",
    "flash_packed_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:628",
}
# kernel #6 cases: (name, B, Sq, Sk, H, D, causal, kv_len). The first two
# are the training shapes of gpt3-1.3b (bench_gpt) and gpt3-125m, taken as
# q, k, v views of one fused [B, S, 3, H, D] projection as the model does
FLASH_CASES = [("gpt3-1.3b", 3, 2048, 2048, 16, 128, True, None),
               ("gpt3-125m", 2, 1024, 1024, 12, 64, True, None),
               ("kv_len", 2, 640, 640, 12, 64, False, 600),
               ("cross", 2, 384, 1024, 16, 128, False, None),
               ("gpt3-2.7b", 6, 1024, 1024, 32, 80, True, None)]
# the cases whose bf16 times the phase reports; the first is the line's
FLASH_TIMED = ("gpt3-1.3b", "gpt3-2.7b")
# limits on row_err (per-row error, see there) of out and of dq, dk and dv
# each on its own, and on the max abs error of the f32 lse. bf16 rounds P
# and dS to bf16 before their products and writes bf16 results: the limit
# is 3x the largest reading on an H100 (0.034, out at the gpt3-1.3b
# shape), and the controls below read 1.6 or more. f32 differs in
# summation order only (out 1.6e-5; the gradients came out bitwise equal)
FLASH_TOL = {"bfloat16": (0.1, 0.1, 1e-5), "float32": (1e-4, 1e-4, 1e-5)}
# controls the bf16 limit must reject: the kernel run with its last 64 keys
# masked off (kv_len = Sk - 64), held against the plain version of the
# whole function; causal, the error sits in the last 64 rows only
FLASH_CONTROLS = ("gpt3-1.3b", "cross")
# kernel #11 cases: (name, T, H, V, layout, dtype); the first is the
# gpt3-1.3b bench_gpt LM head (T = 3 x 2048), the second bench_bert's tied
# MLM head (T = 32 x 512, V = 30522: not a multiple of the vocab tile),
# the third _bench_gpt27's (T = 6 x 1024, H = 2560), the others an untied
# head, ragged vocabularies (V % 256 != 0, and V % 8 != 0 in "hv") and
# f32
CE_CASES = [("gpt3-1.3b", 6144, 2048, 50304, "vh", "bfloat16"),
            ("bert-base", 16384, 768, 30522, "vh", "bfloat16"),
            ("gpt3-2.7b", 6144, 2560, 50304, "vh", "bfloat16"),
            ("gpt3-1.3b_hv", 6144, 2048, 50304, "hv", "bfloat16"),
            ("ragged", 512, 256, 1000, "vh", "bfloat16"),
            ("ragged_hv", 512, 256, 1001, "hv", "bfloat16"),
            ("f32", 512, 256, 1000, "vh", "float32"),
            ("f32_hv", 512, 256, 1000, "hv", "float32")]
CE_TIMED = ("gpt3-1.3b", "bert-base", "gpt3-2.7b")  # the first: the line's
# the control the loss limit must reject, at every bf16 "vh" case: the
# kernel run on the head's first V - 256 rows (its last vocabulary tile or
# more dropped), labels unchanged, against the plain version of the whole
# head
CE_CUT = 256
# (max abs loss error, max |kernel - plain| / max |plain| on dx and dW)
CE_TOL = {"bfloat16": (2e-3, 3e-2), "float32": (1e-4, 1e-4)}
# kernel #5 at gpt3-1.3b widths: (K, N) of each projection, layout "nk"
# (the port's [out, in] payloads), at M = a decode step (8), a spec_k=8
# verify window (72), one paged prefill (128) and a static prefill of
# 8 x 128 (1024); the LM head at a decode step and a paged prefill; the
# "kn" layout at the decode qkv shape; a ragged shape
GEMM_WIDTHS = {"qkv": (2048, 6144), "out": (2048, 2048), "up": (2048, 8192),
               "down": (8192, 2048)}
GEMM_CASES = ([(m, name, k, n, "nk") for m in (8, 72, 128, 1024)
               for name, (k, n) in GEMM_WIDTHS.items()]
              + [(m, "lm_head", 2048, 50304, "nk") for m in (8, 128)]
              + [(8, "qkv_kn", 2048, 6144, "kn"), (3, "ragged", 48, 100,
                                                    "nk")])
GEMM_LINE = (8, "qkv")             # the case the kernels line reports
# gpt3-1.3b's row-parallel shards at mp 2 and 4 (K = H / mp for attn.out,
# 4H / mp for mlp.down), decode and prefill widths, f32 y
GEMM_SHARD_CASES = [(m, f"{name}_mp{mp}", k // mp, 2048)
                    for m in (8, 128) for mp in (2, 4)
                    for name, k in (("out", 2048), ("down", 8192))]
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
# the build phase's SASS check of the redesigned kernels, per library:
# (kernel names, instructions every one of them must contain; "A|B" is
# either): #6's bf16 kernels, #9's instantiations of them (r pass
# included) and #11's bf16 "vh" kernel warpgroup MMAs and TMA loads, the
# bf16 tile kernel of #3 (bf16 pools) and #4 (int8 codes) tensor-core MMAs
SASS_CHECKS = {"flash_attention": (("fwd_wg", "dq_wg", "dkv_wg"),
                                   ("HGMMA", "UTMALDG")),
               # #5's bf16 "nk" kernel: warpgroup MMAs fed by TMA
               "int8_matmul": (("i8_wg",), ("HGMMA", "UTMALDG")),
               # #10's plan-driven bf16 kernels: present, the plan pass's
               # 16-byte bias loads, the others' cp.async staging
               "fused_mha_bias": (("mhb_plan", "mhb_fwd", "mhb_dq", "mhb_db",
                                   "mhb_dkv"), ("LDG.E.128|LDGSTS",)),
               "fused_mha": (("fwd_wg", "dq_wg", "dkv_wg"),
                             ("HGMMA", "UTMALDG")),
               "paged_prefix_attention": (("prefix_tc",), ("HMMA|HGMMA",)),
               "linear_ce": (("lce_wg",), ("HGMMA", "UTMALDG")),
               # #1/#2's split-sequence kernel: present, its 16-byte loads
               "paged_attention": (("decode_part",), ("LDG.E.128|LDG.E.64",)),
               # #8's kernels: present, with 16-byte loads
               "layer_norm": (("ln_fwd_rows", "ln_bwd_rows", "ln_fwd_loop",
                               "ln_bwd_loop", "ln_bwd_sum"), ("LDG.E.128",))}
# ... and the instantiations (by their first template argument: #6's and
# #9's head dim bucket, the tile kernel's head dim padded to 16, in both
# pool forms; None: every instantiation) the main paths launch at head
# dims 64, 80 and 128, which must spill 0 bytes
SPILL_FREE = {"fwd_wg": (64, 128), "dq_wg": (64, 128), "dkv_wg": (64, 128),
              "prefix_tc": (64, 80, 128), "lce_wg": None,
              # #1/#2's partition kernel by NV = ceil(D / 32): 4 (D=128)
              # and 3 (D=80), fp and int8 pools, bf16 and f32 q
              "decode_part": (3, 4),
              # #5's bf16 "nk" kernel by its tokens a CTA: every one
              "i8_wg": None,
              # #10's bf16 kernels at swin's head dim 32 (the plan pass
              # has no head dim)
              "mhb_fwd": (32,), "mhb_dq": (32,), "mhb_db": (32,),
              "mhb_dkv": (32,), "mhb_plan": None,
              # #8's kernels, every instantiation: the models' widths reach
              # every "rows" one, and the wide rows the loops
              "ln_fwd_rows": None, "ln_bwd_rows": None, "ln_fwd_loop": None,
              "ln_bwd_loop": None, "ln_bwd_sum": None}


class SmokeFailure(Exception):
    pass


T_START = time.perf_counter()
LOG = REPO / "chiprun_out" / "chip_smoke.jsonl"


def emit(obj):
    """One JSON line; a phase's line also carries the seconds since the
    script started (`at_s`). Each line is also appended to
    chiprun_out/chip_smoke.jsonl in the checkout (a long run's output
    outgrows what a terminal or a chip call's tail keeps)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
    line = json.dumps(obj)
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


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


# ------------------------------------------------------ phase 1: build
def cuobjdump(nvcc):
    """cuobjdump from the CUDA toolkit beside nvcc, else Triton's copy."""
    spec = importlib.util.find_spec("triton")
    triton_dir = Path(spec.origin).parent if spec and spec.origin else \
        Path("<triton, not installed>")
    cands = [Path(nvcc).resolve().parent / "cuobjdump",
             triton_dir / "backends" / "nvidia" / "bin" / "cuobjdump"]
    for c in cands:
        if c.is_file():
            return c
    raise SmokeFailure(f"cuobjdump found neither beside nvcc ({cands[0]}) "
                       f"nor in Triton's package ({cands[1]})")


def sass_by_kernel(tool, lib):
    """{mangled kernel name: its SASS} of a built library."""
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0,
          f"cuobjdump -sass {lib.name} failed: {out.stderr[-2000:]}")
    funcs, cur = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(ln)
    return {k: "\n".join(v) for k, v in funcs.items()}


def spill_bytes(log):
    """{mangled kernel name: bytes of spill stores plus loads}, from the
    ptxas -v lines of the build log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            out[cur] = int(m.group(1)) + int(m.group(2))
            cur = None
    return out


def redesigned(name):
    """A redesigned kernel's tag from its mangled name, else None:
    'kernel<first template argument>' (the tile kernel's pool form after a
    comma: 'prefix_tc<128,bf16>', 'prefix_tc<128,int8>'; #9's
    instantiations of #6's kernels ',mha', its r pass ',mha,r'; #5's
    'i8_wg<tokens a CTA,y dtype>' (a build whose i8_wg has no y type
    parameter: 'i8_wg<tokens a CTA>'); #10's 'mhb_fwd<head dim bucket>' and its
    siblings), or the bare name of #11's kernel and of #10's plan pass,
    which are no templates; #1/#2's partition
    kernel 'decode_part<NV,pool form,q dtype>'; #8's kernels by their
    template arguments ('ln_bwd_rows<1,4,bf16>', 'ln_fwd_loop<f32>') and
    its partials' sum 'ln_bwd_sum'."""
    m = re.search(r"(fwd_wg|dq_wg|dkv_wg|prefix_tc)ILi(\d+)E(?:Li\d+E)*"
                  r"((?:Lb[01]E)*)(?:Li\d+E)*E", name)
    if m:
        flags = re.findall(r"Lb([01])E", m.group(3))
        if m.group(1) == "prefix_tc":
            form = "".join({"0": ",bf16", "1": ",int8"}[f] for f in flags)
        else:
            form = "".join(n for n, f in zip((",mha", ",r"), flags)
                           if f == "1")
        return f"{m.group(1)}<{m.group(2)}{form}>"
    m = re.search(r"decode_partILi(\d+)ELb([01])E(f|13__nv_bfloat16)", name)
    if m:
        return (f"decode_part<{m.group(1)},{('fp', 'int8')[int(m.group(2))]}"
                f",{'f32' if m.group(3) == 'f' else 'bf16'}>")
    m = re.search(r"\di8_wgILi(\d+)E(?:Li\d+E)*(f|13__nv_bfloat16)?E", name)
    if m:
        y = {"f": ",f32", "13__nv_bfloat16": ",bf16", None: ""}[m.group(2)]
        return f"i8_wg<{m.group(1)}{y}>"
    m = re.search(r"\d(mhb_fwd|mhb_dq|mhb_db|mhb_dkv)ILi(\d+)E", name)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    if re.search(r"\dmhb_planE", name):
        return "mhb_plan"
    m = re.search(r"\d(ln_fwd_rows|ln_bwd_rows|ln_fwd_loop|ln_bwd_loop)I"
                  r"((?:Li\d+E)*)(f|13__nv_bfloat16)E", name)
    if m:
        args = re.findall(r"Li(\d+)E", m.group(2)) + [
            "f32" if m.group(3) == "f" else "bf16"]
        return f"{m.group(1)}<{','.join(args)}>"
    if re.search(r"\dln_bwd_sumE", name):
        return "ln_bwd_sum"
    return "lce_wg" if re.search(r"\dlce_wgE", name) else None


def spill_free(tag):
    """Whether SPILL_FREE holds the instantiation `tag` names."""
    kernel, _, args = tag.partition("<")
    dims = SPILL_FREE[kernel]
    return dims is None or int(args.split(",")[0].rstrip(">")) in dims


def phase_build(torch, card):
    """Build every kernel library from the checkout's sources; check the
    redesigned kernels' SASS (SASS_CHECKS) and that the main paths'
    instantiations of them spill nothing (SPILL_FREE); print every
    spill."""
    from paddle_tpu_torch.ops.cuda import build as KB
    t0 = time.perf_counter()
    libs = KB.build()
    for name in libs:
        KB.load_library(name)
    seconds = time.perf_counter() - t0
    log = (KB.BUILD_DIR / "nvcc.log").read_text() if \
        (KB.BUILD_DIR / "nvcc.log").exists() else ""
    tool = cuobjdump(KB._nvcc())
    sass = {}
    for lib, (kernels, instrs) in SASS_CHECKS.items():
        here = set()
        for name, text in sass_by_kernel(tool, libs[lib]).items():
            tag = redesigned(name)
            if tag is None or tag.partition("<")[0] not in kernels:
                continue
            found = {i: any(x in text for x in i.split("|")) for i in instrs}
            sass[tag] = found
            here.add(tag.partition("<")[0])
            missing = [i for i in instrs if not found[i]]
            check(not missing, f"{tag}: no {missing} in its SASS")
        for kernel in kernels:
            check(kernel in here, f"{kernel} is not in {libs[lib].name}")
    all_spills = spill_bytes(log)
    spills = {redesigned(name): n for name, n in all_spills.items()
              if redesigned(name) is not None}
    bad = {t: n for t, n in spills.items() if n and spill_free(t)}
    check(not bad, f"the main paths' instantiations spill: {bad}")
    emit({"phase": "build", "ok": True, "card": card, "seconds": seconds,
          "libraries": [p.name for p in libs.values()],
          "cuobjdump": str(tool), "sass": sass,
          "redesigned_spill_bytes": spills,
          "spilling": {name: n for name, n in all_spills.items() if n},
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln],
          "torch": torch.__version__, "cuda": torch.version.cuda})


# ------------------------------------------------- phase 2 inputs
def kernel_inputs(torch, device, dtype, q8, d=D):
    """Pools holding each row's lens[b] positions in blocks scattered
    through the pool; table entries past ceil(lens/bs) are trash block 0.
    `d`: the head dim (the main path's D, or gpt3-2.7b's 80)."""
    from paddle_tpu_torch.ops.attention import quantize_kv
    g = torch.Generator(device=device).manual_seed(11)
    perm = torch.randperm(NB - 1, generator=g, device=device) + 1
    tables = perm.view(B, MB).to(torch.int32)
    lens = torch.tensor(LENS, dtype=torch.int32, device=device)
    used = (torch.arange(MB, device=device)[None] * BS) < lens[:, None]
    tables = torch.where(used, tables, torch.zeros_like(tables)).contiguous()
    q = torch.randn(B, 1, H, d, generator=g, device=device).to(dtype)
    k = torch.randn(NB, BS, H, d, generator=g, device=device)
    v = torch.randn(NB, BS, H, d, generator=g, device=device)
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
    d = q.shape[-1]
    kv_item = 1 if q8 else pools[0].element_size()
    kv_bytes = 2 * n * H * d * kv_item + (2 * n * H * 4 if q8 else 0)
    qo_bytes = 2 * q.numel() * q.element_size()
    meta = B * MB * 4 + B * 4
    by_bytes = (kv_bytes + qo_bytes + meta) / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * n * H * d / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def gathered(torch, q, pools, tables, q8):
    """q, K and V as [B, H, *, D] for scaled_dot_product_attention: the
    table gathered into contiguous K and V (int8 pools dequantized into
    q's dtype first)."""
    from paddle_tpu_torch.ops.attention import _paged_gather, dequantize_kv
    if q8:
        kc, ks, vc, vs = pools
        k = dequantize_kv(_paged_gather(kc, tables),
                          _paged_gather(ks, tables), q.dtype)
        v = dequantize_kv(_paged_gather(vc, tables),
                          _paged_gather(vs, tables), q.dtype)
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
    shapes, and at gpt3-2.7b's head dim 80 (not a multiple of 32: the
    kernels' masked lanes); times of kernel, plain version and the SDPA
    yardstick in bf16."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    run = timer(torch, device)
    cases = [("paged_attention", torch.bfloat16, 2e-2, D),
             ("paged_attention", torch.float32, 1e-5, D),
             ("paged_attention_q8", torch.bfloat16, 2e-2, D),
             ("paged_attention_q8", torch.float32, 1e-5, D)]
    cases += [(n, dt, tol, 80) for n, dt, tol, _ in cases]
    rows, results = [], {}
    for name, dtype, tol, d in cases:
        q8 = name.endswith("q8")
        q, pools, tables, lens = kernel_inputs(torch, device, dtype, q8, d)
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
        again = kern()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        live = lens > 0
        close = torch.allclose(got.float(), want.float(), atol=tol,
                               rtol=tol)
        zeros = bool((got[~live] == 0).all())
        finite = bool(torch.isfinite(got.float()).all())
        row = {"kernel": name, "dtype": str(dtype).split(".")[-1], "D": d,
               "tol": tol, "max_abs_err": float(err.max()),
               "allclose": close, "empty_rows_zero": zeros,
               "finite": finite,
               "bitwise_repeatable": bool(torch.equal(got, again))}
        check(close and zeros and finite,
              f"{name} {row['dtype']} D={d}: kernel disagrees with its "
              f"plain version: {row}")
        check(row["bitwise_repeatable"],
              f"{name} {row['dtype']} D={d}: two launches differ")
        # tables of 4 blocks (64 positions): one partition a row, so no
        # scratch and no merge launch
        t4, l4 = tables[:, :4].contiguous(), lens.clamp(max=4 * BS)
        g4 = K.paged_attention_q8_cuda(q, *pools, t4, l4) if q8 else \
            K.paged_attention_cuda(q, *pools, t4, l4)
        w4 = A.paged_attention_reference_q8(q, *pools, t4, l4) if q8 else \
            A.paged_attention_reference(q, *pools, t4, l4)
        row["one_partition"] = {
            "max_abs_err": float((g4.float() - w4.float()).abs().max()),
            "allclose": torch.allclose(g4.float(), w4.float(), atol=tol,
                                       rtol=tol),
            "empty_rows_zero": bool((g4[~live] == 0).all())}
        check(row["one_partition"]["allclose"]
              and row["one_partition"]["empty_rows_zero"],
              f"{name} {row['dtype']} D={d}: the one-partition launch "
              f"disagrees with its plain version: {row['one_partition']}")
        if dtype == torch.bfloat16:
            # control: each live row's last pool block dropped (lens cut
            # back to the block before), against the plain version of the
            # whole rows
            cut = torch.where(lens > 0, lens - ((lens - 1) % BS + 1), lens)
            kc = K.paged_attention_q8_cuda(q, *pools, tables, cut) if q8 \
                else K.paged_attention_cuda(q, *pools, tables, cut)
            rejected = not torch.allclose(kc.float(), want.float(),
                                          atol=tol, rtol=tol)
            check(rejected, f"{name} bf16 D={d}: the limit passes a kernel "
                            f"that drops each row's last pool block")
            row["control"] = {
                "what": "kernel with each row's last pool block dropped vs "
                        "plain", "max_abs_err": float(
                            (kc.float() - want.float()).abs().max()),
                "rejected": rejected}
        if dtype == torch.bfloat16:      # the main path's working type
            bms, by = bound(q, pools, lens, q8)
            row.update(ms=run(kern), plain_ms=run(plain),
                       library_ms=run(sdpa_call(torch, q, pools, tables,
                                                lens, q8)),
                       bound_ms=bms, bound_by=by)
            if d == D:
                results[name] = row
        rows.append(row)
    emit({"phase": "kernels_vs_plain", "ok": True, "card": card,
          "shapes": {"B": B, "H": H, "D": [D, 80], "bs": BS, "MB": MB,
                     "NB": NB, "lens": LENS},
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


def prefix_inputs(torch, device, dtype, q8, s, d=D):
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
    q = torch.randn(B, s, H, d, generator=g, device=device).to(dtype)
    k = torch.randn(NB, BS, H, d, generator=g, device=device)
    v = torch.randn(NB, BS, H, d, generator=g, device=device)
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
    s, d = q.shape[1], q.shape[-1]
    width = MB * BS
    cols = torch.arange(width, device=q.device)
    n_cols = (start.long() + s).clamp(max=width)
    live = cols[None] < n_cols[:, None]
    phys = tables.long()[:, cols // BS] * BS + cols % BS
    n_rows = int(torch.unique(phys[live]).numel())
    kv_item = 1 if q8 else pools[0].element_size()
    kv_bytes = 2 * n_rows * H * d * kv_item + (2 * n_rows * H * 4 if q8
                                               else 0)
    qo_bytes = 2 * q.numel() * q.element_size()
    meta = B * MB * 4 + B * 4
    by_bytes = (kv_bytes + qo_bytes + meta) / HBM_BYTES_PER_S * 1e3
    row = torch.arange(s, device=q.device)
    attended = (start.long()[:, None] + row[None] + 1).clamp(max=width)
    flops = 4 * int(attended.sum()) * H * d
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
    compared, at the main path's head dim and at gpt3-2.7b's 80; times,
    bound and the SDPA yardstick in bf16 at every window; in bf16 (the
    tile kernel) both kernels bitwise equal over two launches, and each
    one's control (each row whose start is at least 16 run with start -
    16, so it loses its last pool block of columns, against the plain
    version of the true inputs: the limit must reject it); and the S = 1,
    start = lens - 1 window against the decode kernel #1 in f32."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    run = timer(torch, device)
    rows, results = [], {}
    shapes = [(s, d) for s in WINDOWS for d in (D, 80)]
    for name in ("paged_prefix_attention", "paged_prefix_attention_q8"):
        q8 = name.endswith("q8")
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            for s, d in shapes:
                q, pools, tables, start = prefix_inputs(torch, device, dtype,
                                                        q8, s, d)
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
                       "S": s, "D": d, "start": window_starts(s), "tol": tol,
                       "max_abs_err": float(err.max()), "allclose": close,
                       "finite": finite}
                check(close and finite,
                      f"{name} {row['dtype']} S={s} D={d}: kernel disagrees "
                      f"with its plain version: {row}")
                if dtype == torch.bfloat16:
                    row["bitwise_repeat"] = bool(torch.equal(got, kern()))
                    check(row["bitwise_repeat"],
                          f"{name} S={s} D={d}: two launches differ")
                    cut = torch.where(start >= BS, start - BS, start)
                    ctl = (K.paged_prefix_attention_q8_cuda if q8 else
                           K.paged_prefix_attention_cuda)(q, *pools, tables,
                                                          cut)
                    torch.cuda.synchronize()
                    row["control"] = {
                        "what": f"start lowered by {BS} where >= {BS} (each "
                                f"such row's last pool block dropped) vs "
                                f"plain on the true start",
                        "max_abs_err": float((ctl.float() - want.float())
                                             .abs().max()),
                        "rejected": not torch.allclose(
                            ctl.float(), want.float(), atol=tol, rtol=tol)}
                    check(row["control"]["rejected"],
                          f"{name} S={s} D={d}: the limit passes a kernel "
                          f"that drops each row's last pool block: {row}")
                if dtype == torch.bfloat16:     # the main path's type
                    bms, by = prefix_bound(torch, q, pools, tables, start,
                                           q8)
                    row.update(ms=run(kern), plain_ms=run(plain),
                               library_ms=run(prefix_sdpa_call(
                                   torch, q, pools, tables, start, q8)),
                               bound_ms=bms, bound_by=by)
                    if s == LINE_WINDOW[name] and d == D:
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
          "shapes": {"B": B, "H": H, "D": [D, 80], "bs": BS, "MB": MB,
                     "NB": NB, "S_D": shapes},
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "decode_equivalence_f32": decode})
    return results


# --------------------------------------- phase 2: the int8 GEMM (#5)
def gemm_inputs(torch, device, m, k, n, layout, dtype):
    """x [m, k] at the scale of tests/test_int8_matmul.py (x*0.3, w*0.1),
    w quantized per output channel as the model's payload is."""
    g = torch.Generator(device=device).manual_seed(m * 7 + n)
    x = (torch.randn(m, k, generator=g, device=device) * 0.3).to(dtype)
    w = torch.randn(n, k, generator=g, device=device) * 0.1
    s = (w.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    if layout == "kn":
        q = q.t().contiguous()
    return x, q, s.reshape(-1).contiguous()


def gemm_bound(m, k, n, dtype):
    """x, the int8 weight, the scales and y each moved once, against 2MKN
    operations at the peak for x's type (bf16 tensor cores, f32 CUDA
    cores)."""
    item = 2 if str(dtype).endswith("bfloat16") else 4
    by_bytes = (item * m * k + k * n + 4 * n + item * m * n) \
        / HBM_BYTES_PER_S * 1e3
    peak = TENSOR_FLOPS_PER_S if item == 2 else F32_FLOPS_PER_S
    by_ops = 2 * m * k * n / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# the aims of #5's bf16 "nk" kernel against torch.matmul, by M class: a
# ratio ms / library_ms at or below it meets it. Reported, never gated.
GEMM_AIMS = {8: 0.6, 72: 1.0, 128: 1.0, 1024: 1.2}


def phase_int8_matmul(torch, device, card):
    """Kernel #5 against its plain version at every GEMM shape of the
    slice's paths, bf16 and f32; two launches bitwise equal; times of
    kernel, plain version and the yardstick (one torch.matmul on the
    weight dequantized into x's dtype beforehand, so it reads twice the
    weight bytes); for the bf16 "nk" shapes the launch plan (tokens a CTA,
    cluster size, CTAs) and the ratio to the yardstick beside its aim
    (GEMM_AIMS, reported only)."""
    from paddle_tpu_torch.ops.cuda import int8_matmul as KM
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul_reference
    run = timer(torch, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows, line = [], None
    for m, name, k, n, layout in GEMM_CASES:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            x, q, s = gemm_inputs(torch, device, m, k, n, layout, dtype)

            def kern():
                return KM.int8_matmul_cuda(x, q, s, w_layout=layout)

            def plain():
                return int8_matmul_reference(x, q, s, layout)
            got, got2, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            close = torch.allclose(got.float(), want.float(), atol=tol,
                                   rtol=tol)
            row = {"shape": name, "M": m, "K": k, "N": n, "layout": layout,
                   "dtype": str(dtype).split(".")[-1], "tol": tol,
                   "max_abs_err": err, "allclose": close,
                   "bitwise_repeat": bool(torch.equal(got, got2))}
            check(close and bool(torch.isfinite(got.float()).all()),
                  f"int8_matmul {row}: kernel disagrees with its plain "
                  f"version")
            check(row["bitwise_repeat"], f"int8_matmul {row}: two launches "
                                         f"differ")
            wq = q.float() if layout == "kn" else q.float().t()
            wd = (wq * s).to(dtype)           # dequantized, outside timing
            bms, by = gemm_bound(m, k, n, dtype)
            row.update(ms=run(kern), plain_ms=run(plain),
                       library_ms=run(lambda: torch.matmul(x, wd)),
                       bound_ms=bms, bound_by=by)
            if dtype == torch.bfloat16 and layout == "nk":
                nt, nwg, cs, ctas = KM.wg_plan(m, n, k, sms)
                row["kernel"] = {"name": f"i8_wg<{nt},bf16>", "tokens": nt,
                                 "warpgroups": nwg, "cluster": cs,
                                 "ctas": ctas}
                if m in GEMM_AIMS:
                    ratio = row["ms"] / row["library_ms"]
                    row["vs_library"] = {"ratio": ratio,
                                         "aim": GEMM_AIMS[m],
                                         "meets_aim": ratio <= GEMM_AIMS[m]}
            del wd
            rows.append(row)
            if (m, name) == GEMM_LINE and dtype == torch.bfloat16:
                line = row
    emit({"phase": "int8_matmul_vs_plain", "ok": True, "card": card,
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "aims": "ms / library_ms at or below GEMM_AIMS by M (reported, "
                  "not gated)", "cases": rows})
    return {"int8_matmul": line}


def phase_int8_matmul_shards(torch, device, card):
    """#5's f32-y form at the row-parallel shards of tensor-parallel
    serving (GEMM_SHARD_CASES: gpt3-1.3b's attn.out and mlp.down at mp 2
    and 4, decode and prefill widths): bf16 x, the f32 partial product
    the serving forward all-reduces before its one rounding, against its
    plain version (within 1e-4 of the largest output), two launches
    bitwise equal; times of kernel, plain version and the yardstick (one
    torch.mm with an f32 result on the weight dequantized to bf16
    beforehand, as the fp serving forward's row-parallel GEMM runs), and
    the bound."""
    from paddle_tpu_torch.ops.cuda import int8_matmul as KM
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul_reference
    run = timer(torch, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for m, name, k, n in GEMM_SHARD_CASES:
        x, q, s = gemm_inputs(torch, device, m, k, n, "nk", torch.bfloat16)
        got = KM.int8_matmul_cuda(x, q, s, w_layout="nk",
                                  out_dtype=torch.float32)
        got2 = KM.int8_matmul_cuda(x, q, s, w_layout="nk",
                                   out_dtype=torch.float32)
        want = int8_matmul_reference(x, q, s, "nk", torch.float32)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-4 * float(want.abs().max())
        nt, nwg, cs, ctas = KM.wg_plan(m, n, k, sms)
        bms, by = gemm_bound(m, k, n, torch.bfloat16)
        wd = (q.float().t() * s).to(torch.bfloat16)   # outside timing
        row = {"shape": name, "M": m, "K": k, "N": n, "layout": "nk",
               "dtype": "bfloat16", "out_dtype": "float32",
               "tol": tol, "max_abs_err": err,
               "bitwise_repeat": bool(torch.equal(got, got2)),
               "kernel": {"name": f"i8_wg<{nt},f32>", "tokens": nt,
                          "warpgroups": nwg, "cluster": cs, "ctas": ctas},
               "ms": run(lambda: KM.int8_matmul_cuda(
                   x, q, s, w_layout="nk", out_dtype=torch.float32)),
               "plain_ms": run(lambda: int8_matmul_reference(
                   x, q, s, "nk", torch.float32)),
               "library_ms": run(lambda: torch.mm(
                   x, wd, out_dtype=torch.float32)),
               "bound_ms": bms, "bound_by": by}
        del wd
        check(got.dtype == torch.float32 and err <= tol
              and row["bitwise_repeat"],
              f"int8_matmul f32 y {row}: kernel disagrees with its plain "
              f"version")
        rows.append(row)
    emit({"phase": "int8_matmul_shards_vs_plain", "ok": True, "card": card,
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows})
    return rows


# ------------------------------------------- phase 3: engine parity
@contextlib.contextmanager
def plain_route():
    """Test-only, the parity phases only: the model's attention, int8
    GEMM, flash-attention (plain and packed), fused-MHA (with and without
    bias), fused LayerNorm and fused cross-entropy calls run the plain
    PyTorch versions on the card instead of the kernels. It swaps the
    names gpt.py, ops/int8_matmul.py, ops/attention.py,
    ops/flash_attention.py, ops/fused_mha.py, ops/fused_mha_bias.py,
    ops/layer_norm.py and the fused-loss module look up; nothing in the
    package offers this."""
    import paddle_tpu_torch.incubate.nn.functional as FF
    import paddle_tpu_torch.models.gpt as G
    import paddle_tpu_torch.ops.flash_attention as FA
    import paddle_tpu_torch.ops.fused_mha as FM
    import paddle_tpu_torch.ops.fused_mha_bias as FMB
    import paddle_tpu_torch.ops.int8_matmul as M
    import paddle_tpu_torch.ops.layer_norm as LN
    import paddle_tpu_torch.ops.linear_ce as LC
    from paddle_tpu_torch.ops import attention as A
    names = ("paged_attention", "paged_attention_q8",
             "paged_prefix_attention", "paged_prefix_attention_q8")
    saved = {n: getattr(G, n) for n in names}
    for n in names:
        setattr(G, n, getattr(A, n + "_reference")
                if not n.endswith("q8")
                else getattr(A, n[:-3] + "_reference_q8"))
    mm = M.int8_matmul
    M.int8_matmul = lambda x, q, s, *, w_layout="kn", out_dtype=None, \
        plan_n=None: M.int8_matmul_reference(x, q, s, w_layout, out_dtype)
    fa, ce = FA.flash_attention, FF.linear_cross_entropy
    mha = FM.fused_mha_fwd_cuda, FM.fused_mha_bwd_cuda
    FM.fused_mha_fwd_cuda = lambda qkv, nh, **kw: (
        FM.fused_mha_reference(qkv, nh, **kw), None)
    FM.fused_mha_bwd_cuda = lambda qkv, dout, lse, nh, **kw: \
        FM.fused_mha_bwd_reference(qkv, dout, nh, **kw)
    mhab = FMB.fused_mha_bias_fwd_cuda, FMB.fused_mha_bias_bwd_cuda
    FMB.fused_mha_bias_fwd_cuda = lambda qkv, bias, nh, *, scale=None: (
        FMB.fused_mha_bias_reference(qkv, bias, nh, scale=scale), None, None)
    FMB.fused_mha_bias_bwd_cuda = lambda qkv, bias, dout, ml, plan, nh, *, \
        scale=None: FMB.fused_mha_bias_bwd_reference(qkv, bias, dout, nh,
                                                     scale=scale)
    FA.flash_attention = lambda q, k, v, causal=False, scale=None, \
        kv_len=None: FA.flash_attention_reference(q, k, v, causal, scale,
                                                  kv_len)
    FF.linear_cross_entropy = lambda x, w, labels, *, w_layout="vh", \
        bwd_chunks=None: LC.linear_cross_entropy_reference(x, w, labels,
                                                           w_layout)
    ln = LN.layer_norm_fwd_cuda, LN.layer_norm_bwd_cuda
    LN.layer_norm_fwd_cuda = LN.fused_layer_norm_reference
    LN.layer_norm_bwd_cuda = LN.fused_layer_norm_bwd_reference
    fp = FA.flash_packed_fwd_cuda, FA.flash_packed_bwd_cuda
    FA.flash_packed_fwd_cuda = lambda q, k, v, nh, *, causal, scale, \
        kv_len=None: FA.flash_packed_forward_reference(q, k, v, nh, causal,
                                                       scale, kv_len)
    FA.flash_packed_bwd_cuda = _plain_packed_bwd
    try:
        yield
    finally:
        LN.layer_norm_fwd_cuda, LN.layer_norm_bwd_cuda = ln
        FA.flash_packed_fwd_cuda, FA.flash_packed_bwd_cuda = fp
        for n, fn in saved.items():
            setattr(G, n, fn)
        M.int8_matmul = mm
        FA.flash_attention, FF.linear_cross_entropy = fa, ce
        FM.fused_mha_fwd_cuda, FM.fused_mha_bwd_cuda = mha
        FMB.fused_mha_bias_fwd_cuda, FMB.fused_mha_bias_bwd_cuda = mhab


def _plain_packed_bwd(q, k, v, out, lse, dout, nh, *, causal, scale,
                      kv_len=None, dq=None, dk=None, dv=None):
    """The plain #7 backward with the kernel wrapper's signature: writes
    into the dq, dk and dv it is given (the slices of one d(qkv))."""
    from paddle_tpu_torch.ops import flash_attention as FA
    grads = FA.flash_packed_bwd_reference(q, k, v, out, lse, dout, nh,
                                          causal, scale, kv_len)
    outs = []
    for dst, g in zip((dq, dk, dv), grads):
        if dst is not None:
            dst.copy_(g)
        outs.append(g if dst is None else dst)
    return tuple(outs)


@contextlib.contextmanager
def env_set(**values):
    """The environment variables `values` set, the environment restored
    after."""
    import os
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def opt_ins():
    """PADDLE_TPU_FUSED_LN=1 and PADDLE_TPU_FLASH_PACKED=1 (GPT's LayerNorms
    through #8 and its attention through #7), the environment restored
    after."""
    return env_set(PADDLE_TPU_FUSED_LN="1", PADDLE_TPU_FLASH_PACKED="1")


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


def divergences(torch, model, device, prompts, chains_a, chains_b,
                weight_dtype=None):
    """For each request whose chains differ: the first differing position
    and the argmax margin there, from a cache-free forward of the prompt
    plus the common prefix (a margin near 0 is a near-tie), with the
    weights the chains were served with."""
    import numpy as np
    out = []
    for i, (a, b) in enumerate(zip(chains_a, chains_b)):
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0])
        seq = np.concatenate([prompts[i], a[:j]])[None]
        with torch.no_grad():
            logits = model(torch.from_numpy(seq).to(device),
                           q8=model._q8(weight_dtype))[0, -1]
        out.append({"request": i, "position": j,
                    "argmax_margin": abs(float(logits[int(a[j])]
                                               - logits[int(b[j])]))})
    return out


def phase_engine_parity(torch, device, card, preset="gpt3-1.3b"):
    """Kernel route against plain route through the engine at `preset`'s
    widths, 2 layers, f32: the plain paged engine on longtail traffic, and
    the prefix-cache + chunked-prefill + speculative engine on repeated
    traffic after its warmup (with its cache-off twin on the kernel
    route). Chains must be equal, or the argmax margin at the first
    divergence below 1e-3. At gpt3-1.3b the slice-3 paths follow; at
    gpt3-2.7b (head dim 80) the legs hold kernels #1-#4 at their masked
    lanes."""
    from paddle_tpu_torch import GPTForCausalLM, gpt_config, \
        repeated_traffic, synthetic_traffic
    from paddle_tpu_torch.ops.cuda import build as KB
    cfg = gpt_config(preset, num_layers=2)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=1)
    name = "engine_parity" if preset == "gpt3-1.3b" else \
        f"engine_parity_{preset}"
    out = {"phase": name, "card": card, "head_dim": cfg.head_dim,
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
            KB.reset_launch_counts()
            kern, eng = serve(torch, model, kw, prompts, warm)
            launches = dict(KB.LAUNCHES)
            KB.reset_launch_counts()
            with plain_route():
                plain, _ = serve(torch, model, kw, prompts, warm)
            check(sum(KB.LAUNCHES.values()) == 0,
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
    out["ok"] = True
    emit(out)
    if preset == "gpt3-1.3b":
        phase_slice3_parity(torch, model, device, card, legs[0][1])
    del model
    torch.cuda.empty_cache()


def phase_slice3_parity(torch, model, device, card, prompts):
    """Kernel route against plain route for the slice-3 paths on phase 3's
    model and its 8 longtail prompts, weights quantized by the default
    rule: generate_static_ragged and the padded engine with int8 weights
    (fp and int8 KV), the paged engine with int8 weights (fp and int8
    KV), and a spec engine drafted by the target itself. Chains must be
    equal, or the argmax margin at the first divergence below 1e-3; #5
    must launch in every leg."""
    import numpy as np
    from paddle_tpu_torch import model_draft_fn
    from paddle_tpu_torch.ops.cuda import build as KB
    cap, new = 128, 32
    ids = np.zeros((len(prompts), cap), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lens = [len(p) for p in prompts]
    base = dict(max_batch=8, prompt_cap=cap, max_new_tokens=new,
                decode_chunk=8, weight_dtype="int8")

    def static(cache_dtype):
        out = model.generate_static_ragged(
            ids, lens, max_new_tokens=new, weight_dtype="int8",
            cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        return list(out[:, cap:].cpu().numpy()), None

    legs = []
    for cd in (None, "int8"):
        q8 = "_q8" if cd else ""
        legs += [
            (f"static_{cd}", lambda cd=cd: static(cd), ["int8_matmul"]),
            (f"padded_{cd}", lambda cd=cd: serve(
                torch, model, dict(base, cache_dtype=cd), prompts),
             ["int8_matmul"]),
            (f"paged_{cd}", lambda cd=cd: serve(
                torch, model, dict(base, paged=True, cache_dtype=cd),
                prompts), ["int8_matmul", "paged_attention" + q8])]
    legs.append(("model_draft", lambda: serve(
        torch, model, dict(base, paged=True, spec_decode=True, spec_k=4,
                           spec_draft=model_draft_fn(model, window=32)),
        prompts), ["int8_matmul", "paged_prefix_attention"]))
    out = {"phase": "engine_parity_slice3", "card": card,
           "model": cfg_line(model.config, "float32"),
           "requests": len(prompts), "tokens_each": new}
    for leg, run, expect in legs:
        KB.reset_launch_counts()
        kern, eng = run()
        launches = dict(KB.LAUNCHES)
        KB.reset_launch_counts()
        with plain_route():
            plain, _ = run()
        check(sum(KB.LAUNCHES.values()) == 0,
              f"{leg}: the plain route launched a kernel")
        for name in expect:
            check(launches[name] > 0,
                  f"{leg}: the kernel route never launched {name}")
        diverged = divergences(torch, model, device, prompts, kern, plain,
                               "int8")
        for d in diverged:
            check(d["argmax_margin"] < 1e-3,
                  f"{leg}: greedy chains diverge: {d}")
        res = {"equal_chains": len(prompts) - len(diverged),
               "diverged": diverged, "kernel_launches": launches}
        if leg == "model_draft":
            c = eng.metrics.counters
            check(c["spec_drafts_model"] > 0,
                  f"model_draft: no window was drafted: {c}")
            res.update(spec_windows=c["spec_windows"],
                       spec_accepted=c["spec_accepted"],
                       spec_proposed=c["spec_proposed"])
        out[leg] = res
    out["ok"] = True
    emit(out)


def cfg_line(cfg, dtype):
    return {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "vocab": cfg.vocab_size, "dtype": dtype}


# -------------------------------------------- phase 4: the main path
def run_traffic(torch, eng, prompts, *, expect=(), want=128, occ=None):
    """The measured run: launch counts and peak memory reset just before
    it, every prompt submitted with the queue kept below max_batch, the
    engine stepped until idle. Checks every request finished `done` with
    `want` tokens in range and every kernel in `expect` launched. Returns
    (requests, seconds, launches, peak bytes); `occ`, a list, receives
    the kv_occupancy gauge after every step."""
    from paddle_tpu_torch.ops.cuda import build as KB
    vocab = eng.model.config.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = []
    def step():
        eng.step()
        if occ is not None and eng.metrics.gauges["kv_occupancy"] \
                is not None:
            occ.append(eng.metrics.gauges["kv_occupancy"])
    for p in prompts:
        reqs.append(eng.submit(p))
        while eng.queue_depth >= eng.config.max_batch:
            step()
    while eng.busy:
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(KB.LAUNCHES)
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
        occ = []
        reqs, dt, counts, peak = run_traffic(
            torch, eng, [t["prompt"] for t in traffic], expect=[name],
            occ=occ)
        add_launches(launches, counts)
        runs[str(cache_dtype)] = {
            "requests": len(reqs), **latency_line(eng.summary(), dt),
            "kv_occupancy_mean": sum(occ) / len(occ),
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
    return runs


def profile_decode(torch, model, traffic):
    """Device busy share and the largest kernels over one engine step of
    the main path (8 admissions plus one 32-step decode chunk)."""
    from paddle_tpu_torch import ServingConfig, ServingEngine
    eng = ServingEngine(model, ServingConfig(
        max_batch=8, prompt_cap=128, max_new_tokens=128, decode_chunk=32,
        paged=True))
    for item in traffic[:8]:
        eng.submit(item["prompt"])
    out = profile_call(torch, eng.step)
    eng.drain()
    return out


def capture_analysis(prof, steps=None):
    """The port's trace analysis (`profiler.trace_analysis`) of a stopped
    torch.profiler capture, through its chrome trace in a temporary
    directory."""
    import os
    import tempfile
    from paddle_tpu_torch.profiler import trace_analysis as TTA
    with tempfile.TemporaryDirectory() as d:
        path = TTA.export_capture(prof, os.path.join(d, "call.trace.json"))
        return TTA.analyze(path, steps=steps)


def summer_device_us(torch, prof):
    """The device time of a capture as torch.profiler's own key_averages()
    sums it (kernel records only: a CPU op's device time repeats its
    kernels'), the yardstick the trace analysis is held to."""
    from torch.autograd import DeviceType

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0
    return sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


SUMMER_TOL = 0.02     # trace analysis vs key_averages() on one capture


def profile_call(torch, fn, names=()):
    """Wall time, device busy time and share, and the largest kernels of
    one call of fn under torch.profiler, read by the port's trace analysis
    (the capture's GPU lanes); with `names`, also every device op whose
    name contains one of them. The device sum is held against
    torch.profiler's own key_averages() of the same capture within
    SUMMER_TOL."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_an = time.perf_counter()
    an = capture_analysis(prof)
    t_an = time.perf_counter() - t_an
    busy_us = an.total_device_us()
    summer = summer_device_us(torch, prof)
    check(abs(busy_us - summer) <= SUMMER_TOL * max(summer, 1e-9),
          f"trace analysis reads {busy_us} device us, key_averages() "
          f"{summer}")
    rows = an.op_totals()
    out = {"wall_s": wall,
           "device_busy_s": busy_us / 1e6 if busy_us else None,
           "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
           "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us
           else None,
           "key_averages_device_s": summer / 1e6,
           "trace_analysis_s": t_an,
           "top_device_ops": [{"op": r["name"],
                               "device_ms": r["dur_us"] / 1e3,
                               "count": r["calls"]} for r in rows[:8]]}
    if names:
        out["named_device_ops"] = [
            {"op": r["name"], "device_ms": r["dur_us"] / 1e3,
             "count": r["calls"]}
            for r in rows if any(n in r["name"] for n in names)]
    return out


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


# ------------------------------------ phase 6: slice 3 at full width
def phase_slice3(torch, model, card, launches, paged_runs):
    """gpt3-1.3b bf16 through the slice-3 paths: bench_decode's static
    configuration (B=8, prompt 128, 128 new tokens, generate_static) with
    bf16 weights, int8 weights, and int8 weights + int8 KV, each one warm
    call then the best of 2, and one decode step of the first two under
    the profiler; phase 4's traffic through the padded engine and through
    the paged engine with int8 weights; a spec engine drafted by a seeded
    gpt3-125m on 8 repeated requests."""
    import numpy as np
    from paddle_tpu_torch import (GPTForCausalLM, ServingConfig,
                                  ServingEngine, ServingMetrics, gpt_config,
                                  model_draft_fn, repeated_traffic,
                                  synthetic_traffic)
    from paddle_tpu_torch.ops.cuda import build as KB
    cfg = model.config
    vocab = cfg.vocab_size
    out = {"phase": "slice3_gpt3_1.3b", "card": card,
           "model": cfg_line(cfg, "bfloat16")}

    # -- static_gpt3_1.3b
    B, P, NEW = 8, 128, 128
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (B, P)).astype(np.int64)).to(model.device)
    legs = {}
    for leg, kw in (("bf16", {}), ("w8", dict(weight_dtype="int8")),
                    ("w8_kv8", dict(weight_dtype="int8",
                                    cache_dtype="int8"))):
        model.generate_static(ids, max_new_tokens=NEW, **kw)   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launch_counts()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            toks = model.generate_static(ids, max_new_tokens=NEW, **kw)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        counts = dict(KB.LAUNCHES)
        add_launches(launches, counts)
        check(toks.shape == (B, P + NEW) and int(toks.min()) >= 0
              and int(toks.max()) < vocab, f"static {leg}: bad tokens")
        if kw:
            # a forward runs 4 GEMMs per layer and the LM head on #5
            check(counts["int8_matmul"] == 2 * NEW * (4 * cfg.num_layers
                                                      + 1),
                  f"static {leg}: int8_matmul launched "
                  f"{counts['int8_matmul']} times")
        legs[leg] = {"tokens_per_s": B * NEW / best, "seconds": best,
                     "ms_per_step": best / NEW * 1e3,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "kernel_launches": counts}
    for leg, kw in (("bf16", {}), ("w8", dict(weight_dtype="int8"))):
        st = model.prefill_static(ids, P + NEW, **kw)
        _, st = model.decode_static(st, 1, return_state=True,
                                    donate_cache=True)
        legs[leg]["profile_decode_step"] = profile_call(
            torch, lambda: model.decode_static(st, 1, return_state=True,
                                               donate_cache=True))
        del st
    out["static"] = {"config": {"B": B, "prompt": P, "new": NEW,
                                "prompts": "np.random.RandomState(0)",
                                "timing": "one warm call, best of 2"},
                     "legs": legs}

    # -- padded_gpt3_1.3b and paged_w8_gpt3_1.3b: phase 4's traffic
    traffic = [t["prompt"] for t in synthetic_traffic(
        24, prompt_cap=128, vocab_size=vocab, rate=1e9, seed=3,
        length_dist="longtail")]
    base = dict(max_batch=8, prompt_cap=128, max_new_tokens=128,
                decode_chunk=32)
    for leg, kw, expect in (
            ("padded", dict(paged=False), []),
            ("paged_w8", dict(paged=True, weight_dtype="int8"),
             ["int8_matmul", "paged_attention"])):
        eng = ServingEngine(model, ServingConfig(**base, **kw))
        for p in traffic[:2]:
            eng.submit(p, max_new_tokens=33)
        eng.drain()
        eng.metrics = ServingMetrics()
        occ = []
        reqs, dt, counts, peak = run_traffic(torch, eng, traffic,
                                             expect=expect, occ=occ)
        add_launches(launches, counts)
        out[leg] = {"config": {**base, **kw, "requests": 24,
                               "traffic": "synthetic_traffic longtail "
                                          "seed=3"},
                    "run": {"requests": len(reqs),
                            **latency_line(eng.summary(), dt),
                            "kv_occupancy_mean": sum(occ) / len(occ),
                            "peak_mem_bytes": peak,
                            "kernel_launches": counts}}
    out["padded"]["kv_occupancy_mean_paged_phase4"] = \
        paged_runs["None"]["kv_occupancy_mean"]

    # -- spec_draft_gpt3_1.3b: drafts from a seeded gpt3-125m
    drafter = GPTForCausalLM(gpt_config("gpt3-125m"), device=model.device,
                             dtype=torch.bfloat16, seed=7)
    repeat = [t["prompt"] for t in repeated_traffic(
        8, n_prompts=4, prompt_len=128, vocab_size=vocab, rate=1e9, seed=3)]
    eng = ServingEngine(model, ServingConfig(
        **base, paged=True, spec_decode=True, spec_k=4,
        spec_draft=model_draft_fn(drafter, window=32)))
    eng.submit(repeat[0], max_new_tokens=9)
    eng.drain()
    eng.metrics = ServingMetrics()
    reqs, dt, counts, peak = run_traffic(
        torch, eng, repeat, expect=["paged_prefix_attention"])
    add_launches(launches, counts)
    c = eng.metrics.counters
    check(c["spec_drafts_model"] > 0, f"spec_draft: no drafted window: {c}")
    out["spec_draft"] = {
        "config": {**base, "paged": True, "spec_k": 4,
                   "drafter": "gpt3-125m bf16 seed 7, window 32",
                   "requests": 8, "traffic": "repeated_traffic 4x128 "
                                             "seed=3"},
        "run": {"requests": len(reqs), **latency_line(eng.summary(), dt),
                "spec_windows": c["spec_windows"],
                "accept_rate": c["spec_accepted"] / c["spec_proposed"]
                if c["spec_proposed"] else None,
                "peak_mem_bytes": peak, "kernel_launches": counts}}
    del drafter
    torch.cuda.empty_cache()
    out["ok"] = True
    emit(out)


# ------------------------------------ phase 7: the training kernels
# ------------------- phase 8: the spill tier and the serving ops surface
SO_BASE = dict(max_batch=8, prompt_cap=128, max_new_tokens=128,
               decode_chunk=32, paged=True, kv_block=16, prefix_cache=True)
SO_KV_BLOCKS = 8 * 16 + 1 + 24 * 8     # phase 5's prefix pool
SO_PREFIX_BLOCKS = 8                   # the trie's device budget: it spills
SO_SPILL_BLOCKS = 64                   # the host tier (~200 MB at bf16)
SO_PROBE_NEW = 16                      # tokens a probe variant decodes
NEAR_TIE = 1e-3                        # argmax margin of a near-tie
SO_ROUTES = ("/metrics", "/healthz", "/statusz", "/tracez", "/memz",
             "/probez")


def block_bytes(model, cache_dtype):
    from paddle_tpu_torch import BlockPool
    return BlockPool.for_model(model, num_blocks=2, block_size=16,
                               cache_dtype=cache_dtype).bytes_per_block


def flip_bytes(torch, eng, blk, n=64, seed=0):
    """The JAX package's CorruptKVBlock: flip `n` seeded random bytes of
    one block's first payload tensor through the pool's own read_block /
    write_block round trip."""
    import numpy as np
    payload = eng._pool.read_block(eng._pools, blk)
    flat = payload[0].view(torch.uint8).reshape(-1)
    for i in np.random.RandomState(seed).randint(0, flat.numel(), size=n):
        flat[int(i)] ^= 0xFF
    eng._pool.write_block(eng._pools, blk, payload)


def round_trip(torch, model, cache_dtype, n=8):
    """read_block then write_block of `n` seeded random blocks of
    gpt3-1.3b pools into other blocks: every layer's K and V (codes and
    scales) equal bitwise; CUDA-event ms per block each way."""
    from paddle_tpu_torch import BlockPool
    pool = BlockPool.for_model(model, num_blocks=2 * n + 2, block_size=16,
                               cache_dtype=cache_dtype)
    pools = pool.make_pools()
    g = torch.Generator(device=model.device).manual_seed(5)
    for layer in pools:
        for p in layer:
            if p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                      device=p.device, dtype=torch.int8))
            else:
                p.normal_(generator=g)
    d2h, h2d = [], []
    for i in range(n):
        src, dst = 1 + i, 1 + n + i
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        e0.record()
        payload = pool.read_block(pools, src)
        e1.record()
        pool.write_block(pools, dst, payload)
        e2.record()
        e2.synchronize()
        d2h.append(e0.elapsed_time(e1))
        h2d.append(e1.elapsed_time(e2))
        check(all(t.is_pinned() for t in payload), "payload not pinned")
        check(all(torch.equal(p[src], p[dst]) for layer in pools
                  for p in layer),
              f"round trip of block {src} ({cache_dtype}) not bitwise")
    nbytes = pool.bytes_per_block
    del pools
    md, mh = statistics.median(d2h), statistics.median(h2d)
    return {"blocks": n, "bytes_per_block": nbytes, "bitwise_equal": True,
            "payload_tensors": len(payload),
            "d2h_ms_per_block": md, "h2d_ms_per_block": mh,
            "d2h_GBps": nbytes / md / 1e6, "h2d_GBps": nbytes / mh / 1e6}


def watch_spill(torch, eng):
    """Wrap the engine's spill reader and writer: a device copy of every
    block as it spills, and of the block it rehydrates into, compared
    after the run (no synchronisation inside the run); per admission, the
    matched tokens and whether the match rehydrated."""
    prefix, tier = eng._prefix, eng._spill
    before, pairs, admits = {}, [], {}
    read, write, match = prefix._read, prefix._write, prefix.match

    def reader(blk):
        planes = [p[blk].clone() for layer in eng._pools for p in layer]
        payload = read(blk)
        before[id(payload[0])] = planes
        return payload

    def writer(blk, payload):
        write(blk, payload)
        pairs.append((before[id(payload[0])],
                      [p[blk].clone() for layer in eng._pools
                       for p in layer]))

    def matcher(tokens):
        r0 = tier.rehydrated_total
        blocks, t = match(tokens)
        key = id(tokens)
        if key not in admits:
            admits[key] = (t, tier.rehydrated_total > r0)
        return blocks, t

    prefix._read, prefix._write, prefix.match = reader, writer, matcher

    def bitwise():
        return all(torch.equal(a, b) for pa, pb in pairs
                   for a, b in zip(pa, pb))
    return admits, pairs, bitwise


def tie_margin(torch, model, prefix, a, b):
    """The argmax margin between tokens a and b after `prefix`, from a
    cache-free forward (divergences()'s logits), and the margin below
    which the two are a near-tie: NEAR_TIE, or in bf16 two units in the
    last place of the larger logit, since bf16 logits of magnitude 2-4
    step by 2^-6 and cannot show a margin below it."""
    import numpy as np
    with torch.no_grad():
        logits = model(torch.from_numpy(np.asarray(prefix)[None]).to(
            model.device))[0, -1]
    la, lb = float(logits[int(a)]), float(logits[int(b)])
    limit = NEAR_TIE
    if model.dtype == torch.bfloat16:
        top = max(abs(la), abs(lb), 1e-30)
        limit = max(limit, 2 * 2.0 ** (math.floor(math.log2(top)) - 7))
    return abs(la - lb), limit


def near_ties(torch, model, prompts, chains_a, chains_b):
    """Requests whose chains differ, each with its first divergence, the
    margin there and its near-tie limit; and whether every difference
    starts at a near-tie."""
    import numpy as np
    div = []
    for i, (a, b) in enumerate(zip(chains_a, chains_b)):
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0])
        m, lim = tie_margin(torch, model,
                            np.concatenate([prompts[i], a[:j]]), a[j], b[j])
        div.append({"request": i, "position": j, "argmax_margin": m,
                    "near_tie_limit": lim})
    return div, all(d["argmax_margin"] < d["near_tie_limit"] for d in div)


def probe_margin(torch, model, prompt, golden, res):
    """(margin, near-tie limit) at a failed probe's first divergence: the
    golden token against the served one after the prompt and the golden
    prefix; (None, None) when the probe produced no token there."""
    import numpy as np
    pos = res.get("first_divergence")
    if pos is None or res.get("got") is None:
        return None, None
    return tie_margin(torch, model, np.concatenate([prompt, golden[:pos]]),
                      res["expected"], res["got"])


def probe_verdicts(torch, model, pr, res):
    """Per variant: status, first divergence and its margin; ok when
    every variant passed or failed only at a near-tie."""
    out, ok = {}, True
    for name, r in res["results"].items():
        row = {"status": r["status"], "first_divergence":
               r.get("first_divergence")}
        if r["status"] == "fail":
            m, lim = probe_margin(torch, model, pr.variants[name],
                                  pr.golden(name), r)
            row.update(argmax_margin=m, near_tie_limit=lim)
            ok = ok and m is not None and m < lim
        elif r["status"] != "pass":
            ok = False
        out[name] = row
    return out, ok


def scraper(srv, pages, errors, stop, every=0.25):
    """Scrape every route over loopback until `stop` is set."""
    import urllib.request

    def loop():
        while not stop.is_set():
            for route in SO_ROUTES:
                try:
                    with urllib.request.urlopen(srv.url(route),
                                                timeout=30) as resp:
                        pages.setdefault(route, []).append(
                            (resp.status, resp.read().decode()))
                except Exception as exc:            # noqa: BLE001
                    errors.append(f"{route}: {exc}")
            stop.wait(every)
    import threading
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return th


def locked_traffic(torch, eng, prompts, lock):
    """Phase 4's submission pattern with every engine call under `lock`
    (the telemetry pollers share it). Returns (requests, seconds,
    launches)."""
    from paddle_tpu_torch.ops.cuda import build as KB
    torch.cuda.synchronize()
    KB.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = []
    for p in prompts:
        with lock:
            reqs.append(eng.submit(p))
        while True:
            with lock:
                if eng.queue_depth < eng.config.max_batch:
                    break
                eng.step()
    while True:
        with lock:
            if not eng.busy:
                break
            eng.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(KB.LAUNCHES)
    check(all(r.status == "done" and r.tokens.shape == (128,)
              for r in reqs), "ops-surface traffic did not finish")
    check(counts["paged_attention"] > 0,
          f"ops-surface traffic never launched #1: {counts}")
    return reqs, dt, counts


def cost_line(eng, reqs, dt, first):
    """tokens/s and ms per engine step of the batch monitor's records
    from index `first` on (the measured window)."""
    toks = sum(r.n_out for r in reqs)
    steps = sorted(r["step_ms"] for r in eng.monitor.records[first:])
    return {"tokens_out": toks, "seconds": dt, "tokens_per_s": toks / dt,
            "engine_steps": len(steps),
            "host_ms_per_step": dt * 1e3 / max(len(steps), 1),
            "step_ms_median": statistics.median(steps)}


def phase_serving_ops(torch, model, card, launches, paged_runs):
    """gpt3-1.3b bf16: the host spill tier and the serving ops surface.
    (1) pool block round trips, fp and int8; (2) phase 5's shared-prefix
    traffic through a prefix engine whose trie holds 8 blocks and spills
    into a 64-block host tier, against the same engine with an ample
    cache, fp and int8: every rehydrated block bitwise, chains equal or
    differing at a near-tie, the auditor clean, the pool conserved; (3)
    phase 4's traffic through a prefix + spec engine with the spill tier
    under serve_telemetry (SLO from phase 4's TTFT, prober, audits),
    scraped over loopback throughout, with a flight recorder on the
    engine's monitor and metrics; probes; (4) a corruption control, whose
    probe failure must pin a capture that /profilez serves with #1 or #3
    in its KernelView; (5) the graceful drain; (6) the same traffic
    without the surface."""
    out = {"phase": "serving_ops_gpt3_1.3b", "card": card,
           "model": cfg_line(model.config, "bfloat16")}
    t_phase = time.perf_counter()
    try:
        serving_ops(torch, model, launches, paged_runs, out)
    except SmokeFailure as exc:
        out.update(ok=False, failed=str(exc))
        emit(out)
        raise
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = True
    emit(out)


def serving_ops(torch, model, launches, paged_runs, out):
    """phase_serving_ops's body; fills `out` as it goes."""
    import tempfile
    import threading
    from urllib.request import urlopen
    from paddle_tpu_torch import (ServingConfig, ServingEngine,
                                  shared_prefix_traffic, synthetic_traffic)
    from paddle_tpu_torch.obs import (FlightRecorder, InvariantAuditor,
                                      Prober, TorchProfilerBackend,
                                      lint_exposition)
    from paddle_tpu_torch.profiler import trace_analysis as TTA
    vocab = model.config.vocab_size

    # (1) round trips
    out["round_trip"] = {str(cd): round_trip(torch, model, cd)
                         for cd in (None, "int8")}

    # (2) the spill engine under rotation, against an ample cache
    prompts = [t["prompt"] for t in shared_prefix_traffic(
        24, n_prefixes=4, prefix_len=96, prompt_cap=128, vocab_size=vocab,
        rate=1e9, seed=3)]
    spill = {}
    for cd in (None, "int8"):
        bpb = block_bytes(model, cd)
        spill_eng = ServingEngine(model, ServingConfig(
            **SO_BASE, cache_dtype=cd, kv_blocks=SO_KV_BLOCKS,
            prefix_cache_bytes=SO_PREFIX_BLOCKS * bpb,
            spill_host_bytes=SO_SPILL_BLOCKS * bpb))
        admits, pairs, bitwise = watch_spill(torch, spill_eng)
        q8 = "_q8" if cd else ""
        expect = ["paged_attention" + q8, "paged_prefix_attention" + q8]
        reqs, dt, counts, peak = run_traffic(torch, spill_eng, prompts,
                                             expect=expect)
        add_launches(launches, counts)
        check(bitwise(), f"a rehydrated block ({cd}) differs from its "
                         f"bytes before the spill")
        st = spill_eng._spill.stats()
        n_pay = 2 if cd else 1
        check(st["spilled_total"] >= 1 and st["rehydrated_total"] >= 1,
              f"the spill engine ({cd}) did not spill and rehydrate: {st}")
        check(st["h2d_copies"] == n_pay * st["rehydrated_total"],
              f"h2d copies {st['h2d_copies']} != {n_pay} x rehydrated "
              f"{st['rehydrated_total']}")
        audit = InvariantAuditor(spill_eng).audit()
        check(not audit["violating"], f"auditor: {audit['findings']}")
        spill_eng._prefix.clear()
        pool = spill_eng._pool
        check(pool.free_blocks == pool.capacity_blocks and not pool._refs,
              "pool not conserved after clear")
        ample = ServingEngine(model, ServingConfig(
            **SO_BASE, cache_dtype=cd, kv_blocks=SO_KV_BLOCKS))
        areqs, adt, acounts, _ = run_traffic(torch, ample, prompts,
                                             expect=expect)
        add_launches(launches, acounts)
        div, ties = near_ties(torch, model, prompts,
                              [r.tokens for r in reqs],
                              [r.tokens for r in areqs])
        check(ties, f"spill chains ({cd}) differ beyond near-ties: {div}")
        kind = {}
        for r in reqs:
            t, rehyd = admits.get(id(r.prompt), (0, False))
            kind[r.id] = "rehydrated" if rehyd else ("hit" if t else "miss")
        ttft = {k: [r.trace.ttft_s for r in reqs if kind[r.id] == k]
                for k in ("rehydrated", "hit", "miss")}
        s = spill_eng.summary()
        spill[str(cd)] = {
            "stats": st, "rehydrated_blocks_checked": len(pairs),
            "requests": {k: len(v) for k, v in ttft.items()},
            "ttft_p50_s": {k: (statistics.median(v) if v else None)
                           for k, v in ttft.items()},
            "tokens_per_s": s["tokens_out_total"] / dt,
            "ample_tokens_per_s": ample.summary()["tokens_out_total"] / adt,
            "chains_equal": len(reqs) - len(div), "near_ties": div,
            "peak_mem_bytes": peak, "kernel_launches": counts}
        del spill_eng, ample
    out["spill"] = spill
    torch.cuda.empty_cache()

    # (3) the ops surface, live
    traffic = [t["prompt"] for t in synthetic_traffic(
        24, prompt_cap=128, vocab_size=vocab, rate=1e9, seed=3,
        length_dist="longtail")]
    ops_cfg = dict(**SO_BASE, spec_decode=True, spec_k=8,
                   kv_blocks=SO_KV_BLOCKS)
    ops_cfg["spill_host_bytes"] = SO_SPILL_BLOCKS * block_bytes(model, None)
    eng = ServingEngine(model, ServingConfig(**ops_cfg))
    ttft_thr = 2 * paged_runs["None"]["ttft_p99_s"]
    pr = Prober(eng, max_new_tokens=SO_PROBE_NEW)
    rows = []
    # the recorder chains onto this hook (serve_telemetry attaches it)
    eng.metrics.on_record = rows.append
    fr_dir = tempfile.TemporaryDirectory(prefix="smoke-flightrec-")
    fr = FlightRecorder(fr_dir.name, trigger_steps=2, cooldown_s=0,
                        backend=TorchProfilerBackend())
    srv = eng.serve_telemetry(
        prober=pr, slo=f"ttft_p99={ttft_thr:.6f},goodput=0.9",
        poll_interval=0.5, invariant_interval=0.5, flightrec=fr)
    try:
        pr.warm()
        pages, errors, stop = {}, [], threading.Event()
        th = scraper(srv, pages, errors, stop)
        first = len(eng.monitor.records)
        reqs, dt, counts = locked_traffic(torch, eng, traffic, pr.lock)
        add_launches(launches, counts)
        stop.set()
        th.join(timeout=60)
        with_surface = cost_line(eng, reqs, dt, first)
        check(not errors, f"scrape errors: {errors[:3]}")
        check(all(code == 200 for route in SO_ROUTES
                  for code, _ in pages.get(route, [(0, "")])),
              "a scrape did not answer 200")
        n_pages = {r: len(pages.get(r, ())) for r in SO_ROUTES}
        check(min(n_pages.values()) >= 2, f"too few scrapes: {n_pages}")
        for _, text in pages["/metrics"]:
            lint_exposition(text)
        status = json.loads(pages["/statusz"][-1][1])
        check({"kv", "prefix_cache", "spill", "memory"} <= set(status),
              f"statusz blocks: {sorted(status)}")
        # the ledger at rest: the sum, the pool and the parameters
        with pr.lock:
            m1, m2 = eng._memz.memz({}), eng._memz.memz({})
        owners = {d["owner"]: d["bytes"] for d in m1["owners"]}
        pool_bytes = sum(t.numel() * t.element_size()
                         for layer in eng._pools for t in layer)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        check(m1["attributed_bytes"] + m1["unattributed_bytes"] ==
              m1["allocated_bytes"], "ledger sum does not hold")
        check(owners["kv_pool"] == pool_bytes, "kv_pool bytes")
        check(owners["model_params"] == param_bytes, "model_params bytes")
        check(m1["unattributed_bytes"] == m2["unattributed_bytes"],
              "unattributed moved at rest")
        # three probe cycles
        cycles = []
        for _ in range(3):
            v, ok = probe_verdicts(torch, model, pr, pr.probe_once())
            check(ok, f"probe failed beyond a near-tie: {v}")
            cycles.append(v)
        out["ops"] = {
            "config": {**ops_cfg, "spill_host_blocks": SO_SPILL_BLOCKS,
                       "traffic": "synthetic_traffic longtail seed=3",
                       "slo": f"ttft_p99={ttft_thr:.6f}s,goodput=0.9",
                       "probe_new_tokens": SO_PROBE_NEW},
            "scrapes": n_pages, "slo": srv.slo.summary()["last_eval"],
            "memz": {"attributed_bytes": m1["attributed_bytes"],
                     "unattributed_bytes": m1["unattributed_bytes"],
                     "allocated_bytes": m1["allocated_bytes"],
                     "owners": owners},
            "compile": status["compile"], "probes": cycles,
            "pollers": srv.pollers, "kernel_launches": counts,
            "with_surface": with_surface}

        # (4) corruption control
        with pr.lock:
            blocks = pr.probe_blocks("prefix_hit")
            check(blocks, "prefix_hit maps no cached block")
            for layer in eng._pools:
                for plane in layer:
                    plane[blocks] = 0
        # a failing variant emits no second probe_fail row: a near-tie
        # failure of an earlier cycle is cleared, so that the corruption's
        # own row is the one that must pin a capture
        was = pr._vstates["prefix_hit"].failing
        pr._vstates["prefix_hit"].failing = False
        n0 = len(rows)
        hit = pr.probe_once()["results"]["prefix_hit"]
        margin, limit = probe_margin(torch, model,
                                     pr.variants["prefix_hit"],
                                     pr.golden("prefix_hit"), hit)
        zero = {"status": hit["status"], "argmax_margin": margin,
                "near_tie_limit": limit}
        flipped = hit["status"] != "fail" or margin is None \
            or margin < limit
        if flipped:
            # zeroed K/V barely moves a random-weight model's logits:
            # the JAX package's own fault (CorruptKVBlock) flips bytes
            with pr.lock:
                for blk in blocks:
                    flip_bytes(torch, eng, blk)
            pr._vstates["prefix_hit"].failing = False
            n0 = len(rows)
            hit = pr.probe_once()["results"]["prefix_hit"]
            margin, limit = probe_margin(torch, model,
                                         pr.variants["prefix_hit"],
                                         pr.golden("prefix_hit"), hit)
        corrupt = [r for r in rows[n0:] if (r.get("probe_fail") or {})
                   .get("variant") == "prefix_hit"]
        fails = [r["probe_fail"] for r in rows[n0:] if "probe_fail" in r]
        check(hit["status"] == "fail", "corrupted prefix_hit blocks passed")
        check(margin is not None and margin >= limit,
              f"corrupted prefix_hit diverged at a near-tie ({margin})")
        check(len(corrupt) == 1, f"probe_fail rows: {fails}")
        out["corruption"] = {"blocks": list(blocks), "zero_fill": zero,
                             "bytes_flipped": flipped,
                             "first_divergence": hit["first_divergence"],
                             "argmax_margin": margin,
                             "near_tie_limit": limit,
                             "failing_before": was,
                             "probe_fail_rows": [f["variant"]
                                                 for f in fails]}
        with pr.lock:
            eng._prefix.clear()

        # (4b) the corruption's probe_fail row pinned a flight-recorder
        # capture of the next engine steps; /profilez serves its KernelView
        with pr.lock:
            for prompt in traffic[2:4]:
                eng.submit(prompt)
            eng.drain()
        listing = json.loads(urlopen(srv.url("/profilez"),
                                     timeout=60).read())
        caps = [c for c in listing["captures"]
                if any((t.get("row") or {}).get("ts") == corrupt[0]["ts"]
                       and "probe_fail" in t["row"] for t in c["triggers"])]
        check(caps and caps[0]["pinned"] and caps[0]["trace_path"],
              f"the corruption's probe_fail row pinned no capture: "
              f"{listing['summary']}")
        page = json.loads(urlopen(srv.url(
            f"/profilez?id={caps[0]['id']}&view=kernel"),
            timeout=60).read())
        check({"decode_part", "prefix_tc"} <= set(TTA.PORT_KERNELS),
              "#1's or #3's kernel is not among the sources' kernels")
        paged = [r for r in page["rows"]
                 if re.search(r"(?<![A-Za-z_])(decode_part|prefix_tc)"
                              r"(?![a-z0-9_])", r["name"])]
        check(paged and ("decode_part" in page["table"]
                         or "prefix_tc" in page["table"]),
              "the pinned capture's KernelView lists neither #1 "
              "(decode_part) nor #3 (prefix_tc)")
        out["flightrec"] = {
            "capture": caps[0]["id"],
            "pinned_by": corrupt[0]["probe_fail"],
            "steps": [caps[0]["step_first"], caps[0]["step_last"]],
            "paged_kernels": [{"op": r["name"][:80], "calls": r["calls"],
                               "device_ms": r["dur_us"] / 1e3}
                              for r in paged],
            "captures": [[c["id"], [t["kind"] for t in c["triggers"]]]
                         for c in listing["captures"]],
            "summary": {k: v for k, v in listing["summary"].items()
                        if k != "dir"}}

        # (5) graceful drain
        with pr.lock:
            eng.submit(traffic[0])
            done = eng.drain(seal=True)
            r = eng.submit(traffic[1])
            check((r.status, r.reason, r.retriable) ==
                  ("rejected", "draining", True), f"drain: {r.reason}")
            check(eng.health()["status"] == "draining", "healthz")
            eng.resume_admission()
            check(eng.submit(traffic[1]).status == "queued", "resume")
            eng.drain()
        out["drain"] = {"served_before_seal": len(done),
                        "flush_rows": len([x for x in rows if "drain"
                                           in x])}
        audit = pr.auditor.audit()
        check(not audit["violating"], f"auditor: {audit['findings']}")
    finally:
        srv.close()
        fr.detach()
        fr_dir.cleanup()

    # (6) the same traffic without the surface
    bare = ServingEngine(model, ServingConfig(**ops_cfg))
    lock = threading.Lock()
    breqs, bdt, bcounts = locked_traffic(torch, bare, traffic, lock)
    add_launches(launches, bcounts)
    out["ops"]["without_surface"] = cost_line(bare, breqs, bdt, 0)


def rel_err(a, b):
    """max |a - b| / max |b| over the whole tensor."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def row_err(a, b):
    """The worst row's error: max over rows (vectors along the last dim)
    of max |a - b| in the row over the rms of b's row, the rms floored at
    10% of b's rms over the whole tensor (rows that are zero in exact
    arithmetic: the first causal row's dq, masked keys' dk and dv). A
    wrong late row or a dropped key tile shows at its own scale, not
    against the largest row of the tensor."""
    a, b = a.float(), b.float()
    rms = b.square().mean(-1).sqrt()
    floor = 0.1 * float(b.square().mean().sqrt())
    return float(((a - b).abs().amax(-1) / rms.clamp_min(
        max(floor, 1e-30))).max())


def peak_for(dtype):
    return TENSOR_FLOPS_PER_S if str(dtype).endswith("bfloat16") \
        else F32_FLOPS_PER_S


def bound_of(flops, nbytes, dtype):
    """(bound ms, "operations" or "bytes") for `flops` at the peak of the
    dtype's units and `nbytes` at the HBM rate."""
    by_ops = flops / peak_for(dtype) * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                             "bytes")


def flash_leaves(torch, device, case, dtype):
    """The gradient leaves of a case and the function that takes q, k, v
    from them: one fused [B, S, 3, H, D] projection viewed three ways when
    Sq == Sk (the model's layout, strided), else three tensors."""
    _, b, sq, sk, h, d, _, _ = case
    g = torch.Generator(device=device).manual_seed(21)
    if sq == sk:
        qkv = torch.randn(b, sq, 3, h, d, generator=g, device=device)
        return [qkv.to(dtype)], lambda t: (t[0][:, :, 0], t[0][:, :, 1],
                                           t[0][:, :, 2])
    return [torch.randn(b, n, h, d, generator=g, device=device).to(dtype)
            for n in (sq, sk, sk)], lambda t: tuple(t)


def flash_run(torch, fn, leaves, split, dout, causal, kv_len):
    """(out, [dq, dk, dv]) of fn; the gradients of a fused qkv leaf are
    taken apart into its q, k and v slices."""
    ls = [x.detach().clone().requires_grad_() for x in leaves]
    out = fn(*split(ls), causal=causal, kv_len=kv_len)
    grads = torch.autograd.grad(out, ls, dout)
    return out.detach(), list(split(grads))


def flash_errs(ko, kg, po, pg):
    """{tensor: (row_err, max abs error)} for out, dq, dk and dv."""
    return {n: (row_err(a, b), float((a.float() - b.float()).abs().max()))
            for n, a, b in zip(("out", "dq", "dk", "dv"), [ko, *kg],
                               [po, *pg])}


def phase_flash_kernels(torch, device, card):
    """Kernel #6 against its plain version, forward and backward through
    autograd, at every case in bf16 and f32, each of its three kernels
    bitwise equal over two launches; at the FLASH_TIMED shapes in bf16,
    the times of each kernel, the plain version and
    F.scaled_dot_product_attention (the yardstick, never on the path),
    forward, backward and both."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import flash_attention as KF
    run = timer(torch, device)
    rows, timed = [], {}
    for case in FLASH_CASES:
        name, b, sq, sk, h, d, causal, kv_len = case
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).split(".")[-1]
            leaves, split = flash_leaves(torch, device, case, dtype)
            g = torch.Generator(device=device).manual_seed(22)
            dout = torch.randn(b, sq, h, d, generator=g,
                               device=device).to(dtype)
            # the kernel route: the wrapper under autograd, then the
            # forward kernel alone for the lse it saves
            ko, kg = flash_run(torch, FA.flash_attention, leaves, split,
                               dout, causal, kv_len)
            q, k, v = split(leaves)
            kw = dict(causal=causal, scale=d ** -0.5, kv_len=kv_len)
            ko2, klse = KF.flash_fwd_cuda(q, k, v, **kw)
            # the backward kernels twice on the same inputs
            delta = KF.flash_delta(ko2, dout)
            bwd = [[KF.flash_bwd_dq_cuda(q, k, v, dout, klse, delta, **kw),
                    *KF.flash_bwd_dkv_cuda(q, k, v, dout, klse, delta, **kw)]
                   for _ in range(2)]
            # the plain versions on the kernels' inputs: the forward on q,
            # k, v; the backward also on the kernel's out and lse
            po, plse = FA.flash_forward_reference(q, k, v, causal=causal,
                                                  kv_len=kv_len)
            pg = list(FA.flash_bwd_reference(q, k, v, ko, klse, dout,
                                             causal=causal, kv_len=kv_len))
            torch.cuda.synchronize()
            otol, gtol, ltol = FLASH_TOL[dt]
            errs = flash_errs(ko, kg, po, pg)
            row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
                   "causal": causal, "kv_len": kv_len, "dtype": dt,
                   "tol_out": otol, "tol_grad": gtol, "tol_lse": ltol,
                   "row_err": {n: e[0] for n, e in errs.items()},
                   "max_abs_err": {n: e[1] for n, e in errs.items()},
                   "lse_max_abs_err": float((klse - plse).abs().max()),
                   "forward_repeats_bitwise": bool(torch.equal(ko, ko2)),
                   "backward_repeats_bitwise": all(
                       bool(torch.equal(a, b)) for a, b in zip(*bwd))}
            finite = all(bool(torch.isfinite(x.float()).all())
                         for x in [ko, klse, *kg])
            check(finite and errs["out"][0] <= otol
                  and max(errs[n][0] for n in ("dq", "dk", "dv")) <= gtol
                  and row["lse_max_abs_err"] <= ltol
                  and row["forward_repeats_bitwise"]
                  and row["backward_repeats_bitwise"],
                  f"flash attention {name} {dt}: kernel disagrees with its "
                  f"plain version: {row}")
            del q, k, v, ko2, klse, plse, delta, bwd
            if dtype == torch.bfloat16 and name in FLASH_CONTROLS:
                row["control"] = flash_control(torch, FA, leaves, split,
                                               dout, case, po, pg, otol,
                                               gtol)
            rows.append(row)
            if name in FLASH_TIMED and dtype == torch.bfloat16:
                timed[name] = (case, leaves, split, dout, row)
            del leaves, ko, kg, po, pg
            torch.cuda.empty_cache()
    # timed last, so the phase ends with the yardstick's calls
    lines = {n: flash_times(torch, F, FA, KF, run, *timed.pop(n))
             for n in FLASH_TIMED}
    emit({"phase": "flash_attention_vs_plain", "ok": True, "card": card,
          "error": "row_err: per row (b, s, h) max |kernel - plain| over "
                   "the row's rms of plain (floored at 10% of the tensor's "
                   "rms), worst row; out, dq, dk and dv each on its own; "
                   "plain: flash_forward_reference on q, k, v and "
                   "flash_bwd_reference on the kernels' own out and lse",
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows,
          **{f"{n}_bf16_times": lines[n]["times"] for n in FLASH_TIMED}})
    return lines[FLASH_TIMED[0]]["kernels"]


def flash_control(torch, FA, leaves, split, dout, case, po, pg, otol,
                  gtol):
    """A kernel that drops its last 64 keys (run with kv_len = Sk - 64)
    against the plain versions of the whole function (po, pg): the limits
    must reject every one of out, dq, dk and dv."""
    _, b, sq, sk, h, d, causal, kv_len = case
    cut = (kv_len or sk) - 64
    co, cg = flash_run(torch, FA.flash_attention, leaves, split, dout,
                       causal, cut)
    errs = {n: e[0] for n, e in flash_errs(co, cg, po, pg).items()}
    check(errs["out"] > otol and min(errs[n] for n in ("dq", "dk", "dv"))
          > gtol, f"flash attention {case[0]}: the limits pass a kernel "
                  f"that drops its last 64 keys: {errs}")
    return {"what": f"kernel with kv_len={cut} (last 64 keys dropped) vs "
                    f"plain", "row_err": errs, "rejected": True}


def flash_times(torch, F, FA, KF, run, case, leaves, split, dout, row):
    """Times at one case; returns the kernels-line rows and the table."""
    name, b, sq, sk, h, d, causal, kv_len = case
    dtype = leaves[0].dtype
    scale = 1.0 / d ** 0.5
    q, k, v = split(leaves)
    out, lse = KF.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    delta = KF.flash_delta(out, dout)
    kw = dict(causal=causal, scale=scale)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lout = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    douth = dout.transpose(1, 2).contiguous()

    def kern_fb():
        x = leaves[0].detach().requires_grad_()
        return torch.autograd.grad(FA.flash_attention(*split([x]),
                                                      causal=causal), x,
                                   dout)

    def plain_fb():
        return FA.flash_bwd_reference(
            q, k, v, *FA.flash_forward_reference(q, k, v, **kw), dout, **kw)

    def lib_fb():
        xs = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        return torch.autograd.grad(F.scaled_dot_product_attention(
            *xs, is_causal=causal), xs, douth)

    t = {"fwd_ms": run(lambda: KF.flash_fwd_cuda(q, k, v, **kw)),
         "dq_ms": run(lambda: KF.flash_bwd_dq_cuda(q, k, v, dout, lse,
                                                   delta, **kw)),
         "dkv_ms": run(lambda: KF.flash_bwd_dkv_cuda(q, k, v, dout, lse,
                                                     delta, **kw)),
         "fwd_bwd_ms": run(kern_fb),
         "plain_fwd_ms": run(lambda: FA.flash_forward_reference(q, k, v,
                                                                **kw)),
         "plain_bwd_ms": run(lambda: FA.flash_bwd_reference(
             q, k, v, out, lse, dout, **kw)),
         "plain_fwd_bwd_ms": run(plain_fb),
         "library_fwd_ms": run(lambda: F.scaled_dot_product_attention(
             qh, kh, vh, is_causal=causal)),
         "library_bwd_ms": run(lambda: torch.autograd.grad(
             lout, (qh, kh, vh), douth, retain_graph=True)),
         "library_fwd_bwd_ms": run(lib_fb)}
    half = 0.5 if causal else 1.0
    mm = 2 * b * h * sq * sk * d * half      # one [S, S] x D product
    item = dout.element_size()
    qkvo = b * (sq + 2 * sk + sq) * h * d * item
    t["bound_fwd_ms"], _ = bound_of(2 * mm, qkvo + b * h * sq * 4, dtype)
    # the FA-2 count: the backward does 2.5 times the forward's operations
    t["bound_bwd_ms"] = 2.5 * t["bound_fwd_ms"]
    t["bound_fwd_bwd_ms"] = 3.5 * t["bound_fwd_ms"]
    t["library"] = "F.scaled_dot_product_attention(is_causal=True) on " \
        "[B, H, S, D] copies, forward, backward and both"
    # each kernel's own operations: dQ recomputes S and dP and forms dQ
    # (3 products), dK/dV recomputes S and dP^T and forms dV and dK (4)
    specs = {"flash_fwd": (t["fwd_ms"], t["plain_fwd_ms"],
                           t["library_fwd_ms"], 2 * mm,
                           qkvo + b * h * sq * 4, row["max_abs_err"]["out"]),
             "flash_bwd_dq": (t["dq_ms"], t["plain_bwd_ms"],
                              t["library_bwd_ms"], 3 * mm,
                              (2 * sq + 2 * sk + sq) * b * h * d * item
                              + 2 * b * h * sq * 4,
                              row["max_abs_err"]["dq"]),
             "flash_bwd_dkv": (t["dkv_ms"], t["plain_bwd_ms"],
                               t["library_bwd_ms"], 4 * mm,
                               (2 * sq + 4 * sk) * b * h * d * item
                               + 2 * b * h * sq * 4,
                               max(row["max_abs_err"]["dk"],
                                   row["max_abs_err"]["dv"]))}
    kernels = {}
    for kname, (ms, pms, lms, flops, nbytes, err) in specs.items():
        bms, by = bound_of(flops, nbytes, dtype)
        kernels[kname] = {"ms": ms, "plain_ms": pms, "library_ms": lms,
                          "bound_ms": bms, "bound_by": by,
                          "max_abs_err": err}
    t["kernels"] = kernels
    return {"kernels": kernels, "times": t}


# kernel #9 cases: (name, B, S, nh, hd, dtype, causal, lens, dropout_p).
# The first three are the main paths' shapes: bench_bert's bert-base
# (B=32, S=512) without and with its attention dropout, and bench_vit's
# vit-l16 at 224^2 (B=64, S=197, ragged); then per-row lengths (one row
# of 1 key, one of 0: every key masked), causal, head dim 80 (vit-h14)
# and f32
FMHA_CASES = [
    ("bert-base", 32, 512, 12, 64, "bfloat16", False, None, 0.0),
    ("bert-base_drop", 32, 512, 12, 64, "bfloat16", False, None, 0.1),
    ("vit-l16", 64, 197, 16, 64, "bfloat16", False, None, 0.0),
    ("lens", 8, 512, 12, 64, "bfloat16", False,
     (512, 400, 257, 128, 77, 1, 511, 0), 0.1),
    ("causal", 4, 512, 12, 64, "bfloat16", True, None, 0.0),
    ("d80", 8, 257, 16, 80, "bfloat16", False, None, 0.0),
    ("f32", 4, 197, 16, 64, "float32", False, None, 0.1),
    ("f32_causal_lens", 4, 256, 2, 64, "float32", True, (256, 100, 1, 0),
     0.0)]
# limits on row_err of out, dq, dk and dv each: bf16 rounds P and dS to
# bf16 before their products and writes bf16 results; f32 differs in
# summation order and exp only
FMHA_TOL = {"bfloat16": 0.1, "float32": 1e-4}
FMHA_LINE = "bert-base_drop"          # the case the kernels line reports
FMHA_TIMED = ("bert-base_drop", "vit-l16")
# controls the bf16 limit must reject: the kernel run with its last 64
# keys masked off, against the plain version of the whole function
FMHA_CONTROLS = ("bert-base", "vit-l16")
# dropout cases whose kept set is read back from the kernels
FMHA_KEPT = ("bert-base_drop", "f32")


def fmha_inputs(torch, device, case):
    _, b, s, nh, hd, dt, _, lens, p = case
    g = torch.Generator(device=device).manual_seed(23)
    dtype = getattr(torch, dt)
    qkv = torch.randn(b, s, 3 * nh * hd, generator=g, device=device)
    dout = torch.randn(b, s, nh * hd, generator=g, device=device)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=device)
    seed = torch.tensor([1234], dtype=torch.int32, device=device) \
        if p else None
    return qkv.to(dtype), dout.to(dtype), kv, seed


def fmha_run(torch, FM, qkv, dout, nh, causal, kv, p, seed):
    """(out, dqkv) of the router under autograd (the kernels on CUDA)."""
    x = qkv.detach().clone().requires_grad_()
    out = FM.fused_mha(x, nh, kv_len=kv, causal=causal, dropout_p=p,
                       dropout_seed=seed)
    g, = torch.autograd.grad(out, x, dout)
    return out.detach(), g


def fmha_strided(torch, FM, qkv, dout, nh, causal, kv, p, seed):
    """(out, dqkv) of the router on a non-contiguous qkv: positions 1..S
    of a tensor one position longer, as a caller's slice would give."""
    b, s, f3 = qkv.shape
    wide = torch.zeros(b, s + 1, f3, dtype=qkv.dtype, device=qkv.device)
    wide[:, 1:] = qkv
    wide.requires_grad_()
    out = FM.fused_mha(wide[:, 1:], nh, kv_len=kv, causal=causal,
                       dropout_p=p, dropout_seed=seed)
    g, = torch.autograd.grad(out, wide, dout)
    return out.detach(), g[:, 1:]


def fmha_errs(ko, kg, po, pg, nh, hd):
    """{tensor: (row_err, max abs error)} for out, dq, dk and dv, rows per
    (batch, position, head)."""
    b, s = ko.shape[:2]
    f = nh * hd
    ks = [ko] + [kg[..., i * f:(i + 1) * f] for i in range(3)]
    ps = [po] + [pg[..., i * f:(i + 1) * f] for i in range(3)]
    return {n: (row_err(a.reshape(b, s, nh, hd), c.reshape(b, s, nh, hd)),
                float((a.float() - c.float()).abs().max()))
            for n, a, c in zip(("out", "dq", "dk", "dv"), ks, ps)}


def fmha_kept(torch, FM, KM, case, seed):
    """The kernels' kept sets read back, against the generator's. With
    q = k = 0 every row's softmax is uniform, so with v one-hot at the keys
    of one block of hd, out[i, h, d] > 0 iff (i, key) is kept (forward);
    with dout one-hot at the queries of one block, the dK/dV pass gives
    dv[key, h, d] > 0 iff (query, key) is kept. Returns the number of
    (b, h, row, col) where each differs from the generator."""
    _, b, s, nh, hd, dt, _, _, p = case
    f = nh * hd
    dev = seed.device
    qkv = torch.zeros(b, s, 3 * f, dtype=getattr(torch, dt), device=dev)
    fwd = torch.zeros(b, nh, s, s, dtype=torch.bool, device=dev)
    bwd = torch.zeros_like(fwd)
    for blk in range(-(-s // hd)):
        j = torch.arange(blk * hd, min(s, (blk + 1) * hd), device=dev)
        hot = torch.zeros(b, s, nh, hd, dtype=qkv.dtype, device=dev)
        hot[:, j, :, j - blk * hd] = 1
        qkv[..., 2 * f:] = hot.reshape(b, s, f)
        out, lse = KM.fused_mha_fwd_cuda(qkv, nh, dropout_p=p, seed=seed)
        fwd[:, :, :, j] = (out.view(b, s, nh, hd)[..., :len(j)] > 0) \
            .permute(0, 2, 1, 3)
        dq = KM.fused_mha_bwd_cuda(qkv, hot.reshape(b, s, f), lse, nh,
                                   dropout_p=p, seed=seed)
        bwd[:, :, j, :] = (dq[..., 2 * f:].view(b, s, nh, hd)[..., :len(j)]
                           > 0).permute(0, 2, 3, 1)
    want = FM.dropout_bits(seed, b, nh, s, s) >= FM.keep_threshold(p)
    return {"forward_mismatches": int((fwd != want).sum()),
            "backward_mismatches": int((bwd != want).sum()),
            "entries": want.numel(),
            "kept_share": float(want.float().mean())}


def phase_fused_mha(torch, device, card):
    """Kernel #9 against its plain version, forward and backward through
    autograd, per row and per tensor (out, dq, dk, dv) at every case, and
    the router on a strided view of the same qkv (bitwise equal); the
    kept sets of the dropout cases read back from the forward and the
    backward kernels; two controls; at the main paths' shapes the times
    of the kernels, the plain versions and the yardstick
    F.scaled_dot_product_attention on the [B, nh, S, hd] views (never on
    the path), forward and backward."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_mha as FM
    from paddle_tpu_torch.ops.cuda import fused_mha as KM
    run = timer(torch, device)
    rows, kernels, times = [], {}, {}
    for case in FMHA_CASES:
        name, b, s, nh, hd, dt, causal, lens, p = case
        qkv, dout, kv, seed = fmha_inputs(torch, device, case)
        kw = dict(lens=kv, causal=causal, dropout_p=p, seed=seed)
        ko, kg = fmha_run(torch, FM, qkv, dout, nh, causal, kv, p, seed)
        po = FM.fused_mha_reference(qkv, nh, **kw)
        pg = FM.fused_mha_bwd_reference(qkv, dout, nh, **kw)
        torch.cuda.synchronize()
        tol = FMHA_TOL[dt]
        errs = fmha_errs(ko, kg, po, pg, nh, hd)
        row = {"case": name, "B": b, "S": s, "nh": nh, "hd": hd,
               "dtype": dt, "causal": causal, "lens": lens,
               "dropout_p": p, "tol": tol,
               "row_err": {n: e[0] for n, e in errs.items()},
               "max_abs_err": {n: e[1] for n, e in errs.items()}}
        finite = all(bool(torch.isfinite(x.float()).all())
                     for x in (ko, kg))
        check(finite and max(e[0] for e in errs.values()) <= tol,
              f"fused_mha {name}: kernel disagrees with its plain "
              f"version: {row}")
        so, sg = fmha_strided(torch, FM, qkv, dout, nh, causal, kv, p,
                              seed)
        row["strided_qkv_equal"] = bool(torch.equal(so, ko)
                                        and torch.equal(sg, kg))
        check(row["strided_qkv_equal"],
              f"fused_mha {name}: the router on a strided view of qkv "
              f"differs from the packed run")
        del so, sg
        if dt == "bfloat16":
            ro, rg = fmha_run(torch, FM, qkv, dout, nh, causal, kv, p, seed)
            row["bitwise_repeatable"] = bool(torch.equal(ro, ko)
                                             and torch.equal(rg, kg))
            check(row["bitwise_repeatable"],
                  f"fused_mha {name}: two launches of the bf16 kernels "
                  f"differ")
            del ro, rg
        if name in FMHA_KEPT:
            kept = fmha_kept(torch, FM, KM, case, seed)
            row["kept_set"] = kept
            check(kept["forward_mismatches"] == 0
                  and kept["backward_mismatches"] == 0,
                  f"fused_mha {name}: the kernels' kept set differs from "
                  f"the generator's: {kept}")
        if name in FMHA_CONTROLS:
            co, cg = fmha_run(torch, FM, qkv, dout, nh, causal, s - 64, p,
                              seed)
            cerr = {n: e[0] for n, e in fmha_errs(co, cg, po, pg, nh,
                                                  hd).items()}
            check(min(cerr.values()) > tol,
                  f"fused_mha {name}: the limit passes a kernel that drops "
                  f"its last 64 keys: {cerr}")
            row["control"] = {"what": f"kernel with kv_len={s - 64} (last "
                                      f"64 keys dropped) vs plain",
                              "row_err": cerr, "rejected": True}
            del co, cg
        if name in FMHA_TIMED:
            t = fmha_times(torch, F, FM, KM, run, case, qkv, dout, kw)
            times[name] = t
            if name == FMHA_LINE:
                for kname, err in (("fused_mha_fwd", errs["out"][1]),
                                   ("fused_mha_bwd", max(
                                       errs[n][1] for n in
                                       ("dq", "dk", "dv")))):
                    kernels[kname] = dict(t[kname], max_abs_err=err)
        rows.append(row)
        del qkv, dout, ko, kg, po, pg
        torch.cuda.empty_cache()
    emit({"phase": "fused_mha_vs_plain", "ok": True, "card": card,
          "error": "row_err: per row (b, s, h) max |kernel - plain| over "
                   "the row's rms of plain (floored at 10% of the tensor's "
                   "rms), worst row; out, dq, dk and dv each on its own; "
                   "plain: fused_mha_reference and fused_mha_bwd_reference "
                   "on the same qkv, dout, lens and seed",
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "times": times})
    return kernels


def fmha_times(torch, F, FM, KM, run, case, qkv, dout, kw):
    """Times and bounds of the forward and the backward at one case."""
    name, b, s, nh, hd, dt, causal, lens, p = case
    f = nh * hd
    x = qkv.detach().requires_grad_()
    views = x.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    lout = F.scaled_dot_product_attention(*views, dropout_p=p,
                                          is_causal=causal)
    douth = dout.view(b, s, nh, hd).transpose(1, 2)
    _, lse = KM.fused_mha_fwd_cuda(qkv, nh, **kw)
    # the backward's three passes, the r pass included
    t = {"fwd_ms": run(lambda: KM.fused_mha_fwd_cuda(qkv, nh, **kw)),
         "bwd_ms": run(lambda: KM.fused_mha_bwd_cuda(qkv, dout, lse, nh,
                                                     **kw)),
         "plain_fwd_ms": run(lambda: FM.fused_mha_reference(qkv, nh, **kw)),
         "plain_bwd_ms": run(lambda: FM.fused_mha_bwd_reference(
             qkv, dout, nh, **kw)),
         "library_fwd_ms": run(lambda: F.scaled_dot_product_attention(
             *views, dropout_p=p, is_causal=causal)),
         "library_bwd_ms": run(lambda: torch.autograd.grad(
             lout, x, douth, retain_graph=True)),
         "library": "F.scaled_dot_product_attention on the [B, nh, S, hd] "
                    "views of qkv (dropout_p as the case), forward; its "
                    "backward into qkv"}
    half = 0.5 if causal else 1.0
    mm = 2 * b * nh * s * s * hd * half       # one [S, S] x hd product
    item = qkv.element_size()
    # what the function needs (the lse residual the kernels keep is not
    # counted): forward: qkv read once, out written once, 2 products;
    # backward: qkv and dout read, dqkv written, 5 products (S, dP, dV, dQ,
    # dK: the kernels run 9, recomputing S and dP in two passes)
    fb = bound_of(2 * mm, (3 * f + f) * b * s * item, qkv.dtype)
    bb = bound_of(5 * mm, (3 * f + f + 3 * f) * b * s * item, qkv.dtype)
    t["fused_mha_fwd"] = {"ms": t["fwd_ms"], "plain_ms": t["plain_fwd_ms"],
                          "library_ms": t["library_fwd_ms"],
                          "bound_ms": fb[0], "bound_by": fb[1]}
    t["fused_mha_bwd"] = {"ms": t["bwd_ms"], "plain_ms": t["plain_bwd_ms"],
                          "library_ms": t["library_bwd_ms"],
                          "bound_ms": bb[0], "bound_by": bb[1]}
    del lout, views, x
    return t


def ce_inputs(torch, device, t, h, v, layout, dtype, seed=31):
    """x ~ N(0, 1) (an ln_f output), W ~ N(0, 0.02) (the model's init),
    labels uniform, per-token upstream gradients uniform in [0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(t, h, generator=g, device=device).to(dtype)
    w = torch.randn(v, h, generator=g, device=device) * 0.02
    w = (w if layout == "vh" else w.t().contiguous()).to(dtype)
    labels = torch.randint(0, v, (t,), generator=g, device=device)
    coef = torch.rand(t, generator=g, device=device)
    return x, w, labels, coef


def ce_run(torch, fn, x, w, labels, coef, layout):
    xs, ws = (a.detach().clone().requires_grad_() for a in (x, w))
    loss = fn(xs, ws, labels, w_layout=layout)
    return loss.detach(), torch.autograd.grad((loss * coef).sum(), (xs, ws))


def phase_linear_ce(torch, device, card):
    """Kernel #11 against its plain version, the loss and (through the
    closed-form backward) dx and dW, at every case, its loss and lse
    bitwise equal over two launches; at every bf16 "vh" case the control
    (the head cut to its first V - CE_CUT rows, labels unchanged, against
    the plain version of the whole head: the loss limit must reject it);
    at the CE_TIMED heads in bf16, the times of the kernel, the plain
    version, the backward and the yardstick F.cross_entropy(F.linear(x,
    w).float(), ...): two calls, logits materialised, never on the
    path (and its F.linear alone)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import linear_ce as LC
    from paddle_tpu_torch.ops.cuda import linear_ce as KL
    run = timer(torch, device)
    rows, line = [], None
    for name, t, h, v, layout, dt in CE_CASES:
        dtype = getattr(torch, dt)
        x, w, labels, coef = ce_inputs(torch, device, t, h, v, layout,
                                       dtype)
        kl, kg = ce_run(torch, LC.linear_cross_entropy, x, w, labels, coef,
                        layout)
        pl, pg = ce_run(torch, lambda a, b, c, w_layout:
                        LC.linear_cross_entropy_reference(a, b, c, w_layout),
                        x, w, labels, coef, layout)
        torch.cuda.synchronize()
        ltol, gtol = CE_TOL[dt]
        row = {"case": name, "T": t, "H": h, "V": v, "layout": layout,
               "dtype": dt, "tol_loss_abs": ltol, "tol_grad": gtol,
               "max_abs_err": float((kl - pl).abs().max()),
               "err_dx": rel_err(kg[0], pg[0]), "err_dw": rel_err(kg[1],
                                                                 pg[1])}
        check(bool(torch.isfinite(kl).all()) and row["max_abs_err"] <= ltol
              and row["err_dx"] <= gtol and row["err_dw"] <= gtol,
              f"linear_ce {name}: kernel disagrees with its plain version: "
              f"{row}")
        one = KL.linear_ce_fwd_cuda(x, w, labels, w_layout=layout)
        two = KL.linear_ce_fwd_cuda(x, w, labels, w_layout=layout)
        row["bitwise_repeat"] = all(torch.equal(a, b)
                                    for a, b in zip(one, two))
        check(row["bitwise_repeat"], f"linear_ce {name}: two launches "
                                     f"differ")
        if layout == "vh" and dt == "bfloat16":
            ctl, _ = KL.linear_ce_fwd_cuda(x, w[:v - CE_CUT], labels)
            torch.cuda.synchronize()
            row["control"] = {
                "what": f"w cut to its first V - {CE_CUT} rows, labels "
                        f"unchanged, vs plain on the whole head",
                "max_abs_err": float((ctl - pl).abs().max())}
            row["control"]["rejected"] = row["control"]["max_abs_err"] > ltol
            check(row["control"]["rejected"],
                  f"linear_ce {name}: the loss limit passes a kernel that "
                  f"drops the head's last {CE_CUT} rows: {row}")
            del ctl
        lse = one[1]
        del one, two
        if name in CE_TIMED:
            bms, by = bound_of(2 * t * h * v, (t * h + v * h) * 2
                               + t * (8 + 4 + 4), dtype)
            row.update(
                ms=run(lambda: KL.linear_ce_fwd_cuda(x, w, labels,
                                                     w_layout=layout)),
                plain_ms=run(lambda: LC.linear_cross_entropy_reference(
                    x, w, labels, layout)),
                library_ms=run(lambda: F.cross_entropy(
                    F.linear(x, w).float(), labels, reduction="none")),
                # the yardstick's product alone (cuBLAS), for reference
                gemm_ms=run(lambda: F.linear(x, w)),
                bwd_ms=run(lambda: LC._linear_ce_bwd(x, w, labels, lse,
                                                     coef, layout, 2)),
                bound_ms=bms, bound_by=by,
                # recomputed logits, dx and dW: three T x H x V products
                bound_bwd_ms=bound_of(6 * t * h * v, 0, dtype)[0],
                library="F.cross_entropy(F.linear(x, w).float(), labels, "
                        "reduction='none'): two calls")
            if name == "gpt3-1.3b":
                line = row
        rows.append(row)
        del x, w, kg, pg
        torch.cuda.empty_cache()
    emit({"phase": "linear_ce_vs_plain", "ok": True, "card": card,
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "error": "loss: max abs; dx, dW: max |kernel - plain| / max "
                   "|plain|",
          "cases": rows})
    return {"linear_ce_fwd": line}


def decay_fun(name):
    return not (name.endswith(".bias") or ".ln_" in name)


def phase_train_parity(torch, device, card):
    """The training path, kernel route against plain route, at gpt3-1.3b
    widths cut to 2 layers in f32 (B=2, S=512: flash and fused-CE routed):
    the loss and every parameter gradient, then 5-step AdamW TrainStep
    trajectories (weight decay 0.01 with bias and LayerNorm exempt,
    ClipGradByGlobalNorm(1.0)) with and without grad_accum_steps=2."""
    import numpy as np
    from paddle_tpu_torch import (AdamW, ClipGradByGlobalNorm,
                                  GPTForCausalLM, TrainStep, gpt_config)
    from paddle_tpu_torch.ops.cuda import build as KB
    cfg = gpt_config("gpt3-1.3b", num_layers=2)
    B_, S_ = 2, 512
    base = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=1)
    init = {k: v.clone() for k, v in base.state_dict().items()}
    batches = [torch.from_numpy(np.random.RandomState(40 + i).randint(
        0, cfg.vocab_size, (B_, S_)).astype(np.int64)).to(device)
        for i in range(5)]
    out = {"phase": "train_parity", "card": card,
           "model": cfg_line(cfg, "float32"), "B": B_, "S": S_}

    def grads(plain):
        base.load_state_dict(init)
        base.zero_grad(set_to_none=True)
        KB.reset_launch_counts()
        with plain_route() if plain else contextlib.nullcontext():
            loss = base.loss(batches[0], batches[0])
            loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), {n: p.grad.clone()
                              for n, p in base.named_parameters()},
                dict(KB.LAUNCHES))
    kl, kg, kc = grads(False)
    pl, pg, pc = grads(True)
    check(sum(pc.values()) == 0, "the plain route launched a kernel")
    want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
            "linear_ce_fwd": 1}
    check(all(kc[k] == n for k, n in want.items()),
          f"kernel route launches {kc}, want {want}")
    errs = {n: rel_err(kg[n], pg[n]) for n in kg}
    worst = max(errs, key=errs.get)
    out["loss"] = {"kernel": kl, "plain": pl,
                   "rel_err": abs(kl - pl) / abs(pl), "tol": 1e-5}
    out["grads"] = {"worst_param": worst, "worst_rel_err": errs[worst],
                    "tol": 1e-3, "launches": kc}
    check(out["loss"]["rel_err"] <= 1e-5 and errs[worst] <= 1e-3,
          f"train parity: loss or grads differ: {out}")
    del kg, pg
    legs = {}
    for accum in (1, 2):
        traj = {}
        for plain in (False, True):
            base.load_state_dict(init)
            opt = AdamW(1e-4, parameters=base.named_parameters(),
                        weight_decay=0.01, apply_decay_param_fun=decay_fun,
                        grad_clip=ClipGradByGlobalNorm(1.0), device=device)
            step = TrainStep(base, opt, lambda a, b: base.loss(a, b),
                             grad_accum_steps=accum, device=device)
            with plain_route() if plain else contextlib.nullcontext():
                losses = [float(step(x, x)) for x in batches]
            traj[plain] = (losses, {n: p.detach().clone()
                                    for n, p in base.named_parameters()})
            del step, opt
        (kls, kp), (pls, pp) = traj[False], traj[True]
        rel = max(abs(a - b) / abs(b) for a, b in zip(kls, pls))
        dp = max(float((kp[n] - pp[n]).abs().max()) for n in kp)
        legs[f"accum_{accum}"] = {"kernel_losses": kls, "plain_losses": pls,
                                  "max_rel_err": rel, "tol": 1e-4,
                                  "max_param_diff_in_lr": dp / 1e-4}
        check(rel <= 1e-4, f"train parity accum={accum}: trajectories "
                           f"differ: {legs}")
    out["trajectories"] = legs
    out["ok"] = True
    emit(out)
    del base
    torch.cuda.empty_cache()


def phase_train_full(torch, card, device, fused=False, default=None):
    """bench_gpt's configuration at full width: gpt3-1.3b with 2048
    positions, bf16 parameters, B=3, S=2048, AdamW(lr=1e-4, bf16 moments),
    model.loss (flash attention #6 in every layer, fused CE #11), no
    recompute, no accumulation; token ids from np.random.RandomState(0),
    the labels are the ids. 2 warm steps, then the best of 2 windows of 10
    timed steps, then one profiled step. On fresh random batches the loss
    need not fall within 22 steps at lr 1e-4, so learning is checked on
    one batch repeated for 6 more steps: its loss must fall. With `fused`
    the same run under both opt-ins (`opt_ins`): every LayerNorm through
    #8 (2 L + 1 a forward) and the attention through #7 on the packed
    qkv, none through #6; `default` is the default route's summary from
    the same run, reported beside. Returns (launch counts, summary)."""
    import math
    import numpy as np
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep, gpt_config
    from paddle_tpu_torch.ops.cuda import build as KB
    B_, S_, N = 3, 2048, 10
    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=S_)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt, lambda a, b: model.loss(a, b),
                     device=device)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (N + 2, B_, S_)).astype(np.int64)).to(device)
    L = cfg.num_layers
    flash = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    packed = {"flash_packed_fwd": L, "flash_packed_bwd_dq": L,
              "flash_packed_bwd_dkv": L}
    lns = {"layer_norm_fwd": 2 * L + 1, "layer_norm_bwd": 2 * L + 1}
    if fused:
        want = {**{k: 0 for k in flash}, **packed, **lns}
    else:
        want = {**flash, **{k: 0 for k in (*packed, *lns)}}
    want["linear_ce_fwd"] = 1
    with opt_ins() if fused else contextlib.nullcontext():
        warm = [float(step(ids[i], ids[i])) for i in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KB.reset_launch_counts()
        windows, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            ls = [step(ids[2 + i], ids[2 + i]) for i in range(N)]
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
            losses = [float(x) for x in ls]
        counts = dict(KB.LAUNCHES)
        per_step = {k: counts[k] / (2 * N) for k in want}
        check(per_step == want,
              f"launches per step {per_step}, want {want}")
        peak = torch.cuda.max_memory_allocated()
        prof = profile_call(torch, lambda: step(ids[2], ids[2]),
                            names=("fwd_wg", "dq_wg", "dkv_wg",
                                   "lce_wg", "lce_merge", "ln_fwd",
                                   "ln_bwd"))
        same = [float(step(ids[0], ids[0])) for _ in range(6)]
    best = min(windows)
    n_params = sum(p.numel() for p in model.parameters())
    per_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a training loss is not finite")
    check(abs(warm[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {warm[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size)}")
    check(same[-1] < same[0],
          f"the loss on a repeated batch did not fall: {same}")
    summary = {"ms_per_step": best / N * 1e3, "tokens_per_s": tok_s,
               "mfu": per_token * tok_s / TENSOR_FLOPS_PER_S,
               "peak_mem_bytes": peak,
               "device_busy_s": prof["device_busy_s"]}
    emit({"phase": "train_gpt3_1.3b_fused" if fused else "train_gpt3_1.3b",
          "ok": True, "card": card,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {"B": B_, "S": S_, "max_position_embeddings": S_,
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                     "loss": "model.loss (fused LM head)",
                     "recompute": False, "grad_accum_steps": 1,
                     "opt_ins": ["PADDLE_TPU_FUSED_LN=1",
                                 "PADDLE_TPU_FLASH_PACKED=1"] if fused
                     else [],
                     "ids": "np.random.RandomState(0), labels = ids",
                     "timing": "2 warm steps, best of 2 windows of 10"},
          "params": n_params, **summary,
          "window_s": windows, "flops_per_token": per_token,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same,
          "launches_per_step": per_step, "profile_step": prof,
          **({"default_route": default} if fused else {})})
    del step, opt, model
    torch.cuda.empty_cache()
    return counts, summary


# ----------------------- training observability at gpt3-1.3b's width
OBS = {"B": 3, "S": 2048, "window": 3, "every": 5, "recorded": 2,
       "poison": "gpt.h.12.mlp.up.weight"}
# the port's kernels a gpt3-1.3b step runs, by the name the trace shows
# and the launch count that counts them (#6's three passes, #11)
OBS_KERNELS = {"fwd_wg": "flash_fwd", "dq_wg": "flash_bwd_dq",
               "dkv_wg": "flash_bwd_dkv", "lce_wg": "linear_ce_fwd"}


def numerics_paths(layers):
    """The stats rows of TrainStep(numerics=...) on GPTForCausalLM: the
    activation rows in forward order, then a grad row per layer group
    (tests/test_torch_numerics.py holds the 2-layer list against the
    JAX package's)."""
    root = "GPTForCausalLM/gpt"
    acts = [f"{root}/wte"]
    for i in range(layers):
        h = f"{root}/h/{i}"
        acts += [f"{h}/ln_1", f"{h}/attn/qkv", f"{h}/attn/out",
                 f"{h}/attn", f"{h}/ln_2", f"{h}/mlp/up", f"{h}/mlp/down",
                 f"{h}/mlp", h]
    acts += [f"{root}/ln_f", root]
    grads = [f"grad:{root}/wte", f"grad:{root}/wpe"]
    for i in range(layers):
        h = f"grad:{root}/h/{i}"
        grads += [f"{h}/ln_1", f"{h}/attn/qkv", f"{h}/attn/out",
                  f"{h}/ln_2", f"{h}/mlp/up", f"{h}/mlp/down"]
    grads.append(f"grad:{root}/ln_f")
    return acts + grads


def kernel_calls(an, name):
    """Calls of the port kernel `name` (one of trace_analysis.PORT_KERNELS,
    the `__global__` functions of the sources) in a trace analysis
    (template instances summed)."""
    from paddle_tpu_torch.profiler.trace_analysis import PORT_KERNELS
    check(name in PORT_KERNELS, f"{name} is not a kernel of the sources")
    pat = re.compile(r"(?<![A-Za-z_])" + name + r"(?![a-z0-9_])")
    return sum(r["calls"] for r in an.op_totals() if pat.search(r["name"]))


def phase_observability_train(torch, card, device):
    """The training half of observability at full width: gpt3-1.3b bf16,
    B=3, S=2048, AdamW with bf16 moments (phase 7's train_gpt3_1.3b), one
    TrainStep with every telemetry option (a StepMonitor with a flight
    recorder on torch.profiler, NumericsConfig with a dump directory, a
    MemoryLedger, a SpanRecorder) and one with none, on the same model.
    Gates: the ledger's owners equal the parameters' and moments' bytes;
    a Profiler window of OBS["recorded"] steps whose KernelView counts
    #6's three passes and #11 as the launch counters do and whose
    DeviceView busy time is key_averages()'s within SUMMER_TOL; a clean
    step's stats tree holds every row of `numerics_paths`, all finite; an
    inf in OBS["poison"] is named by the tree and an inf/nan event, the
    step is skipped bitwise, dumped, and the dump replays the event; the
    event pins a flight-recorder capture that parses; the goodput report
    conserves, one compile span then steps. Reported: ms a step with
    every option on (numerics fetched every OBS["every"] steps) against
    none, the goodput ratio, DeviceView's busy share. Returns the launch
    counts."""
    import gc
    out = {"phase": "observability_train_gpt3_1.3b", "card": card}
    t_phase = time.perf_counter()
    try:
        launches = observability_train(torch, device, out)
    except SmokeFailure as exc:
        out.update(ok=False, failed=str(exc))
        emit(out)
        raise
    # the step, its ledger and its monitor refer to each other: collect
    # them before a later phase reads its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = True
    emit(out)
    return launches


def observability_train(torch, device, out):
    """phase_observability_train's body; fills `out` as it goes and
    returns the launch counts."""
    import os
    import tempfile
    import numpy as np
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep, gpt_config
    from paddle_tpu_torch.debugging import NumericsConfig, load_dump, replay
    from paddle_tpu_torch.obs import (FlightRecorder, MemoryLedger,
                                      TorchProfilerBackend)
    from paddle_tpu_torch.ops.cuda import build as KB
    from paddle_tpu_torch.profiler import (Profiler, StepMonitor,
                                           make_scheduler)
    from paddle_tpu_torch.profiler import trace_analysis as TTA
    from paddle_tpu_torch.profiler.goodput import GoodputReport
    from paddle_tpu_torch.profiler.timeline import SpanRecorder, from_recorder
    B_, S_, W = OBS["B"], OBS["S"], OBS["window"]
    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=S_)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    model.train()
    L = cfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    per_token = 6 * n_params + 12 * L * cfg.hidden_size * S_
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, B_, S_)).astype(np.int64)).to(device)

    def loss_fn(a, b):
        return model.loss(a, b)
    tmp = tempfile.TemporaryDirectory(prefix="smoke-obs-")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, under `name` in out["sections_s"]."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
    out["sections_s"] = laps
    out["model"] = cfg_line(cfg, "bfloat16")
    out["config"] = {"B": B_, "S": S_,
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                     "numerics_every_n_steps": OBS["every"],
                     "window_steps": W,
                     "profiler_recorded_steps": OBS["recorded"],
                     "poisoned": OBS["poison"] + "[0, 0]"}
    launches = {}
    try:
        monitor = StepMonitor(items_per_step=B_ * S_,
                              flops_per_item=per_token, unit="tokens/s")
        ledger = MemoryLedger(device=device,
                              postmortem_dir=os.path.join(tmp.name, "oom"))
        spans = SpanRecorder(os.path.join(tmp.name, "seg.timeline.jsonl"))
        rec = FlightRecorder(os.path.join(tmp.name, "flightrec"),
                             trigger_steps=2, cooldown_s=0,
                             backend=TorchProfilerBackend())
        rec.attach(monitor=monitor)
        events = []
        ncfg = NumericsConfig(every_n_steps=OBS["every"],
                              dump_dir=os.path.join(tmp.name, "dumps"),
                              on_event=events.append)
        opt_on = AdamW(learning_rate=1e-4,
                       parameters=model.named_parameters(),
                       moment_dtype="bfloat16", device=device)
        opt_off = AdamW(learning_rate=1e-4,
                        parameters=model.named_parameters(),
                        moment_dtype="bfloat16", device=device)
        on = TrainStep(model, opt_on, loss_fn, monitor=monitor,
                       numerics=ncfg, memz=ledger, timeline=spans,
                       device=device)
        off = TrainStep(model, opt_off, loss_fn, device=device)
        KB.reset_launch_counts()
        on(ids[0], ids[0])
        on(ids[1], ids[1])
        off(ids[0], ids[0])
        off(ids[1], ids[1])
        torch.cuda.synchronize()
        add_launches(launches, KB.LAUNCHES)
        lap("model_and_first_steps")

        # the memory ledger: exact byte sums of its two owners
        owners = {o["owner"]: o["bytes"]
                  for o in ledger.census()["owners"]}
        p_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        m_bytes = sum(v.numel() * v.element_size()
                      for st in on._opt_state for v in st.values())
        check(owners.get("train_params") == p_bytes,
              f"train_params {owners.get('train_params')} != {p_bytes}")
        check(owners.get("train_opt_state") == m_bytes,
              f"train_opt_state {owners.get('train_opt_state')} != "
              f"{m_bytes}")
        out["memz"] = {"train_params": p_bytes, "train_opt_state": m_bytes}

        # the cost: ms a step, every option on against none, alternating
        KB.reset_launch_counts()
        wins = {"on": [], "off": []}
        for _ in range(2):
            for name, st in (("off", off), ("on", on)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(W):
                    st(ids[2 + i % 6], ids[2 + i % 6])
                torch.cuda.synchronize()
                wins[name].append(time.perf_counter() - t0)
        add_launches(launches, KB.LAUNCHES)
        ms = {k: min(v) / W * 1e3 for k, v in wins.items()}
        out["cost"] = {"ms_per_step_on": ms["on"],
                       "ms_per_step_off": ms["off"],
                       "ratio": ms["on"] / ms["off"], "windows_s": wins,
                       "timing": f"best of 2 alternating windows of {W}"}
        lap("cost_windows")

        # the Profiler over torch.profiler: OBS["recorded"] steady steps
        n_rec = OBS["recorded"]
        prof = Profiler(scheduler=make_scheduler(closed=1, ready=0,
                                                 record=n_rec, repeat=1),
                        trace_dir=os.path.join(tmp.name, "profiler"))
        prof.start()
        on(ids[2], ids[2])
        torch.cuda.synchronize()        # nothing of this step in the window
        prof.step()                     # the tracer starts
        KB.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(n_rec):
            on(ids[3 + i], ids[3 + i])
            if i < n_rec - 1:
                prof.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(KB.LAUNCHES)
        prof.step()                     # waits for the card, stops, writes
        prof.stop()
        add_launches(launches, counts)
        lap("profiled_steps_and_export")
        check(prof.last_capture is not None, "the Profiler wrote no capture")
        an = TTA.analyze(prof.last_capture, steps=n_rec)
        check(not an.host_lanes, "the capture holds no GPU lane")
        kview = an.kernel_view(top=400)
        calls = {k: kernel_calls(an, k) for k in OBS_KERNELS}
        for k, count_name in OBS_KERNELS.items():
            check(k in kview, f"KernelView does not list {k}")
            check(calls[k] == counts.get(count_name, 0) and calls[k] > 0,
                  f"KernelView counts {calls[k]} {k}, the launch counter "
                  f"{counts.get(count_name, 0)} {count_name}")
        busy_us = sum(r["busy_us"] for r in an.lane_busy())
        lap("trace_analysis")
        summer = summer_device_us(torch, prof.last_tracer)
        lap("key_averages")
        check(abs(busy_us - summer) <= SUMMER_TOL * summer,
              f"DeviceView busy {busy_us} us, key_averages() {summer}")
        out["profiler"] = {
            "recorded_steps": n_rec, "kernel_calls": calls,
            "launch_counts": {v: counts.get(v, 0)
                              for v in OBS_KERNELS.values()},
            "device_view_busy_ms_per_step": busy_us / n_rec / 1e3,
            "key_averages_ms_per_step": summer / n_rec / 1e3,
            "wall_ms_per_step": wall / n_rec * 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "category_ms_per_step": {k: v / n_rec / 1e3 for k, v in
                                     an.category_totals().items()},
            "lanes": len(an.lane_busy()),
            "top": [{"op": r["name"][:90], "ms_per_step":
                     r["dur_us"] / n_rec / 1e3, "calls": r["calls"]}
                    for r in an.op_totals()[:8]]}

        lap("profiler_tables")

        # numerics on a clean step
        ncfg.every_n_steps = 1
        on(ids[6], ids[6])
        tree = on.numerics_stats()
        want = numerics_paths(L)
        diff = [(a, b) for a, b in zip(tree.paths, want) if a != b]
        check(tree.paths == want,
              f"stats rows: {len(tree.paths)}, want {len(want)}; first "
              f"difference {diff[:1]}")
        check(not tree.nonfinite_rows() and not events,
              f"a clean step has non-finite rows or events: "
              f"{tree.nonfinite_rows()[:2]} {events[:2]}")
        out["numerics"] = {"rows": len(tree.paths),
                           "activation_rows": sum(
                               not p.startswith("grad:") for p in tree.paths),
                           "grad_norm": float(on._last_aux["grad_norm"])}

        lap("clean_numerics_step")

        # a poisoned step: named, skipped bitwise, dumped, replayed
        params = dict(model.named_parameters())
        w = params[OBS["poison"]]
        kept = w[0, 0].clone()
        with torch.no_grad():
            w[0, 0] = float("inf")
        snap = {n: p.detach().clone() for n, p in params.items()}
        msnap = [{k: v.clone() for k, v in st.items()}
                 for st in on._opt_state]
        # one warning a non-finite row (hundreds) would bury stderr
        quiet = logging.getLogger("paddle_tpu_torch")
        level = quiet.level
        quiet.setLevel(logging.ERROR)
        t_bad = time.perf_counter()
        on(ids[7], ids[7])             # fetch, detect, dump
        torch.cuda.synchronize()
        t_bad = time.perf_counter() - t_bad
        lap("poisoned_step_with_dump")
        path_row = "GPTForCausalLM/" + "/".join(
            OBS["poison"].split(".")[:-1])
        tree = on.numerics_stats()
        first = tree.first_nonfinite()
        check(first is not None and first[0] == path_row,
              f"first non-finite row {first and first[0]}, want {path_row}")
        bad = [e for e in events if e.kind in ("nan", "inf")]
        check(bad and bad[0].path == path_row,
              f"first nan/inf event {bad[:1]}, want one at {path_row}")
        same = all(torch.equal(p, snap[n]) for n, p in params.items())
        msame = all(torch.equal(st[k], m[k])
                    for st, m in zip(on._opt_state, msnap) for k in st)
        check(same and msame, "the skipped update moved a parameter "
                              "or a moment")
        del snap, msnap
        dumps = sorted(os.listdir(ncfg.dump_dir))
        check(len(dumps) == 1, f"dumps: {dumps}")
        t_replay = time.perf_counter()
        dump = load_dump(os.path.join(ncfg.dump_dir, dumps[0]))
        res = replay(dump, model, loss_fn)
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t_replay
        lap("load_and_replay")
        rbad = [e for e in res.events if e.kind in ("nan", "inf")]
        check(rbad and (rbad[0].kind, rbad[0].path) ==
              (bad[0].kind, bad[0].path),
              f"replay fired {rbad[:1]}, the step {bad[:1]}")
        quiet.setLevel(level)
        with torch.no_grad():
            w[0, 0] = kept          # the replay loaded the inf back too
        out["poisoned"] = {
            "parameter": OBS["poison"] + "[0, 0] = inf",
            "first_nonfinite": first[0], "event": bad[0].kind,
            "events": len(events), "skipped_bitwise": True,
            "dump": dumps[0], "replay_event": [rbad[0].kind, rbad[0].path],
            "replay_matches": res.matches, "replay_s": t_replay,
            "step_with_dump_s": t_bad,
            "dump_bytes": sum(os.path.getsize(os.path.join(
                ncfg.dump_dir, dumps[0], f)) for f in os.listdir(
                os.path.join(ncfg.dump_dir, dumps[0])))}

        lap("poison_checks")

        # the flight recorder: the event pinned a capture of next steps
        ncfg.every_n_steps = OBS["every"]
        check(rec.triggers_total >= 1, "no trigger reached the recorder")
        for i in range(3):
            on(ids[i], ids[i])
        torch.cuda.synchronize()
        lap("recorder_steps_and_export")
        caps = [c for c in rec.captures
                if any(t["kind"] == "numerics" for t in c["triggers"])]
        check(caps and caps[0]["pinned"] and caps[0]["trace_path"]
              and rec.capture_errors == 0,
              f"no pinned numerics capture: {rec.summary()}")
        fan = TTA.analyze(caps[0]["trace_path"], steps=2)
        check(not fan.host_lanes and kernel_calls(fan, "fwd_wg") > 0,
              "the pinned capture holds no flash attention kernel")
        out["flightrec"] = {"capture": caps[0]["id"],
                            "steps": [caps[0]["step_first"],
                                      caps[0]["step_last"]],
                            "device_ms_per_step":
                                fan.total_device_us() / 2 / 1e3,
                            "summary": {k: v for k, v in rec.summary()
                                        .items() if k != "dir"}}

        lap("capture_analysis")

        # goodput over the recorder's segment
        spans.close()
        report = GoodputReport([from_recorder(spans)])
        report.check_conservation()
        cats = [s.cat for s in spans.spans()]
        check(cats[0] == "compile" and set(cats[1:]) == {"step"},
              f"span categories {cats[:3]}...")
        out["goodput"] = {**report.summary(),
                          "note": "wall includes the phase's other work "
                                  "between steps (the plain step's "
                                  "windows, the dump and the replay)"}
        out["monitor"] = {k: v for k, v in monitor.report().items()
                          if k in ("steps", "step_ms", "items_per_s", "mfu",
                                   "compiles", "recompiles",
                                   "numerics_events", "hbm_peak_bytes")}
        rec.detach()
    finally:
        tmp.cleanup()
        lap("goodput_and_cleanup")
    return launches


def phase_train_parity_fused(torch, device, card):
    """Slice 7's training path, kernel route against plain route, under
    both opt-ins (#8 for every LayerNorm, #7 for the attention) at
    gpt3-1.3b widths cut to 2 layers in f32 (B=2, S=512): the loss and
    every parameter gradient, and a 5-step AdamW TrainStep trajectory
    (decay 0.01 with bias and LayerNorm exempt, ClipGradByGlobalNorm(1.0));
    then once more in train() mode with recompute_policy="save_qkv" and
    int8 moments. Launch counts as derived from the code: a forward runs
    #8 2 L + 1 times and #7 L times; under save_qkv each block's two
    regions rerun ln_1 (with the qkv projection) and ln_2 with the
    attention in the backward, so #8's forward runs 4 L + 1 times and
    #7's 2 L times, their backward passes once."""
    import numpy as np
    from paddle_tpu_torch import (AdamW, ClipGradByGlobalNorm,
                                  GPTForCausalLM, TrainStep, gpt_config)
    from paddle_tpu_torch.ops.cuda import build as KB
    cfg = gpt_config("gpt3-1.3b", num_layers=2)
    L, B_, S_ = cfg.num_layers, 2, 512
    base = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=1)
    init = {k: v.clone() for k, v in base.state_dict().items()}
    batches = [torch.from_numpy(np.random.RandomState(40 + i).randint(
        0, cfg.vocab_size, (B_, S_)).astype(np.int64)).to(device)
        for i in range(5)]
    out = {"phase": "train_parity_fused", "card": card,
           "model": cfg_line(cfg, "float32"), "B": B_, "S": S_,
           "opt_ins": ["PADDLE_TPU_FUSED_LN=1", "PADDLE_TPU_FLASH_PACKED=1"]}

    def grads(plain):
        base.load_state_dict(init)
        base.zero_grad(set_to_none=True)
        KB.reset_launch_counts()
        with plain_route() if plain else contextlib.nullcontext():
            loss = base.loss(batches[0], batches[0])
            loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), {n: p.grad.clone()
                              for n, p in base.named_parameters()},
                dict(KB.LAUNCHES))

    def trajectory(plain, moments):
        base.load_state_dict(init)
        opt = AdamW(1e-4, parameters=base.named_parameters(),
                    weight_decay=0.01, apply_decay_param_fun=decay_fun,
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    moment_dtype=moments, device=device)
        step = TrainStep(base, opt, lambda a, b: base.loss(a, b),
                         device=device)
        with plain_route() if plain else contextlib.nullcontext():
            return [float(step(x, x)) for x in batches]

    legs = {}
    with opt_ins():
        for leg, policy, moments in (("default", None, "float32"),
                                     ("save_qkv_int8", "save_qkv", "int8")):
            cfg.use_recompute = policy is not None
            cfg.recompute_policy = policy
            base.train(policy is not None)
            kl, kg, kc = grads(False)
            pl, pg, pc = grads(True)
            check(sum(pc.values()) == 0, "the plain route launched a kernel")
            r = 2 if policy else 1
            want = {"layer_norm_fwd": 2 * L * r + 1,
                    "layer_norm_bwd": 2 * L + 1,
                    "flash_packed_fwd": L * r, "flash_packed_bwd_dq": L,
                    "flash_packed_bwd_dkv": L, "flash_fwd": 0,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "linear_ce_fwd": 1}
            check(all(kc[k] == n for k, n in want.items()),
                  f"fused kernel route ({leg}) launches {kc}, want {want}")
            errs = {n: rel_err(kg[n], pg[n]) for n in kg}
            worst = max(errs, key=errs.get)
            del kg, pg
            kls, pls = trajectory(False, moments), trajectory(True, moments)
            rel = max(abs(a - b) / abs(b) for a, b in zip(kls, pls))
            legs[leg] = {"recompute_policy": policy, "moments": moments,
                         "loss": {"kernel": kl, "plain": pl,
                                  "rel_err": abs(kl - pl) / abs(pl),
                                  "tol": 1e-5},
                         "grads": {"worst_param": worst,
                                   "worst_rel_err": errs[worst],
                                   "tol": 1e-3},
                         "launches": {k: kc[k] for k in want},
                         "trajectory": {"kernel_losses": kls,
                                        "plain_losses": pls,
                                        "max_rel_err": rel, "tol": 1e-4}}
            check(legs[leg]["loss"]["rel_err"] <= 1e-5
                  and errs[worst] <= 1e-3 and rel <= 1e-4,
                  f"fused train parity ({leg}): loss, grads or trajectory "
                  f"differ: {legs[leg]}")
    out["legs"] = legs
    out["ok"] = True
    emit(out)
    del base
    torch.cuda.empty_cache()


def phase_train_gpt27(torch, card, device):
    """_bench_gpt27's configuration (bench.py:1061-1066) at full width:
    gpt3-2.7b (32 layers, hidden 2560, 32 heads of 80), bf16 parameters,
    B=6, S=1024, recompute_policy="save_qkv", AdamW(lr=1e-4, int8
    moments), model.loss, the default routes (head dim 80: #6 in every
    layer, #11 once); ids from np.random.RandomState(0), labels = ids. 2
    warm steps, then the best of 2 windows of 6 (bench: iters=6), then
    one profiled step.
    Launches per step as derived from the code: #6's forward twice a
    layer (the forward, and the second region of save_qkv rerunning the
    attention in the backward), its dQ and dK/dV passes once, #11 once,
    no #7 or #8. MFU is bench's: 6 N + 12 L H S FLOPs a token, the
    recomputed forward not counted. Learning is checked on one batch
    repeated 12 times (at this width and lr its loss overshoots up and
    down for the first half dozen steps before it falls); then one step
    of the same model without recompute gives the peak memory recompute
    saves."""
    import math
    import numpy as np
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep, gpt_config
    B_, S_, N = 6, 1024, 6
    cfg = gpt_config("gpt3-2.7b", max_position_embeddings=S_,
                     use_recompute=True, recompute_policy="save_qkv")
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="int8", device=device)
    step = TrainStep(model, opt, lambda a, b: model.loss(a, b),
                     device=device)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (N + 2, B_, S_)).astype(np.int64)).to(device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (ids[i], ids[i]), N)
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "linear_ce_fwd": 1, "layer_norm_fwd": 0, "layer_norm_bwd": 0,
            "flash_packed_fwd": 0, "flash_packed_bwd_dq": 0,
            "flash_packed_bwd_dkv": 0}
    per_step = {k: counts[k] / (2 * N) for k in want}
    check(per_step == want, f"gpt3-2.7b launches per step {per_step}, "
                            f"want {want}")
    best = min(windows)
    n_params = sum(p.numel() for p in model.parameters())
    per_token = 6 * n_params + 12 * L * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a gpt3-2.7b training loss is not finite")
    check(abs(warm[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first gpt3-2.7b loss {warm[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size)}")
    prof = profile_call(torch, lambda: step(ids[2], ids[2]),
                        names=("fwd_wg", "dq_wg", "dkv_wg", "lce_wg",
                               "lce_merge"))
    same = [float(step(ids[0], ids[0])) for _ in range(12)]
    check(same[-1] < same[0],
          f"the gpt3-2.7b loss on a repeated batch did not fall: {same}")
    state = {k: st["moment1_q"].dtype for k, st in
             zip(step._param_names[:1], step._opt_state[:1])}
    cfg.use_recompute = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain_loss = float(step(ids[1], ids[1]))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    peak_plain = torch.cuda.max_memory_allocated()
    check(peak < peak_plain, f"recompute's peak {peak} is not below the "
                             f"peak without it {peak_plain}")
    emit({"phase": "train_gpt3_2.7b", "ok": True, "card": card,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {"B": B_, "S": S_, "max_position_embeddings": S_,
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=int8)",
                     "loss": "model.loss (fused LM head)",
                     "recompute": "save_qkv", "grad_accum_steps": 1,
                     "ids": "np.random.RandomState(0), labels = ids",
                     "timing": "2 warm steps, best of 2 windows of 6"},
          "params": n_params, "tokens_per_s": tok_s,
          "ms_per_step": best / N * 1e3, "window_s": windows,
          "flops_per_token": per_token,
          "mfu": per_token * tok_s / TENSOR_FLOPS_PER_S,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet); "
                      "the recomputed forward not counted",
          "peak_mem_bytes": peak, "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same, "launches_per_step": per_step,
          "profile_step": prof,
          "moment_state": {k: str(v) for k, v in state.items()},
          "no_recompute_step": {"peak_mem_bytes": peak_plain,
                                "seconds": plain_s, "loss": plain_loss}})
    del step, opt, model
    torch.cuda.empty_cache()
    return counts


def phase_encoder_parity(torch, device, card):
    """BERT and ViT training, kernel route against plain route, at
    bert-base and vit-l16 widths cut to 2 layers in f32, in train() mode:
    hidden and attention dropout draw from the model's generator, reseeded
    before each route, so both routes drop the same entries. The loss and
    every parameter gradient: BERT's MLM loss (B=4, S=512: #9 with
    dropout, #11 over V=30522) unpadded and through seq_lens, and ViT's
    cross-entropy (B=4, 224^2: S=197)."""
    import numpy as np
    import torch.nn.functional as F
    from paddle_tpu_torch import (BertForMaskedLM, VisionTransformer,
                                  bert_config, vit_config)
    out = {"phase": "encoder_train_parity", "card": card}

    def compare(model, loss_fn, want):
        return compare_routes(torch, model, loss_fn, want, torch.float32,
                              "encoder parity")[0]

    cfg = bert_config("bert-base", num_layers=2)
    model = BertForMaskedLM(cfg, device=device, dtype=torch.float32, seed=1)
    model.train()
    rng = np.random.RandomState(41)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 512))).to(
        device)
    lbl = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 512))).to(
        device)
    lbl[torch.from_numpy(rng.rand(4, 512) > 0.15).to(device)] = -100
    lens = torch.tensor([512, 300, 77, 1], device=device)
    padded = lbl.clone()
    padded[torch.arange(512, device=device)[None] >= lens[:, None]] = -100
    want = {"fused_mha_fwd": 2, "fused_mha_bwd": 2, "linear_ce_fwd": 1}
    out["bert"] = {"model": cfg_line(cfg, "float32"), "B": 4, "S": 512,
                   "dropout": [cfg.hidden_dropout, cfg.attention_dropout]}
    out["bert"]["mlm"] = compare(model, lambda: model.loss(ids, lbl), want)
    out["bert"]["seq_lens"] = compare(
        model, lambda: model.loss(ids, padded, seq_lens=lens), want)
    del model
    vcfg = vit_config("vit-l16", num_layers=2)
    vit = VisionTransformer(vcfg, device=device, dtype=torch.float32, seed=1)
    vit.train()
    g = torch.Generator(device=device).manual_seed(42)
    img = torch.randn(4, 3, 224, 224, generator=g, device=device)
    y = torch.randint(0, vcfg.num_classes, (4,), generator=g, device=device)
    out["vit"] = {"model": cfg_line_vit(vcfg, "float32"), "B": 4,
                  **compare(vit, lambda: F.cross_entropy(vit(img), y),
                            {"fused_mha_fwd": 2, "fused_mha_bwd": 2})}
    del vit
    out["ok"] = True
    emit(out)
    torch.cuda.empty_cache()


def cfg_line_vit(cfg, dtype):
    return {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "image": cfg.image_size,
            "patch": cfg.patch_size, "seq": cfg.num_patches + 1,
            "classes": cfg.num_classes, "dtype": dtype}


def timed_steps(torch, step, batches, n):
    """2 warm steps, then the best of 2 windows of n steps on fresh
    batches (batch i of `batches` for step i); returns (warm losses, the
    last window's losses, window seconds, launches counted over both
    windows, peak memory of the windows)."""
    from paddle_tpu_torch.ops.cuda import build as KB
    warm = [float(step(*batches(i))) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launch_counts()
    windows, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        ls = [step(*batches(2 + i)) for i in range(n)]
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        losses = [float(x) for x in ls]
    return (warm, losses, windows, dict(KB.LAUNCHES),
            torch.cuda.max_memory_allocated())


def phase_train_bert(torch, card, device):
    """bench_bert's configuration at full width: bert-base (12 layers,
    H=768, vocab 30522), bf16 parameters, B=32, S=512, hidden and
    attention dropout 0.1 in train() mode, AdamW(lr=1e-4, bf16 moments),
    model.loss(ids, labels, chunk_size=256) (#9 with in-kernel dropout in
    every layer, #11 over the tied MLM head); ids and labels drawn
    independently from np.random.RandomState(0), as bench_bert draws them.
    2 warm steps, then the best of 2 windows of 10 (bench: one window of
    8), then one profiled step. Random labels cannot be learnt in 22
    steps, so learning is checked on one batch repeated 6 more times with
    the ids as labels: its loss must fall."""
    import math
    import numpy as np
    from paddle_tpu_torch import AdamW, BertForMaskedLM, TrainStep, \
        bert_config
    B_, S_, N = 32, 512, 10
    cfg = bert_config("bert-base", max_position_embeddings=S_)
    model = BertForMaskedLM(cfg, device=device, dtype=torch.bfloat16,
                            seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt,
                     lambda a, b: model.loss(a, b, chunk_size=256),
                     device=device)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (N + 2, B_, S_))).to(device)
    lbl = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (N + 2, B_, S_))).to(device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (ids[i], lbl[i]), N)
    per_step = {k: counts[k] / (2 * N) for k in
                ("fused_mha_fwd", "fused_mha_bwd", "linear_ce_fwd")}
    want = {"fused_mha_fwd": cfg.num_layers,
            "fused_mha_bwd": cfg.num_layers, "linear_ce_fwd": 1}
    check(per_step == want, f"bert launches per step {per_step}, want "
                            f"{want}")
    best = min(windows)
    n_params = sum(p.numel() for p in model.parameters())
    per_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a BERT training loss is not finite")
    check(abs(warm[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first BERT loss {warm[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size)}")
    prof = profile_call(torch, lambda: step(ids[2], lbl[2]),
                        names=("fwd_wg", "dq_wg", "dkv_wg", "lce_wg",
                               "lce_merge"))
    same = [float(step(ids[0], ids[0])) for _ in range(6)]
    check(same[-1] < same[0],
          f"the BERT loss on a repeated batch did not fall: {same}")
    emit({"phase": "train_bert-base", "ok": True, "card": card,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {"B": B_, "S": S_, "dropout": [cfg.hidden_dropout,
                                                   cfg.attention_dropout],
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                     "loss": "model.loss(ids, labels, chunk_size=256)",
                     "ids": "np.random.RandomState(0): ids, then labels",
                     "timing": "2 warm steps, best of 2 windows of 10"},
          "params": n_params, "tokens_per_s": tok_s,
          "ms_per_step": best / N * 1e3, "window_s": windows,
          "flops_per_token": per_token,
          "mfu": per_token * tok_s / TENSOR_FLOPS_PER_S,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "peak_mem_bytes": peak, "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same, "launches_per_step": per_step,
          "profile_step": prof})
    del step, opt, model
    torch.cuda.empty_cache()
    return counts


def phase_train_vit(torch, card, device):
    """bench_vit's configuration at full width: vit-l16 (24 layers,
    H=1024, 16 heads) at 224^2 (S=197), 1000 classes, bf16 parameters,
    B=64, AdamW(lr=1e-4, bf16 moments), cross-entropy of the logits (#9
    in every layer); images N(0, 1) and labels drawn on the device from a
    seeded generator (bench: numpy). 2 warm steps, then the best of 2
    windows of 10 (bench: one window of 8), then one profiled step;
    learning is checked on one batch repeated 6 more times."""
    import math
    import torch.nn.functional as F
    from paddle_tpu_torch import AdamW, TrainStep, VisionTransformer, \
        vit_config
    B_, N = 64, 10
    cfg = vit_config("vit-l16", image_size=224, num_classes=1000)
    model = VisionTransformer(cfg, device=device, dtype=torch.bfloat16,
                              seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt,
                     lambda x, y: F.cross_entropy(model(x).float(), y),
                     device=device)
    g = torch.Generator(device=device).manual_seed(0)
    imgs = torch.randn(N + 2, B_, 3, 224, 224, generator=g,
                       device=device).to(torch.bfloat16)
    lbl = torch.randint(0, cfg.num_classes, (N + 2, B_), generator=g,
                        device=device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (imgs[i], lbl[i]), N)
    per_step = {k: counts[k] / (2 * N) for k in
                ("fused_mha_fwd", "fused_mha_bwd")}
    want = {"fused_mha_fwd": cfg.num_layers, "fused_mha_bwd": cfg.num_layers}
    check(per_step == want, f"vit launches per step {per_step}, want {want}")
    best = min(windows)
    n_params = sum(p.numel() for p in model.parameters())
    seq = cfg.num_patches + 1
    per_image = (6 * n_params * seq
                 + 12 * cfg.num_layers * cfg.hidden_size * seq * seq)
    img_s = B_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a ViT training loss is not finite")
    check(abs(warm[0] - math.log(cfg.num_classes)) < 2.0,
          f"first ViT loss {warm[0]} is not near ln(classes) "
          f"{math.log(cfg.num_classes)}")
    prof = profile_call(torch, lambda: step(imgs[2], lbl[2]),
                        names=("fwd_wg", "dq_wg", "dkv_wg"))
    same = [float(step(imgs[0], lbl[0])) for _ in range(6)]
    check(same[-1] < same[0],
          f"the ViT loss on a repeated batch did not fall: {same}")
    emit({"phase": "train_vit-l16", "ok": True, "card": card,
          "model": cfg_line_vit(cfg, "bfloat16"),
          "config": {"B": B_, "optimizer": "AdamW(lr=1e-4, "
                     "moment_dtype=bfloat16)",
                     "loss": "F.cross_entropy(model(x).float(), y)",
                     "data": "torch.Generator(seed 0) on the device",
                     "timing": "2 warm steps, best of 2 windows of 10"},
          "params": n_params, "images_per_s": img_s,
          "ms_per_step": best / N * 1e3, "window_s": windows,
          "flops_per_image": per_image,
          "mfu": per_image * img_s / TENSOR_FLOPS_PER_S,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "peak_mem_bytes": peak, "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same, "launches_per_step": per_step,
          "profile_step": prof})
    del step, opt, model, imgs
    torch.cuda.empty_cache()
    return counts


# kernel #10 cases: (name, sequences, S, nh, hd, R, dtype, stage map). The
# first four are swin-t's four stages at bench_swin's B=32, 224^2 (the
# grouped sequences of one block, with the model's own bias: the static
# block-diagonal plan with the shifted-window masks plus a tiled random
# relative-position table); then swin-b's stage 4 (nh=32) and f32 cases at
# the JAX tests' shapes with a dense random bias, one at head dim 8
FMB_CASES = [
    ("swin-t_s1", 256, 392, 3, 32, 8, "bfloat16", 56),
    ("swin-t_s2", 64, 392, 6, 32, 2, "bfloat16", 28),
    ("swin-t_s3", 32, 196, 12, 32, 1, "bfloat16", 14),
    ("swin-t_s4", 8, 196, 24, 32, 1, "bfloat16", 7),
    ("swin-b_s4", 8, 196, 32, 32, 1, "bfloat16", 7),
    ("f32_a", 4, 96, 4, 32, 2, "float32", None),
    ("f32_b", 4, 96, 3, 32, 1, "float32", None),
    ("f32_c", 4, 64, 2, 64, 4, "float32", None),
    ("f32_hd8", 4, 64, 2, 8, 2, "float32", None),
    ("f32_s1", 16, 392, 3, 32, 8, "float32", 56)]
# limits on row_err of out, dq, dk, dv and d(bias) each, as for #6 and #9
FMB_TOL = {"bfloat16": 0.1, "float32": 1e-4}
FMB_LINE = "swin-t_s1"                 # the case the kernels line reports
FMB_TIMED = ("swin-t_s1", "swin-t_s2", "swin-t_s3", "swin-t_s4")
# the control: the bias with one off-diagonal window block (query window
# 0, key window 1 of period 0) zeroed, so two windows see each other
FMB_CONTROL = "swin-t_s1"
# the scattered case, at that case's shapes: a bias of -1e9 but for three
# entries a row, two in the row's own 64-key tile and one three tiles on,
# so the live blocks are no window layout (a plan that assumed contiguous
# windows would drop the far one); the kernels must agree with the plain
# versions on it
FMB_SCATTER = "swin-t_s1"


def fmb_scattered_bias(torch, device, r_n, nh, s):
    """FMB_SCATTER's bias [r_n, nh, s, s]: -1e9 but for three N(0, 0.25)
    entries a row, at columns 64 qt + (13 i + 29 j) mod 64 (j = 0, 1) and
    64 ((qt + 3) mod nt) + (7 i) mod 64, clipped to the sequence."""
    g = torch.Generator(device=device).manual_seed(26)
    nt = -(-s // 64)
    bias = torch.full((r_n, nh, s, s), -1e9, device=device)
    i = torch.arange(s, device=device)
    qt = i // 64
    cols = [qt * 64 + (13 * i + 29 * j) % 64 for j in (0, 1)]
    cols.append(((qt + 3) % nt) * 64 + (7 * i) % 64)
    for c in cols:
        c = c.clamp_max(s - 1)
        vals = torch.randn(r_n, nh, s, generator=g, device=device) * 0.5
        bias[:, :, i, c] = vals
    return bias.contiguous()


def fmb_inputs(torch, device, case):
    """qkv, dout, and the bias: for a swin stage the model's own bias (the
    static plan of a shifted block, or of the unshifted whole-map window at
    stage 4, plus a random table tiled), else N(0, 0.25) dense."""
    from paddle_tpu_torch.vision.models import swin as TS
    name, b, s, nh, hd, r_n, dt, hw = case
    g = torch.Generator(device=device).manual_seed(25)
    dtype = getattr(torch, dt)
    qkv = torch.randn(b, s, 3 * nh * hd, generator=g, device=device)
    dout = torch.randn(b, s, nh * hd, generator=g, device=device)
    if hw is None:
        bias = torch.randn(r_n, nh, s, s, generator=g, device=device) * 0.5
    else:
        attn = TS.WindowAttention(nh * hd, nh, 7, device=device)
        with torch.no_grad():
            attn.rel_bias_table.normal_(0.0, 0.5, generator=g)
        shift = 3 if hw > 7 else 0
        mask = TS._shift_mask(hw, hw, 7, shift) if shift else None
        nw = (hw // 7) ** 2
        wg, static = attn._bias_plan(b * s // 49, nw, mask, device)
        check((wg * 49, static.shape[0]) == (s, r_n),
              f"fused_mha_bias {name}: the plan gives W_g={wg}, "
              f"R={static.shape[0]}")
        with torch.no_grad():
            bias = (static[:, None] + attn._rel_bias().repeat(1, wg, wg))
    return qkv.to(dtype), dout.to(dtype), bias.contiguous()


def fmb_errs(out, dqkv, dbias, po, pg, pb, nh, hd):
    """{tensor: (row_err, max abs error)} for out, dq, dk, dv (rows per
    (sequence, position, head)) and d(bias) (rows of [R, nh, S, S])."""
    b, s = out.shape[:2]
    f = nh * hd
    ks = [out] + [dqkv[..., i * f:(i + 1) * f] for i in range(3)]
    ps = [po] + [pg[..., i * f:(i + 1) * f] for i in range(3)]
    errs = {n: (row_err(a.reshape(b, s, nh, hd), c.reshape(b, s, nh, hd)),
                float((a.float() - c.float()).abs().max()))
            for n, a, c in zip(("out", "dq", "dk", "dv"), ks, ps)}
    errs["dbias"] = (row_err(dbias, pb),
                     float((dbias - pb).abs().max()))
    return errs


def fmb_run(KMB, qkv, bias, dout, nh):
    """#10's forward and backward entry points on one input: (out,
    d(qkv), d(bias), the bf16 plan or None)."""
    out, ml, plan = KMB.fused_mha_bias_fwd_cuda(qkv, bias, nh)
    dqkv, dbias = KMB.fused_mha_bias_bwd_cuda(qkv, bias, dout, ml, plan, nh)
    return out, dqkv, dbias, plan


def phase_fused_mha_bias(torch, device, card):
    """Kernel #10 against its plain versions, forward and backward with
    d(bias), per row and per tensor (out, dq, dk, dv, d(bias)) at every
    case; two launches of each entry point bitwise equal; in bf16 the
    kernels' live-block plan equal to the plain `fused_mha_bias_plan` of
    the same bias, its live fraction printed on a line of its own before
    the phase's; two controls that the limits must reject (the forward and
    the backward given a bias with one off-diagonal window block zeroed);
    a bias whose live entries are scattered (FMB_SCATTER) on which the
    kernels must agree with the plain versions; at swin-t's four stages
    the times of the kernels, the plain versions, the yardstick
    F.scaled_dot_product_attention with the bias as its float mask on the
    [B, nh, S, hd] views (never on the path), forward and backward, and
    SDPA per window ([B * W_g, nh, 49, hd], the same result at 1 / W_g of
    the work)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_mha_bias as FMB
    from paddle_tpu_torch.ops.cuda import fused_mha_bias as KMB
    run = timer(torch, device)
    rows, kernels, times, live = [], {}, {}, {}
    for case in FMB_CASES:
        name, b, s, nh, hd, r_n, dt, hw = case
        qkv, dout, bias = fmb_inputs(torch, device, case)
        out, dqkv, dbias, plan = fmb_run(KMB, qkv, bias, dout, nh)
        out2, dqkv2, dbias2, _ = fmb_run(KMB, qkv, bias, dout, nh)
        po = FMB.fused_mha_bias_reference(qkv, bias, nh)
        pg, pb = FMB.fused_mha_bias_bwd_reference(qkv, bias, dout, nh)
        torch.cuda.synchronize()
        tol = FMB_TOL[dt]
        errs = fmb_errs(out, dqkv, dbias, po, pg, pb, nh, hd)
        row = {"case": name, "sequences": b, "S": s, "nh": nh, "hd": hd,
               "R": r_n, "dtype": dt, "bias": "swin plan, stage map "
               f"{hw}x{hw}" if hw else "dense N(0, 0.25)", "tol": tol,
               "row_err": {n: e[0] for n, e in errs.items()},
               "max_abs_err": {n: e[1] for n, e in errs.items()}}
        finite = all(bool(torch.isfinite(x.float()).all())
                     for x in (out, dqkv, dbias))
        check(finite and max(e[0] for e in errs.values()) <= tol,
              f"fused_mha_bias {name}: kernel disagrees with its plain "
              f"version: {row}")
        row["bitwise_repeat"] = bool(
            torch.equal(out, out2) and torch.equal(dqkv, dqkv2)
            and torch.equal(dbias, dbias2))
        check(row["bitwise_repeat"],
              f"fused_mha_bias {name}: two launches differ")
        del out2, dqkv2, dbias2
        if plan is not None:
            check(torch.equal(plan, FMB.fused_mha_bias_plan(bias)),
                  f"fused_mha_bias {name}: the kernels' plan differs from "
                  f"fused_mha_bias_plan of the same bias")
            live[name] = float(plan.float().mean())
            row["live_fraction"] = live[name]
        if name == FMB_CONTROL:
            bad = bias.clone()
            bad[0, :, :49, 49:98] = 0.0
            co, cg, cb, _ = fmb_run(KMB, qkv, bad, dout, nh)
            cerr = fmb_errs(co, cg, cb, po, pg, pb, nh, hd)
            ctl = {"what": "kernel given the bias with the block (query "
                           "window 0, key window 1) of period 0 zeroed, vs "
                           "plain on the true bias",
                   "forward_row_err": cerr["out"][0],
                   "backward_dbias_row_err": cerr["dbias"][0]}
            check(ctl["forward_row_err"] > tol
                  and ctl["backward_dbias_row_err"] > tol,
                  f"fused_mha_bias {name}: the limit passes a kernel whose "
                  f"windows see each other: {ctl}")
            row["control"] = dict(ctl, rejected=True)
            del bad, co, cg, cb
        if name == FMB_SCATTER:
            sb = fmb_scattered_bias(torch, device, r_n, nh, s)
            so, sg, sbg, splan = fmb_run(KMB, qkv, sb, dout, nh)
            spo = FMB.fused_mha_bias_reference(qkv, sb, nh)
            spg, spb = FMB.fused_mha_bias_bwd_reference(qkv, sb, dout, nh)
            serr = fmb_errs(so, sg, sbg, spo, spg, spb, nh, hd)
            sc = {"what": "bias -1e9 but for three scattered entries a row "
                          "(two in the row's own 64-key tile, one three "
                          "tiles on)",
                  "live_fraction": float(splan.float().mean()),
                  "plan_equal": bool(torch.equal(
                      splan, FMB.fused_mha_bias_plan(sb))),
                  "row_err": {n: e[0] for n, e in serr.items()}}
            check(sc["plan_equal"] and max(sc["row_err"].values()) <= tol,
                  f"fused_mha_bias {name}: the kernels disagree with the "
                  f"plain versions on scattered live entries: {sc}")
            row["scattered"] = dict(sc, agrees=True)
            del sb, so, sg, sbg, spo, spg, spb
        if name in FMB_TIMED:
            t = fmb_times(torch, F, FMB, KMB, run, case, qkv, dout, bias,
                          live.get(name, 1.0))
            times[name] = t
            if name == FMB_LINE:
                for kname, err in (("fused_mha_bias_fwd", errs["out"][1]),
                                   ("fused_mha_bias_bwd", max(
                                       errs[n][1] for n in
                                       ("dq", "dk", "dv", "dbias")))):
                    kernels[kname] = dict(t[kname], max_abs_err=err)
        rows.append(row)
        del qkv, dout, bias, out, dqkv, dbias, po, pg, pb, plan
        torch.cuda.empty_cache()
    emit({"phase": "fused_mha_bias_plan", "card": card,
          "what": "share of the (64-row, 64-key) blocks of each bf16 case's "
                  "bias the kernels visit (their plan, equal to "
                  "fused_mha_bias_plan)", "live_fraction": live})
    emit({"phase": "fused_mha_bias_vs_plain", "ok": True, "card": card,
          "error": "row_err: per row max |kernel - plain| over the row's "
                   "rms of plain (floored at 10% of the tensor's rms), "
                   "worst row; rows of out, dq, dk, dv per (sequence, "
                   "position, head), of d(bias) per (r, head, query); "
                   "plain: fused_mha_bias_reference and "
                   "fused_mha_bias_bwd_reference on the same inputs",
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "times": times})
    return kernels


def fmb_times(torch, F, FMB, KMB, run, case, qkv, dout, bias, live):
    """Times and bounds of the forward and the backward at one case, and
    the two SDPA yardsticks. `live`: the plan's live share of the blocks,
    which scales the products the bound counts."""
    name, b, s, nh, hd, r_n, dt, hw = case
    f, n, wg = nh * hd, 49, s // 49
    x = qkv.detach().requires_grad_()
    views = x.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    mask = bias.repeat(b // r_n, 1, 1, 1).to(qkv.dtype).requires_grad_()
    lout = F.scaled_dot_product_attention(*views, attn_mask=mask)
    douth = dout.view(b, s, nh, hd).transpose(1, 2)
    try:
        torch.autograd.grad(lout, (x, mask), douth, retain_graph=True)
        lib_grads, into = (x, mask), "qkv and the mask"
    except RuntimeError:
        lib_grads, into = (x,), "qkv (no gradient into a float mask here)"
    # per window: the diagonal blocks of the bias as [B * W_g, nh, 49, 49]
    blocks = torch.stack([bias[:, :, w * n:(w + 1) * n, w * n:(w + 1) * n]
                          for w in range(wg)], dim=1)   # [R, wg, nh, n, n]
    wmask = blocks.repeat(b // r_n, 1, 1, 1, 1).reshape(
        b * wg, nh, n, n).to(qkv.dtype)
    wviews = x.view(b * wg, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    wout = F.scaled_dot_product_attention(*wviews, attn_mask=wmask)
    wdout = dout.view(b * wg, n, nh, hd).transpose(1, 2)
    _, ml, plan = KMB.fused_mha_bias_fwd_cuda(qkv, bias, nh)
    t = {"fwd_ms": run(lambda: KMB.fused_mha_bias_fwd_cuda(qkv, bias, nh)),
         "bwd_ms": run(lambda: KMB.fused_mha_bias_bwd_cuda(
             qkv, bias, dout, ml, plan, nh)),
         "plain_fwd_ms": run(lambda: FMB.fused_mha_bias_reference(
             qkv, bias, nh)),
         "plain_bwd_ms": run(lambda: FMB.fused_mha_bias_bwd_reference(
             qkv, bias, dout, nh)),
         "library_fwd_ms": run(lambda: F.scaled_dot_product_attention(
             *views, attn_mask=mask)),
         "library_bwd_ms": run(lambda: torch.autograd.grad(
             lout, lib_grads, douth, retain_graph=True)),
         "library": "F.scaled_dot_product_attention on the [B, nh, S, hd] "
                    "views of qkv with the bias repeated to [B, nh, S, S] "
                    "as its float mask (qkv's dtype), forward; its backward "
                    f"into {into}",
         "per_window_fwd_ms": run(lambda: F.scaled_dot_product_attention(
             *wviews, attn_mask=wmask)),
         "per_window_bwd_ms": run(lambda: torch.autograd.grad(
             wout, x, wdout, retain_graph=True)),
         "per_window": f"SDPA on [B * W_g = {b * wg}, nh, 49, hd] with the "
                       f"diagonal bias blocks as the mask: the same result "
                       f"at 1/{wg} of the work (no d(bias))",
         "live_fraction": live}
    # the products of the blocks this bias leaves live (the kernels visit
    # those and no others)
    mm = 2 * b * nh * s * s * hd * live       # one [S, S] x hd product
    item = qkv.element_size()
    bias_b = bias.numel() * 4
    # forward: qkv and the bias read once, out written once, 2 products;
    # backward: qkv, dout and the bias read, dqkv and d(bias) written, 5
    # products (S, dP, dV, dQ, dK)
    fb = bound_of(2 * mm, (3 * f + f) * b * s * item + bias_b, qkv.dtype)
    bb = bound_of(5 * mm, (3 * f + f + 3 * f) * b * s * item + 2 * bias_b,
                  qkv.dtype)
    t["fused_mha_bias_fwd"] = {"ms": t["fwd_ms"],
                               "plain_ms": t["plain_fwd_ms"],
                               "library_ms": t["library_fwd_ms"],
                               "bound_ms": fb[0], "bound_by": fb[1]}
    t["fused_mha_bias_bwd"] = {"ms": t["bwd_ms"],
                               "plain_ms": t["plain_bwd_ms"],
                               "library_ms": t["library_bwd_ms"],
                               "bound_ms": bb[0], "bound_by": bb[1]}
    del lout, views, x, mask, wout, wviews, wmask, ml, plan
    return t


def phase_swin_parity(torch, device, card):
    """Swin training, kernel route against plain route, at swin-t's full
    width (224^2, embed 96, heads 3/6/12/24, window 7) cut to depths
    (2, 2, 2, 2) in f32, B=4: the cross-entropy loss and every parameter
    gradient, each relative-position table's included (its gradient flows
    only through #10's d(bias)); 8 + 8 #10 launches."""
    import torch.nn.functional as F
    from paddle_tpu_torch import SwinTransformer
    from paddle_tpu_torch.ops.cuda import build as KB
    model = SwinTransformer(depths=(2, 2, 2, 2), num_classes=1000,
                            device=device, dtype=torch.float32, seed=1)
    model.train()
    g = torch.Generator(device=device).manual_seed(43)
    img = torch.randn(4, 3, 224, 224, generator=g, device=device)
    y = torch.randint(0, 1000, (4,), generator=g, device=device)

    def grads(plain):
        model.zero_grad(set_to_none=True)
        KB.reset_launch_counts()
        with plain_route() if plain else contextlib.nullcontext():
            loss = F.cross_entropy(model(img), y)
            loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                dict(KB.LAUNCHES))
    kl, kg, kc = grads(False)
    pl, pg, pc = grads(True)
    check(sum(pc.values()) == 0, "the plain route launched a kernel")
    want = {"fused_mha_bias_fwd": 8, "fused_mha_bias_bwd": 8}
    check(all(kc[k] == v for k, v in want.items()),
          f"swin kernel route launches {kc}, want {want}")
    check(set(kg) == set(pg), "the routes reach different parameters")
    errs = {n: rel_err(kg[n], pg[n]) for n in kg}
    worst = max(errs, key=errs.get)
    tables = {n: e for n, e in errs.items() if n.endswith("rel_bias_table")}
    out = {"phase": "swin_train_parity", "card": card,
           "model": {"image": 224, "embed": 96, "depths": [2, 2, 2, 2],
                     "heads": [3, 6, 12, 24], "window": 7,
                     "dtype": "float32"}, "B": 4,
           "loss": {"kernel": kl, "plain": pl,
                    "rel_err": abs(kl - pl) / abs(pl), "tol": 1e-5},
           "grads": {"params": len(errs), "worst_param": worst,
                     "worst_rel_err": errs[worst], "tol": 1e-3,
                     "tables": len(tables),
                     "worst_table_rel_err": max(tables.values())},
           "launches": {k: kc[k] for k in want}}
    check(out["loss"]["rel_err"] <= 1e-5 and errs[worst] <= 1e-3
          and len(tables) == 8,
          f"swin parity: loss or grads differ: {out}")
    out["ok"] = True
    emit(out)
    del model, kg, pg
    torch.cuda.empty_cache()


def phase_train_swin(torch, card, device):
    """bench_swin's configuration at full width: swin-t (28.3M parameters,
    depths 2/2/6/2) at 224^2, 1000 classes, bf16 parameters, B=32,
    AdamW(lr=1e-4, bf16 moments), cross-entropy of the logits (#10 in
    every block: 12 + 12 launches a step); images N(0, 1) and labels drawn
    on the device from a seeded generator (bench: numpy). 2 warm steps,
    then the best of 2 windows of 10 (bench: one window of 8), then one
    profiled step; learning is checked on one batch repeated 6 more
    times. MFU is bench_swin's: 3 x 9.0e9 FLOPs an image over the peak."""
    import math
    import torch.nn.functional as F
    from paddle_tpu_torch import AdamW, TrainStep, swin_t
    B_, N = 32, 10
    model = swin_t(num_classes=1000, device=device, dtype=torch.bfloat16,
                   seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt,
                     lambda x, y: F.cross_entropy(model(x).float(), y),
                     device=device)
    g = torch.Generator(device=device).manual_seed(0)
    imgs = torch.randn(N + 2, B_, 3, 224, 224, generator=g,
                       device=device).to(torch.bfloat16)
    lbl = torch.randint(0, 1000, (N + 2, B_), generator=g, device=device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (imgs[i], lbl[i]), N)
    per_step = {k: counts[k] / (2 * N) for k in
                ("fused_mha_bias_fwd", "fused_mha_bias_bwd")}
    want = {"fused_mha_bias_fwd": 12, "fused_mha_bias_bwd": 12}
    check(per_step == want, f"swin launches per step {per_step}, want "
                            f"{want}")
    best = min(windows)
    n_params = sum(p.numel() for p in model.parameters())
    img_s = B_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a Swin training loss is not finite")
    check(abs(warm[0] - math.log(1000)) < 2.0,
          f"first Swin loss {warm[0]} is not near ln(1000) "
          f"{math.log(1000)}")
    prof = profile_call(torch, lambda: step(imgs[2], lbl[2]),
                        names=("mhb_plan", "mhb_fwd", "mhb_dq", "mhb_db",
                               "mhb_dkv"))
    same = [float(step(imgs[0], lbl[0])) for _ in range(6)]
    check(same[-1] < same[0],
          f"the Swin loss on a repeated batch did not fall: {same}")
    emit({"phase": "train_swin-t", "ok": True, "card": card,
          "model": {"preset": "swin-t", "image": 224, "embed": 96,
                    "depths": [2, 2, 6, 2], "heads": [3, 6, 12, 24],
                    "window": 7, "classes": 1000, "dtype": "bfloat16"},
          "config": {"B": B_, "optimizer": "AdamW(lr=1e-4, "
                     "moment_dtype=bfloat16)",
                     "loss": "F.cross_entropy(model(x).float(), y)",
                     "data": "torch.Generator(seed 0) on the device",
                     "timing": "2 warm steps, best of 2 windows of 10"},
          "params": n_params, "images_per_s": img_s,
          "ms_per_step": best / N * 1e3, "window_s": windows,
          "flops_per_image": 3 * 9.0e9,
          "mfu": 3 * 9.0e9 * img_s / TENSOR_FLOPS_PER_S,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "peak_mem_bytes": peak, "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same, "launches_per_step": per_step,
          "profile_step": prof})
    del step, opt, model, imgs
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------ slice 7: kernel #8
# kernel #8 cases: (name, R, H): every LayerNorm input of bench_gpt's
# gpt3-1.3b step (B=3 x S=2048 rows) and of _bench_gpt27's gpt3-2.7b
# (B=6 x S=1024), bench_bert's bert-base (B=32 x S=512), bench_vit's
# vit-l16 (B=64 x 197 tokens), the first patch merge's LayerNorm of
# bench_swin's swin-t (B=32 x 28 x 28 at 4 x 96), and one row width past
# the kernels' "rows" plans (64 rows of 32768), each in bf16 and f32 and
# for the four affine cases
LN_CASES = [("gpt3-1.3b", 6144, 2048), ("gpt3-2.7b", 6144, 2560),
            ("bert-base", 16384, 768), ("vit-l16", 12608, 1024),
            ("swin-t-merge", 25088, 384), ("wide", 64, 32768)]
LN_CUT = 16    # rows the control's backward leaves out
LN_AFFINE = ("gb", "g", "b", "none")
# limits on row_err of out and dx (as for #6, #9 and #10: bf16 rounds the
# outputs, so a result one bf16 step off at 5 sigma reads ~0.03) and on
# rel_err of d(gamma), d(beta) (f32 sums over 6144 rows on both sides, in
# another order) and of mu, rsig
LN_TOL = {"bfloat16": (0.1, 1e-4), "float32": (1e-4, 1e-4)}


def ln_inputs(torch, device, r, h, dtype, seed=51):
    """x ~ N(0.3, 1) (a nonzero mean, as activations have), gamma ~ 1 +
    N(0, 0.01), beta ~ N(0, 0.01), dy ~ N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(r, h, generator=g, device=device) + 0.3
    gamma = 1 + 0.1 * torch.randn(h, generator=g, device=device)
    beta = 0.1 * torch.randn(h, generator=g, device=device)
    dy = torch.randn(r, h, generator=g, device=device)
    return tuple(t.to(dtype) for t in (x, gamma, beta, dy))


def phase_layer_norm(torch, device, card):
    """Kernel #8 against its plain versions at every case: out, mu and
    rsig of the forward; dx, d(gamma) and d(beta) of the backward from the
    kernel's own statistics; the backward bitwise equal over two launches;
    a control the limits must reject (the backward run without its first
    LN_CUT rows, so d(gamma) and d(beta) miss their terms); at every shape
    in bf16 the times of the kernels, the plain versions and F.layer_norm
    (the yardstick, never on the path), forward, backward and both, and
    the backward's two launches alone under the profiler."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import layer_norm as LN
    from paddle_tpu_torch.ops.cuda import layer_norm as KL
    run = timer(torch, device)
    rows, times, kernels = [], {}, {}
    for name, r, h in LN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).split(".")[-1]
            x, gamma, beta, dy = ln_inputs(torch, device, r, h, dtype)
            rtol, stol = LN_TOL[dt]
            for aff in LN_AFFINE:
                g = gamma if "g" in aff else None
                b = beta if "b" in aff else None
                out, mu, rs = KL.layer_norm_fwd_cuda(x, g, b, 1e-5)
                dx, dg, db = KL.layer_norm_bwd_cuda(dy, x, mu, rs, g)
                dx2, dg2, db2 = KL.layer_norm_bwd_cuda(dy, x, mu, rs, g)
                po, pmu, prs = LN.fused_layer_norm_reference(x, g, b, 1e-5)
                pdx, pdg, pdb = LN.fused_layer_norm_bwd_reference(
                    dy, x, mu, rs, g)
                torch.cuda.synchronize()
                row = {"case": name, "R": r, "H": h, "dtype": dt,
                       "affine": aff, "tol_row": rtol, "tol_sum": stol,
                       "row_err": {"out": row_err(out, po),
                                   "dx": row_err(dx, pdx)},
                       "rel_err": {"mu": rel_err(mu, pmu),
                                   "rsig": rel_err(rs, prs),
                                   "dgamma": rel_err(dg, pdg),
                                   "dbeta": rel_err(db, pdb)},
                       "max_abs_err": {
                           "out": float((out.float() - po.float()).abs()
                                        .max()),
                           "dx": float((dx.float() - pdx.float()).abs()
                                       .max()),
                           "dgamma": float((dg - pdg).abs().max()),
                           "dbeta": float((db - pdb).abs().max())},
                       "bwd_repeats_bitwise": bool(
                           torch.equal(dx, dx2) and torch.equal(dg, dg2)
                           and torch.equal(db, db2))}
                finite = all(bool(torch.isfinite(t.float()).all())
                             for t in (out, mu, rs, dx, dg, db))
                check(finite and max(row["row_err"].values()) <= rtol
                      and max(row["rel_err"].values()) <= stol
                      and row["bwd_repeats_bitwise"],
                      f"layer_norm {name} {dt} {aff}: kernel disagrees "
                      f"with its plain version: {row}")
                if dtype == torch.bfloat16 and aff == "gb":
                    cut = LN_CUT
                    _, cg, cb = KL.layer_norm_bwd_cuda(
                        dy[cut:], x[cut:], mu[cut:], rs[cut:], g)
                    ctl = {"dgamma": rel_err(cg, pdg),
                           "dbeta": rel_err(cb, pdb)}
                    check(min(ctl.values()) > stol,
                          f"layer_norm {name}: the limits pass a backward "
                          f"that drops its first {cut} rows: {ctl}")
                    row["control"] = {
                        "what": f"backward on rows {cut}.. (the first "
                                f"{cut} rows' terms dropped) vs plain",
                        "rel_err": ctl, "rejected": True}
                    t, k = ln_times(torch, F, LN, KL, run, x, g, b, dy,
                                    row)
                    times[name] = t
                    if name == LN_CASES[0][0]:
                        kernels = k
                rows.append(row)
            del x, gamma, beta, dy
            torch.cuda.empty_cache()
    emit({"phase": "layer_norm_vs_plain", "ok": True, "card": card,
          "error": "row_err: per row max |kernel - plain| over the row's "
                   "rms of plain (floored at 10% of the tensor's rms), "
                   "worst row; rel_err: max |kernel - plain| over max "
                   "|plain|; plain: fused_layer_norm_reference and "
                   "fused_layer_norm_bwd_reference on the kernel's own "
                   "mu and rsig",
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "bf16_gb_times": times})
    return kernels


def ln_times(torch, F, LN, KL, run, x, g, b, dy, row):
    """Times of #8, its plain versions and F.layer_norm at one shape;
    returns (the table, the kernels-line rows)."""
    r, h = x.shape
    item = x.element_size()
    out, mu, rs = KL.layer_norm_fwd_cuda(x, g, b, 1e-5)
    lx, lg, lb = (t.detach().requires_grad_() for t in (x, g, b))
    lout = F.layer_norm(lx, (h,), lg, lb, 1e-5)

    def kern_fb():
        xs = [t.detach().requires_grad_() for t in (x, g, b)]
        return torch.autograd.grad(LN.fused_layer_norm(*xs), xs, dy)

    def lib_fb():
        xs = [t.detach().requires_grad_() for t in (x, g, b)]
        return torch.autograd.grad(F.layer_norm(xs[0], (h,), xs[1], xs[2],
                                                1e-5), xs, dy)

    t = {"plan": KL.ln_plan(r, h, x.dtype,
                            torch.cuda.get_device_properties(x.device)
                            .multi_processor_count)._asdict(),
         "fwd_ms": run(lambda: KL.layer_norm_fwd_cuda(x, g, b, 1e-5)),
         "bwd_ms": run(lambda: KL.layer_norm_bwd_cuda(dy, x, mu, rs, g)),
         "fwd_bwd_ms": run(kern_fb),
         "plain_fwd_ms": run(lambda: LN.fused_layer_norm_reference(
             x, g, b, 1e-5)),
         "plain_bwd_ms": run(lambda: LN.fused_layer_norm_bwd_reference(
             dy, x, mu, rs, g)),
         "library_fwd_ms": run(lambda: F.layer_norm(x, (h,), g, b, 1e-5)),
         "library_bwd_ms": run(lambda: torch.autograd.grad(
             lout, (lx, lg, lb), dy, retain_graph=True)),
         "library_fwd_bwd_ms": run(lib_fb),
         "library": "F.layer_norm (two-pass variance) and its autograd "
                    "backward into x, gamma and beta"}
    # PyTorch's elementwise streams over the same bytes (a yardstick of
    # what this timer reads for them, never on the path): x copied out
    # (the forward's reads and writes), dy + x into a third tensor (the
    # backward row pass's)
    sink = torch.empty_like(x)
    t["same_bytes_copy_ms"] = run(lambda: sink.copy_(x))
    t["same_bytes_add_ms"] = run(lambda: torch.add(dy, x, out=sink))
    # the backward's row pass and partials' sum apart: mean device time of
    # each over 20 back-to-back calls under the profiler (no L2 flush)
    prof = profile_call(torch, lambda: [KL.layer_norm_bwd_cuda(
        dy, x, mu, rs, g) for _ in range(20)],
        names=("ln_bwd_rows", "ln_bwd_loop", "ln_bwd_sum"))
    t["bwd_profiled_ms"] = {
        ("sum" if "ln_bwd_sum" in o["op"] else "rows"):
            o["device_ms"] / o["count"]
        for o in prof["named_device_ops"]}
    # bytes: x read and out written (forward); dy and x read, dx written
    # (backward); gamma, beta, mu, rsig, d(gamma), d(beta) besides;
    # operations: ~7 f32 operations an element forward, ~12 backward, on
    # the CUDA cores
    fb = 2 * r * h * item + 2 * h * item + 8 * r
    bb = 3 * r * h * item + h * item + 8 * r + 8 * h
    specs = {"layer_norm_fwd": (t["fwd_ms"], t["plain_fwd_ms"],
                                t["library_fwd_ms"], 7 * r * h, fb,
                                row["max_abs_err"]["out"]),
             "layer_norm_bwd": (t["bwd_ms"], t["plain_bwd_ms"],
                                t["library_bwd_ms"], 12 * r * h, bb,
                                max(row["max_abs_err"][n] for n in
                                    ("dx", "dgamma", "dbeta")))}
    kernels = {}
    for kname, (ms, pms, lms, flops, nbytes, err) in specs.items():
        bms, by = bound_of(flops, nbytes, torch.float32)
        t[kname.split("_")[-1] + "_bound_ms"] = bms
        kernels[kname] = {"ms": ms, "plain_ms": pms, "library_ms": lms,
                          "bound_ms": bms, "bound_by": by,
                          "max_abs_err": err}
    return t, kernels


# ------------------------------------------------ slice 7: kernel #7
# kernel #7 cases: (name, B, S, nh, causal, kv_len), head dim 128 packed
# as [B, S, nh * 128] column slices of one qkv projection: gpt3-1.3b's
# training shape (bench_gpt), and a padded non-causal one through kv_len
FP_CASES = [("gpt3-1.3b", 3, 2048, 16, True, None),
            ("kv_len", 2, 640, 4, False, 600)]


def fp_grads(torch, fn, qkv, dout):
    """(out, d(qkv)) of fn(leaf qkv) under autograd."""
    x = qkv.detach().clone().requires_grad_()
    out = fn(x)
    return out.detach(), torch.autograd.grad(out, x, dout)[0]


def phase_flash_packed(torch, device, card):
    """Kernel #7 (#6's kernels on the packed layout) against its plain
    versions, against #6 on the same data (equal: the same arithmetic) and
    through its two entry points (one packed qkv with one d(qkv), GPT's
    route; three column slices, whose gradients autograd sums into qkv),
    in bf16 and f32; the controls of #6's check (the last 64 keys dropped);
    at gpt3-1.3b's training shape in bf16 the times of the kernels, the
    plain versions, #6 and F.scaled_dot_product_attention on [B, nh, S,
    hd] views of the same qkv (the yardstick, never on the path), forward,
    backward into qkv and both."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import flash_attention as KF
    run = timer(torch, device)
    rows, timed = [], None
    for case in FP_CASES:
        name, b, s, nh, causal, kv_len = case
        h = nh * 128
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).split(".")[-1]
            g = torch.Generator(device=device).manual_seed(23)
            qkv = torch.randn(b, s, 3 * h, generator=g,
                              device=device).to(dtype)
            dout = torch.randn(b, s, h, generator=g, device=device).to(dtype)

            def slices(x, cut=kv_len):
                return FA.flash_attention_packed(*x.chunk(3, -1), nh,
                                                 causal=causal, kv_len=cut)

            def six(x):
                q, k, v = x.unflatten(-1, (3, nh, 128)).unbind(2)
                return FA.flash_attention(q, k, v, causal=causal,
                                          kv_len=kv_len).flatten(2)
            if kv_len is None:
                ko, kg = fp_grads(torch, lambda x: (
                    FA.flash_attention_packed_qkv(x, nh, causal=causal)),
                    qkv, dout)
            else:
                ko, kg = fp_grads(torch, slices, qkv, dout)
            so, sg = fp_grads(torch, slices, qkv, dout)
            xo, xg = fp_grads(torch, six, qkv, dout)
            q, k, v = qkv.chunk(3, -1)
            ko2, klse = KF.flash_packed_fwd_cuda(
                q, k, v, nh, causal=causal, scale=128 ** -0.5, kv_len=kv_len)
            po, plse = FA.flash_packed_forward_reference(
                q, k, v, nh, causal, kv_len=kv_len)
            pg = torch.cat(FA.flash_packed_bwd_reference(
                q, k, v, ko, klse, dout, nh, causal, kv_len=kv_len), -1)
            torch.cuda.synchronize()
            errs = flash_errs(ko.unflatten(-1, (nh, 128)),
                              [t.unflatten(-1, (nh, 128))
                               for t in kg.chunk(3, -1)],
                              po.unflatten(-1, (nh, 128)),
                              [t.unflatten(-1, (nh, 128))
                               for t in pg.chunk(3, -1)])
            otol, gtol, ltol = FLASH_TOL[dt]   # #6's kernels, its limits
            row = {"case": name, "B": b, "S": s, "nh": nh, "hd": 128,
                   "causal": causal, "kv_len": kv_len, "dtype": dt,
                   "entry": "flash_attention_packed_qkv" if kv_len is None
                            else "flash_attention_packed",
                   "tol_out": otol, "tol_grad": gtol, "tol_lse": ltol,
                   "row_err": {n: e[0] for n, e in errs.items()},
                   "max_abs_err": {n: e[1] for n, e in errs.items()},
                   "lse_max_abs_err": float((klse - plse).abs().max()),
                   "forward_repeats_bitwise": bool(torch.equal(ko, ko2)),
                   "equal_to_slices": bool(torch.equal(ko, so)
                                           and torch.equal(kg, sg)),
                   "equal_to_6": bool(torch.equal(ko, xo)
                                      and torch.equal(kg, xg))}
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in (ko, kg, klse))
            check(finite and errs["out"][0] <= otol
                  and max(errs[n][0] for n in ("dq", "dk", "dv")) <= gtol
                  and row["lse_max_abs_err"] <= ltol
                  and row["forward_repeats_bitwise"]
                  and row["equal_to_slices"] and row["equal_to_6"],
                  f"packed flash attention {name} {dt}: kernel disagrees "
                  f"with its plain version or with #6: {row}")
            if dtype == torch.bfloat16:
                cut = (kv_len or s) - 64
                co, cg = fp_grads(torch, lambda x: slices(x, cut), qkv, dout)
                cerr = {n: e[0] for n, e in flash_errs(
                    co.unflatten(-1, (nh, 128)),
                    [t.unflatten(-1, (nh, 128)) for t in cg.chunk(3, -1)],
                    po.unflatten(-1, (nh, 128)),
                    [t.unflatten(-1, (nh, 128))
                     for t in pg.chunk(3, -1)]).items()}
                check(cerr["out"] > otol and min(
                    cerr[n] for n in ("dq", "dk", "dv")) > gtol,
                    f"packed flash attention {name}: the limits pass a "
                    f"kernel that drops its last 64 keys: {cerr}")
                row["control"] = {"what": f"kernel with kv_len={cut} (last "
                                          f"64 keys dropped) vs plain",
                                  "row_err": cerr, "rejected": True}
            rows.append(row)
            if name == "gpt3-1.3b" and dtype == torch.bfloat16:
                timed = (case, qkv, dout, row)
            del ko, kg, so, sg, xo, xg, po, pg, ko2, klse, plse
            torch.cuda.empty_cache()
    line = fp_times(torch, F, FA, KF, run, *timed)
    del timed
    emit({"phase": "flash_packed_vs_plain", "ok": True, "card": card,
          "error": "row_err per (b, s, head) row as for #6; plain: "
                   "flash_packed_forward_reference and "
                   "flash_packed_bwd_reference on the kernels' own out and "
                   "lse; equal_to_6: out and d(qkv) bitwise equal to #6 "
                   "on the [B, S, 3, nh, 128] views of the same qkv",
          "timing": "median of 50 launches, CUDA events, L2 flushed",
          "cases": rows, "gpt3-1.3b_bf16_times": line["times"]})
    return line["kernels"]


def fp_times(torch, F, FA, KF, run, case, qkv, dout, row):
    """Times at gpt3-1.3b's shape; returns the kernels-line rows and the
    table."""
    name, b, s, nh, causal, _ = case
    dtype = qkv.dtype
    scale = 128 ** -0.5
    kw = dict(causal=causal, scale=scale)
    q, k, v = qkv.chunk(3, -1)
    q4, k4, v4, dout4 = (t.unflatten(-1, (nh, 128))
                         for t in (q, k, v, dout))
    out, lse = KF.flash_packed_fwd_cuda(q, k, v, nh, **kw)
    delta = KF.flash_delta(out.unflatten(-1, (nh, 128)), dout4)
    dqkv = torch.empty_like(qkv)
    dq4, dk4, dv4 = (t.unflatten(-1, (nh, 128)) for t in dqkv.chunk(3, -1))
    args = (q4, k4, v4, dout4, lse, delta, causal, scale, None)

    def heads_major(x):       # [B, nh, S, hd] views of qkv for SDPA
        return [t.unflatten(-1, (nh, 128)).transpose(1, 2)
                for t in x.chunk(3, -1)]
    lx = qkv.detach().requires_grad_()
    lout = F.scaled_dot_product_attention(*heads_major(lx),
                                          is_causal=causal)
    douth = dout4.transpose(1, 2)

    def fb(fn):
        def go():
            x = qkv.detach().requires_grad_()
            return torch.autograd.grad(fn(x), x, dout)
        return go

    def six(x):
        q_, k_, v_ = x.unflatten(-1, (3, nh, 128)).unbind(2)
        return FA.flash_attention(q_, k_, v_, causal=causal).flatten(2)

    def lib_fb():
        x = qkv.detach().requires_grad_()
        return torch.autograd.grad(F.scaled_dot_product_attention(
            *heads_major(x), is_causal=causal), x, douth)

    t = {"fwd_ms": run(lambda: KF.flash_packed_fwd_cuda(q, k, v, nh, **kw)),
         "dq_ms": run(lambda: KF._bwd_dq(*args, dq4, "flash_packed_bwd_dq")),
         "dkv_ms": run(lambda: KF._bwd_dkv(*args, dk4, dv4,
                                           "flash_packed_bwd_dkv")),
         "bwd_ms": run(lambda: KF.flash_packed_bwd_cuda(
             q, k, v, out, lse, dout, nh, **kw)),
         "fwd_bwd_ms": run(fb(lambda x: FA.flash_attention_packed_qkv(
             x, nh, causal=causal))),
         "six_fwd_bwd_ms": run(fb(six)),
         "plain_fwd_ms": run(lambda: FA.flash_packed_forward_reference(
             q, k, v, nh, causal)),
         "plain_bwd_ms": run(lambda: FA.flash_packed_bwd_reference(
             q, k, v, out, lse, dout, nh, causal)),
         "library_fwd_ms": run(lambda: F.scaled_dot_product_attention(
             *heads_major(qkv), is_causal=causal)),
         "library_bwd_ms": run(lambda: torch.autograd.grad(
             lout, lx, douth, retain_graph=True)),
         "library_fwd_bwd_ms": run(lib_fb),
         "library": "F.scaled_dot_product_attention(is_causal=True) on "
                    "[B, nh, S, hd] views of qkv, backward into qkv",
         "six": "#6 through flash_attention on the [B, S, 3, nh, hd] "
                "views of the same qkv, backward into qkv"}
    half = 0.5 if causal else 1.0
    mm = 2 * b * nh * s * s * 128 * half
    item = qkv.element_size()
    specs = {"flash_packed_fwd": (t["fwd_ms"], t["plain_fwd_ms"],
                                  t["library_fwd_ms"], 2 * mm,
                                  4 * b * s * nh * 128 * item
                                  + b * nh * s * 4,
                                  row["max_abs_err"]["out"]),
             "flash_packed_bwd_dq": (t["dq_ms"], t["plain_bwd_ms"],
                                     t["library_bwd_ms"], 3 * mm,
                                     5 * b * s * nh * 128 * item
                                     + 2 * b * nh * s * 4,
                                     row["max_abs_err"]["dq"]),
             "flash_packed_bwd_dkv": (t["dkv_ms"], t["plain_bwd_ms"],
                                      t["library_bwd_ms"], 4 * mm,
                                      6 * b * s * nh * 128 * item
                                      + 2 * b * nh * s * 4,
                                      max(row["max_abs_err"]["dk"],
                                          row["max_abs_err"]["dv"]))}
    kernels = {}
    for kname, (ms, pms, lms, flops, nbytes, err) in specs.items():
        bms, by = bound_of(flops, nbytes, dtype)
        t[kname + "_bound_ms"] = bms
        kernels[kname] = {"ms": ms, "plain_ms": pms, "library_ms": lms,
                          "bound_ms": bms, "bound_by": by,
                          "max_abs_err": err}
    return {"kernels": kernels, "times": t}


# ------------------------------------------- slice 13: ResNet-50 training
# resnet_parity's limits: loss relative, logits and every gradient
# (each leaf) relative to their largest magnitude, running statistics
# absolute
RN_LIMITS = {"loss": 1e-5, "logits": 1e-4, "grads": 1e-3, "stats": 1e-5,
             "eval_logits": 1e-4}
# (dtype, comparison, the measures gated). A ReLU whose input lies within
# rounding of 0 takes the other branch in another run, which moves that
# element's whole gradient; in layer4 a batch norm's backward spreads it
# over the channel's 64 values, so two f32 runs' gradients (the CPU's
# and the card's) differ by up to ~26% of a leaf's largest value. Each
# f32 run's gradients are held instead against the CPU's f64 evaluation
# on that run's own branches ("_on_its_branches"), at the full limits.
# cuDNN runs f64 convolutions in NCHW whatever the memory format, so the
# channels-last kernels are the f32 card_cl run's.
RN_ALL = tuple(RN_LIMITS)
RN_GATES = (("float64", "card_vs_cpu", RN_ALL),
            ("float64", "card_cl_vs_card", RN_ALL),
            ("float32", "card_vs_cpu", ("loss", "logits", "stats",
                                        "eval_logits")),
            ("float32", "card_cl_vs_card", ("loss", "logits", "stats",
                                            "eval_logits")),
            ("float32", "cpu_vs_cpu_f64_on_its_branches", RN_ALL),
            ("float32", "card_vs_cpu_f64_on_its_branches", RN_ALL),
            ("float32", "card_cl_vs_cpu_f64_on_its_branches", RN_ALL))
RN_B = 16     # batch statistics over 64 values a channel in layer4
# the optimizers held card against CPU over ResNet-50's parameter kinds:
# (class, kwargs, clip); Lamb's exclude function reads the name
RN_OPTS = {
    "SGD": ("SGD", dict(learning_rate=0.05, weight_decay=1e-4), None),
    "Momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                  weight_decay=1e-4), None),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True), None),
    "Adam": ("Adam", dict(learning_rate=1e-3, weight_decay=1e-4), None),
    "AdamW": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05,
                            lr_ratio=lambda p: 0.5), None),
    "Adamax": ("Adamax", dict(learning_rate=1e-3), None),
    "Adagrad": ("Adagrad", dict(learning_rate=0.01,
                                initial_accumulator_value=0.1), None),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9), None),
    "RMSProp": ("RMSProp", dict(learning_rate=1e-3, momentum=0.5,
                                centered=True), None),
    "Lamb": ("Lamb", dict(learning_rate=1e-3, lamb_weight_decay=0.01,
                          exclude_from_weight_decay_fn=lambda n:
                          ".bn" in n), None),
    "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1), None),
    "DGCMomentum": ("DGCMomentum", dict(learning_rate=0.1, sparsity=0.999),
                    None),
    "Momentum_clip_norm": ("Momentum", dict(learning_rate=0.1),
                           ("ClipGradByNorm", (0.5,))),
    "Momentum_clip_value": ("Momentum", dict(learning_rate=0.1),
                            ("ClipGradByValue", (1e-3,))),
}
# ResNet-50's parameter kinds: layer4's 3x3 conv, a BN scale, the head
RN_OPT_SHAPES = {"layer4.0.conv2.weight": ((512, 512, 3, 3), 1e-3),
                 "layer4.0.bn2.weight": ((512,), 1e-2),
                 "fc.weight": ((1000, 2048), 1e-3)}
# train_resnet50: bench_resnet50's batch and image side, steps a window
RN_TRAIN = {"B": 64, "image": 224, "N": 10}


@contextlib.contextmanager
def relu_branches(record=None, replay=None):
    """Within it, `fused_conv_bn_act`'s ReLU (ResNet's only one) appends
    each call's branch (input > 0) to `record`, or computes input *
    branch from `replay`'s branches in call order (the same function on
    those branches; its gradient is the branch)."""
    from paddle_tpu_torch.nn import functional as PF
    relu = PF._EPILOGUE_ACTS["relu"]
    it = iter(replay or ())

    def act(v):
        if replay is None:
            record.append(v.detach() > 0)
            return relu(v)
        b = next(it)
        check(b.shape == v.shape, f"replayed branch {tuple(b.shape)} for "
                                  f"an input {tuple(v.shape)}")
        return v * b.to(device=v.device, dtype=v.dtype)

    PF._EPILOGUE_ACTS["relu"] = act
    try:
        yield
    finally:
        PF._EPILOGUE_ACTS["relu"] = relu
    check(replay is None or next(it, None) is None,
          "fewer ReLU calls than replayed branches")


def resnet_run(torch, model, img, lab, record=None, replay=None):
    """One training forward and backward (its ReLU branches recorded into
    `record` or replayed from `replay`, see relu_branches) and one eval
    forward: (train logits, loss, {gradient}, {buffer after the training
    forward}, eval logits), on the CPU in f64."""
    import torch.nn.functional as F
    model.zero_grad(set_to_none=True)
    model.train()
    if record is None and replay is None:
        logits = model(img)
    else:
        with relu_branches(record, replay):
            logits = model(img)
    loss = F.cross_entropy(logits, lab)
    loss.backward()
    stats = {n: b.detach().double().cpu() for n, b in model.named_buffers()}
    model.eval()
    with torch.no_grad():
        ev = model(img)
    out = (logits.detach().double().cpu(), float(loss.detach()),
           {n: p.grad.double().cpu() for n, p in model.named_parameters()},
           stats, ev.double().cpu())
    model.train()
    return out


def resnet_errs(a, b):
    """Run a against run b by RN_LIMITS' measures."""
    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
    grads = {n: rel(a[2][n], b[2][n]) for n in b[2]}
    worst = max(grads, key=grads.get)
    return {"logits": rel(a[0], b[0]),
            "loss": abs(a[1] - b[1]) / abs(b[1]),
            "grads": grads[worst], "worst_grad": worst,
            "stats": max(float((a[3][n] - b[3][n]).abs().max())
                         for n in b[3]),
            "eval_logits": rel(a[4], b[4])}


def within(errs, keys):
    return all(errs[k] <= RN_LIMITS[k] for k in keys)


def branch_flips(a, b):
    """ReLU inputs whose branch differs between two runs' records."""
    return sum(int((x.cpu() != y.cpu()).sum()) for x, y in zip(a, b))


def bf16_steps(torch, a, b):
    """max over elements of |a - b| in units of the bf16 step at
    max(|a|, |b|)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), (e - 8).to(torch.int32))
    return float(((a - b).abs() / step).max())


def opt_trajectories(torch, pt, case, device, dtype, init, grads):
    """RN_OPTS[case] for len(grads) steps of Optimizer.step() on `device`
    and on the CPU, from the same parameters and gradients: {the worst
    parameter error over the steps ("params"), the state's ("state"),
    where the worst parameter error lies ("worst": step, tensor, element,
    card and CPU values), whether the CPU's parameters moved ("moved"),
    and each side's last parameters and state ("card", "cpu")}. f32:
    rel_err; bf16: bf16_steps, each step started from the CPU's parameters
    (the CPU's vectorised sqrt and pow are off by an ulp on some inputs, so
    a rounding that flips once would otherwise carry over and can add a
    second step later)."""
    cls, kw, clip = RN_OPTS[case]
    cpu = torch.device("cpu")
    runs = []
    for dev in (device, cpu):
        named = [(n, torch.nn.Parameter(a.to(device=dev, dtype=dtype,
                                             copy=True)))
                 for n, a in init.items()]
        extra = {} if clip is None else dict(
            grad_clip=getattr(pt.nn, clip[0])(*clip[1]))
        runs.append((named, getattr(pt.optimizer, cls)(
            parameters=named, device=dev, **kw, **extra)))
    (kn, kopt), (cn, copt) = runs
    perr = serr = 0.0
    worst = None
    for s, g in enumerate(grads):
        for (n, kp), (_, cp) in zip(kn, cn):
            kp.grad = g[n].to(device=device, dtype=dtype, copy=True)
            cp.grad = g[n].to(dtype=dtype, copy=True)
        kopt.step()
        copt.step()
        for (n, kp), (_, cp) in zip(kn, cn):
            k32 = kp.detach().cpu()
            e = rel_err(k32, cp.detach()) if dtype == torch.float32 \
                else bf16_steps(torch, k32, cp.detach())
            if e > perr or worst is None:
                i = int((k32.float() - cp.detach().float()).abs().argmax())
                worst = {"step": s, "tensor": n, "element": i,
                         "card": float(k32.reshape(-1)[i]),
                         "cpu": float(cp.detach().reshape(-1)[i])}
            perr = max(perr, e)
            if dtype != torch.float32:
                with torch.no_grad():
                    kp.copy_(cp)
            for k, v in copt._states[n].items():
                serr = max(serr, rel_err(kopt._states[n][k].cpu(), v))
    moved = any(not torch.equal(cp.detach(), init[n].to(dtype))
                for n, cp in cn)

    def last(named, opt):
        return {n: [p.detach().cpu()] + [v.cpu() for _, v in
                                         sorted(opt._states[n].items())]
                for n, p in named}
    return {"params": perr, "state": serr, "worst": worst, "moved": moved,
            "card": last(kn, kopt), "cpu": last(cn, copt)}


def same_run(torch, a, b):
    """Whether two runs' last parameters and state are bitwise equal."""
    return all(len(a[n]) == len(b[n]) and
               all(torch.equal(x, y) for x, y in zip(a[n], b[n]))
               for n in b)


def opt_check(torch, pt, case, device, dtype, init, grads):
    """opt_trajectories' errors held to their limits (f32: 1e-6 relative
    for parameters and state; bf16: one bf16 step per parameter element).
    An f32 run outside them runs again on both sides: it passes only if
    the CPU's reference did not reproduce itself while the card's run did,
    bit for bit, and the card agrees with the CPU's second run; the record
    says which side reproduced."""
    f32 = dtype == torch.float32

    def within(r):
        return (r["params"] <= 1e-6 and r["state"] <= 1e-6) if f32 \
            else r["params"] <= 1.0
    a = opt_trajectories(torch, pt, case, device, dtype, init, grads)
    rec = {k: a[k] for k in ("params", "state", "moved", "worst")}
    ok = within(a)
    if not ok and f32:
        b = opt_trajectories(torch, pt, case, device, dtype, init, grads)
        card_same, cpu_same = (same_run(torch, a[k], b[k])
                               for k in ("card", "cpu"))
        rec["rerun"] = {"params": b["params"], "state": b["state"],
                        "worst": b["worst"], "card_reproduced": card_same,
                        "cpu_reproduced": cpu_same}
        ok = card_same and not cpu_same and within(b)
    # (a bf16 BN scale near 1 may not move at a small rate: its step there
    # is 2^-7); the state is f32 in both dtypes, but a bf16 run restarts
    # each step from the CPU's parameters
    rec["ok"] = bool(ok and a["moved"])
    return rec, a


def phase_resnet_parity(torch, device, card):
    """ResNet-50 at full width (1000 classes) on 64^2 images, B=RN_B: the
    same seeded weights on the card and on the CPU, one training forward
    and backward (logits, loss, every gradient, the running statistics
    after the forward) and one eval forward, the card against the CPU and
    channels-last against NCHW on the card, in f32 and f64, each also
    against the CPU's f64 run, and each f32 run against the CPU's f64 run
    on that f32 run's ReLU branches (gated by RN_GATES); then every
    optimizer (and the two new clips) for 5 steps over ResNet-50's
    parameter kinds, card against CPU, in f32 and bf16, and DGCMomentum
    over one 2^24 + 1-element tensor."""
    import paddle_tpu_torch as pt
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(61)
    img = torch.randn(RN_B, 3, 64, 64, generator=g, dtype=torch.float64)
    lab = torch.randint(0, 1000, (RN_B,), generator=g)
    ref = pt.resnet50(num_classes=1000, device=cpu, seed=5)
    state = ref.state_dict()

    def run(dt, where, cl=False, record=None, replay=None):
        pt.set_flags({"FLAGS_conv_channels_last": cl})
        try:
            dev = cpu if where == "cpu" else device
            m = pt.resnet50(num_classes=1000, device=dev, seed=5)
            m.load_state_dict(state)
            m.to(dt)
            return resnet_run(torch, m, img.to(device=dev, dtype=dt),
                              lab.to(dev), record, replay)
        finally:
            pt.set_flags({"FLAGS_conv_channels_last": False})

    runs, branches = {}, {}
    t0 = time.perf_counter()
    for dt in ("float32", "float64"):
        for where, cl in (("cpu", False), ("card", False), ("card_cl", True)):
            branches[(dt, where)] = rec = []
            runs[(dt, where)] = run(getattr(torch, dt), where, cl, rec)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    exact = runs[("float64", "cpu")]
    t0 = time.perf_counter()
    on_branches = {w: run(torch.float64, "cpu",
                          replay=branches[("float32", w)])
                   for w in ("cpu", "card", "card_cl")}
    replay_s = time.perf_counter() - t0
    cmp = {}
    for dt in ("float32", "float64"):
        cmp[dt] = {
            "card_vs_cpu": resnet_errs(runs[(dt, "card")], runs[(dt, "cpu")]),
            "card_cl_vs_card": resnet_errs(runs[(dt, "card_cl")],
                                           runs[(dt, "card")]),
            "cpu_vs_cpu_f64": resnet_errs(runs[(dt, "cpu")], exact),
            "card_vs_cpu_f64": resnet_errs(runs[(dt, "card")], exact),
            "card_cl_vs_cpu_f64": resnet_errs(runs[(dt, "card_cl")], exact)}
    for w in on_branches:
        cmp["float32"][f"{w}_vs_cpu_f64_on_its_branches"] = resnet_errs(
            runs[("float32", w)], on_branches[w])
    flips = {w: branch_flips(branches[("float32", w)],
                             branches[("float64", "cpu")])
             for w in ("cpu", "card", "card_cl")}
    relu_inputs = sum(b.numel() for b in branches[("float64", "cpu")])
    gated = {f"{dt}_{k}": within(cmp[dt][k], keys)
             for dt, k, keys in RN_GATES}
    # optimizers: card against CPU, 5 steps
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(62)
    init = {n: (torch.rand(s, generator=g) - 0.5) * 0.05 +
            (1.0 if ".bn" in n else 0.0) for n, (s, _) in
            RN_OPT_SHAPES.items()}
    grads = [{n: torch.randn(s, generator=g) * sc for n, (s, sc) in
              RN_OPT_SHAPES.items()} for _ in range(5)]
    opt_errs = {f"{case}_{dt}": opt_check(torch, pt, case, device,
                                          getattr(torch, dt), init, grads)[0]
                for case in RN_OPTS for dt in ("float32", "bfloat16")}
    # DGC over one tensor past torch.quantile's 2^24 elements
    big = {"wte.weight": (torch.rand(2 ** 24 + 1, generator=g) - 0.5) * 0.1}
    bg = [{"wte.weight": torch.randn(2 ** 24 + 1, generator=g) * 1e-2}
          for _ in range(5)]
    dgc, dgc_run = opt_check(torch, pt, "DGCMomentum", device,
                             torch.float32, big, bg)
    dgc["changed"] = int((dgc_run["cpu"]["wte.weight"][0]
                          != big["wte.weight"]).sum())
    dgc["ok"] = dgc["ok"] and 0 < dgc["changed"] < 2 ** 24
    del dgc_run
    opt_s = time.perf_counter() - t0
    out = {"phase": "resnet_parity", "card": card,
           "model": {"preset": "resnet50", "classes": 1000, "image": 64,
                     "B": RN_B, "params": sum(p.numel()
                                              for p in ref.parameters())},
           "limits": RN_LIMITS, "gates": RN_GATES,
           "errors": cmp, "gated": gated,
           "relu_branch_flips_vs_cpu_f64": flips,
           "relu_inputs": relu_inputs, "relu_calls": len(
               branches[("float64", "cpu")]),
           "model_s": model_s, "replay_s": replay_s,
           "optimizers": opt_errs, "optimizer_s": opt_s,
           "dgc_2p24p1": dgc, "seconds": time.perf_counter() - t_phase}
    # what failed goes last, after the whole record, so that the end of
    # the output names it
    failed = {f"resnet_{dt}_{c}": {m: cmp[dt][c][m] for m in keys}
              for dt, c, keys in RN_GATES if not gated[f"{dt}_{c}"]}
    failed.update({f"optimizer_{k}": v for k, v in opt_errs.items()
                   if not v["ok"]})
    if not dgc["ok"]:
        failed["dgc_2p24p1"] = dgc
    out["ok"] = not failed
    emit(out)
    if failed:
        exc = SmokeFailure(f"resnet_parity outside its limits: "
                           f"{json.dumps(failed)}")
        exc.record = out
        raise exc
    torch.cuda.empty_cache()
    return out


def update_launches(torch, opt, step):
    """Device kernels one optimizer update over every parameter of the
    TrainStep `step` launches, read by the profiler (zero gradients)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    grads = [torch.zeros_like(p) for p in step._params]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for n, p, gr, st in zip(step._param_names, step._params, grads,
                                step._opt_state):
            opt.update(p, gr, st, 0.0, step._step_i + 1, opt._wd_for(n),
                       name=n)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def phase_train_resnet50(torch, card, device, channels_last):
    """bench_resnet50's configuration at full width: resnet50 (25.6M
    parameters) at 224^2, 1000 classes, bf16 parameters and buffers, B=64,
    Momentum(lr=0.1, momentum=0.9), cross-entropy of the f32 logits,
    under FLAGS_conv_channels_last on (bench's setting on the chip) or
    off; images N(0, 1) and labels drawn on the device from a seeded
    generator (bench: numpy). 2 warm steps, then the best of 2 windows of
    10 (bench: one window of 8), then one profiled step; learning is
    checked on one batch repeated 6 more times, and every running
    statistic must have left its initial 0 or 1. MFU is bench_resnet50's:
    3 x 7.7e9 FLOPs an image over the peak."""
    import math
    import torch.nn.functional as F
    import paddle_tpu_torch as pt
    t_phase = time.perf_counter()
    B_, hw, N = RN_TRAIN["B"], RN_TRAIN["image"], RN_TRAIN["N"]
    pt.set_flags({"FLAGS_conv_channels_last": channels_last})
    try:
        model = pt.resnet50(num_classes=1000, device=device,
                            dtype=torch.bfloat16, seed=0)
        model.train()
        opt = pt.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=model.named_parameters(), device=device)
        step = pt.TrainStep(model, opt,
                            lambda x, y: F.cross_entropy(model(x).float(),
                                                         y), device=device)
        g = torch.Generator(device=device).manual_seed(0)
        imgs = torch.randn(N + 2, B_, 3, hw, hw, generator=g,
                           device=device).to(torch.bfloat16)
        lbl = torch.randint(0, 1000, (N + 2, B_), generator=g, device=device)
        warm, losses, windows, _, peak = timed_steps(
            torch, step, lambda i: (imgs[i], lbl[i]), N)
        best = min(windows)
        img_s = B_ * N / best
        check(all(math.isfinite(x) for x in warm + losses),
              "a ResNet-50 training loss is not finite")
        check(abs(warm[0] - math.log(1000)) < 2.0,
              f"first ResNet-50 loss {warm[0]} is not near ln(1000) "
              f"{math.log(1000)}")
        seen = []
        hook = model.layer1.register_forward_hook(
            lambda mod, i, o: seen.append(o.is_contiguous(
                memory_format=torch.channels_last)))
        prof = profile_call(torch, lambda: step(imgs[2], lbl[2]),
                            names=("batch_norm", "bn_", "conv", "gemm",
                                   "elementwise"))
        hook.remove()
        same = [float(step(imgs[0], lbl[0])) for _ in range(6)]
        check(same[-1] < same[0],
              f"the ResNet-50 loss on a repeated batch did not fall: {same}")
        bns = [m for m in model.modules()
               if isinstance(m, pt.nn.BatchNorm2D)]
        still = [i for i, m in enumerate(bns)
                 if bool((m._mean == 0).all()) or
                 bool((m._variance == 1).all())]
        check(not still, f"running statistics never moved in {len(still)} "
                         f"of {len(bns)} batch norms")
        check(seen == [channels_last],
              f"layer1's output channels-last {seen}, flag {channels_last}")
        launches = update_launches(torch, opt, step)
        n_params = sum(p.numel() for p in model.parameters())
        emit({"phase": "train_resnet50" + ("_nhwc" if channels_last
                                           else "_nchw"),
              "ok": True, "card": card,
              "model": {"preset": "resnet50", "image": hw, "classes": 1000,
                        "dtype": "bfloat16", "buffers": "bfloat16"},
              "config": {"B": B_, "optimizer": "Momentum(lr=0.1, "
                         "momentum=0.9)",
                         "FLAGS_conv_channels_last": channels_last,
                         "cudnn_benchmark": bool(
                             torch.backends.cudnn.benchmark),
                         "loss": "F.cross_entropy(model(x).float(), y)",
                         "data": "torch.Generator(seed 0) on the device",
                         "timing": "2 warm steps, best of 2 windows of 10"},
              "params": n_params, "param_tensors": len(step._params),
              "images_per_s": img_s, "ms_per_step": best / N * 1e3,
              "window_s": windows, "flops_per_image": 3 * 7.7e9,
              "mfu": 3 * 7.7e9 * img_s / TENSOR_FLOPS_PER_S,
              "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
              "peak_mem_bytes": peak, "first_loss": warm[0],
              "warm_losses": warm, "last_window_losses": losses,
              "repeated_batch_losses": same,
              "trunk_channels_last": seen[0],
              "update_launches": launches,
              "update_launches_per_param": launches / len(step._params),
              "profile_step": prof,
              "seconds": time.perf_counter() - t_phase})
    finally:
        pt.set_flags({"FLAGS_conv_channels_last": False})
    del step, opt, model, imgs
    torch.cuda.empty_cache()


# ---------------------- slice 14: MoE GPT, ERNIE and the fused layers
# the bf16 legs of the slice-14 parity phases: the loss within CE_TOL's
# bf16 loss limit, each gradient within the 0.1 row limit of the bf16
# attention kernels (#6, #9), of its largest entry
BF16_TRAIN_TOL = {"loss": 2e-3, "grads": 0.1}
# moe_parity: gpt3-350m width cut to 4 layers (2 of them MoE), 8 experts
# of top-2 gshard at capacity factor 1.0 (bench_moe's row), B=2, S=1024
MOE_PARITY = {"preset": "gpt3-350m", "layers": 4, "experts": 8, "B": 2,
              "S": 1024, "steps": 5, "chain_prompts": 8, "chain_new": 32}
# bench_moe's configuration (bench.py:341-445) at full width
MOE_TRAIN = {"preset": "gpt3-350m", "experts": 8, "B": 8, "S": 1024,
             "N": 8, "cf": 1.0}
# ernie_parity: ernie-3.0-medium width cut to 2 layers; the fused layers
# at bert-base width
ERNIE_PARITY = {"layers": 2, "B": 4, "S": 512, "steps": 5, "width": 768,
                "heads": 12, "ff": 3072, "decode_steps": 32}
# bench_bert's settings (bench.py:154) borrowed for ERNIE, which bench.py
# does not run
ERNIE_TRAIN = {"preset": "ernie-3.0-medium", "B": 32, "S": 512, "N": 10}


def moe_config(torch, p, **kw):
    from paddle_tpu_torch import gpt_config
    return gpt_config(p["preset"], num_layers=p["layers"],
                      max_position_embeddings=max(1024, p["S"]),
                      moe_num_experts=p["experts"], moe_every_n_layers=2,
                      moe_gate="gshard", moe_aux_weight=0.01,
                      moe_capacity_factor=1.0, **kw)


@contextlib.contextmanager
def moe_routing(torch, record=None, replay=None, flips=None):
    """Test-only, the MoE parity only: every MoE layer's routing (expert
    ids, capacity slots, keep flags) is appended to `record`, or replaced
    in call order by `replay`'s, with the gate values taken from this
    run's own probabilities; `flips` then counts the (token, slot)
    assignments whose expert or keep flag this run's own routing would
    have changed. A token near a router tie can take another expert
    between two runs that differ by rounding (bf16), and one token moves
    a whole row of its experts' gradients: replaying the routing holds
    the rest to the rounding limits."""
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        moe_layer as ML
    real = ML._topk_routing
    calls = None if replay is None else iter(replay)

    def routing(probs, top_k, capacity):
        out = real(probs, top_k, capacity)
        if record is not None:
            record.append(tuple(t.detach().clone() for t in out[1:4]))
        if calls is None:
            return out
        idx, locs, keeps = next(calls)
        if flips is not None:
            flips.append(int(((idx != out[1]) | (keeps != out[3])).sum()))
        gate_vals = probs.gather(1, idx)
        if top_k > 1:
            gate_vals = gate_vals / torch.clamp(
                gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
        frac = F.one_hot(idx[:, 0], probs.shape[1]).to(probs.dtype).mean(0)
        return gate_vals, idx, locs, keeps, frac
    ML._topk_routing = routing
    try:
        yield
    finally:
        ML._topk_routing = real


def route_grads(torch, model, loss_fn, plain, seed=7, routing=None):
    """(loss, {name: grad}, launches) of one forward and backward, on the
    plain route or the kernel route (under the `routing` context, if
    given); the model's dropout generator is reseeded first so both
    routes draw the same masks."""
    from paddle_tpu_torch.ops.cuda import build as KB
    model.zero_grad(set_to_none=True)
    gen = getattr(model, "dropout_generator", None)
    if gen is not None:
        gen.manual_seed(seed)
    KB.reset_launch_counts()
    with plain_route() if plain else contextlib.nullcontext(), \
            routing or contextlib.nullcontext():
        loss = loss_fn()
        loss.backward()
    torch.cuda.synchronize()
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}, dict(KB.LAUNCHES))


def compare_routes(torch, model, loss_fn, want, dtype, what, moe=False):
    """Kernel route against plain route for the loss and every gradient
    (f32: 1e-5 and 1e-3 of each gradient's largest entry; bf16:
    BF16_TRAIN_TOL), with the kernel route's launches checked against
    `want` and none on the plain route. With `moe` the plain route
    replays the kernel route's MoE routing (`moe_routing`), and the
    assignments its own routing would have changed are reported."""
    rec, flips = [], []
    kl, kg, kc = route_grads(
        torch, model, loss_fn, False,
        routing=moe_routing(torch, record=rec) if moe else None)
    pl, pg, pc = route_grads(
        torch, model, loss_fn, True,
        routing=moe_routing(torch, replay=rec, flips=flips) if moe
        else None)
    check(sum(pc.values()) == 0, f"{what}: the plain route launched a "
                                 f"kernel: {pc}")
    check(all(kc[k] == n for k, n in want.items()),
          f"{what}: kernel route launches {kc}, want {want}")
    check(set(kg) == set(pg), f"{what}: the routes reach different "
                              f"parameters")
    f32 = dtype == torch.float32
    ltol, gtol = (1e-5, 1e-3) if f32 else (BF16_TRAIN_TOL["loss"],
                                           BF16_TRAIN_TOL["grads"])
    errs = {n: rel_err(kg[n], pg[n]) for n in kg}
    worst = max(errs, key=errs.get)
    res = {"loss": {"kernel": kl, "plain": pl,
                    "rel_err": abs(kl - pl) / abs(pl), "tol": ltol},
           "grads": {"params": len(errs), "worst_param": worst,
                     "worst_rel_err": errs[worst], "tol": gtol},
           "launches": {k: kc[k] for k in want}}
    if moe:
        res["routing"] = {"layers_replayed": len(flips),
                          "assignments": sum(int(r[0].numel()) for r in rec),
                          "flips_without_replay": sum(flips)}
    check(res["loss"]["rel_err"] <= ltol and errs[worst] <= gtol,
          f"{what}: loss or grads differ: {res}")
    return res, kg


def adamw_trajectories(torch, model, init, batches, loss_fn, device, what):
    """5-step AdamW TrainStep trajectories (decay 0.01, bias and
    LayerNorm exempt, ClipGradByGlobalNorm(1.0)) from the same weights on
    the kernel route and the plain route, f32: the losses to 1e-4
    relative."""
    from paddle_tpu_torch import AdamW, ClipGradByGlobalNorm, TrainStep
    traj = {}
    for plain in (False, True):
        model.load_state_dict(init)
        opt = AdamW(1e-4, parameters=model.named_parameters(),
                    weight_decay=0.01, apply_decay_param_fun=decay_fun,
                    grad_clip=ClipGradByGlobalNorm(1.0), device=device)
        step = TrainStep(model, opt, loss_fn, device=device)
        gen = getattr(model, "dropout_generator", None)
        if gen is not None:
            gen.manual_seed(11)
        with plain_route() if plain else contextlib.nullcontext():
            traj[plain] = [float(step(*b)) for b in batches]
        del step, opt
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj[False], traj[True]))
    res = {"kernel_losses": traj[False], "plain_losses": traj[True],
           "max_rel_err": rel, "tol": 1e-4}
    check(rel <= 1e-4, f"{what}: trajectories differ: {res}")
    return res


def phase_moe_parity(torch, device, card):
    """GPT with MoE blocks, kernel route against plain route on the card,
    at MOE_PARITY: in f32 and bf16, the loss (with the router aux loss)
    and every gradient (#6 in every layer, #11 once), the plain route
    replaying the kernel route's expert routing (`moe_routing`; the
    assignments its own routing would have moved are reported); in f32
    also 5-step
    AdamW trajectories, the index route against the one-hot route
    (PADDLE_TPU_MOE_GATHER=0: the same loss, gradients and drop rate),
    and greedy chains of 32 tokens through the paged engine (equal, or an
    argmax margin below 1e-3 at the first divergence)."""
    import numpy as np
    from paddle_tpu_torch import GPTForCausalLM, synthetic_traffic
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    from paddle_tpu_torch.ops.cuda import build as KB
    t_phase = time.perf_counter()
    p = MOE_PARITY
    cfg = moe_config(torch, p)
    L, B_, S_ = cfg.num_layers, p["B"], p["S"]
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "linear_ce_fwd": 1}
    batches = [torch.from_numpy(np.random.RandomState(60 + i).randint(
        0, cfg.vocab_size, (B_, S_)).astype(np.int64)).to(device)
        for i in range(p["steps"])]
    x = batches[0]
    out = {"phase": "moe_parity", "card": card,
           "model": dict(cfg_line(cfg, "float32"), experts=p["experts"],
                         moe_blocks=L // 2, gate="gshard", top_k=2,
                         capacity_factor=1.0),
           "B": B_, "S": S_}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=1)
        loss_fn = lambda: model.loss(x, x)  # noqa: E731
        leg, kg = compare_routes(torch, model, loss_fn, want, dtype,
                                 f"moe_parity {name}", moe=True)
        leg["aux_loss"] = float(model.gpt.last_aux_loss.detach())
        if dtype == torch.float32:
            with env_set(PADDLE_TPU_MOE_GATHER="0"):
                ol, og, _ = route_grads(torch, model, loss_fn, False)
            errs = {n: rel_err(og[n], kg[n]) for n in kg}
            worst = max(errs, key=errs.get)
            il = leg["loss"]["kernel"]
            rates = {}
            for gather in ("1", "0"):
                moe_layer.record_drop_rate(True)
                try:
                    with env_set(PADDLE_TPU_MOE_GATHER=gather), \
                            torch.no_grad():
                        model.loss(x, x)
                    rates[gather] = moe_layer.measured_drop_rate()
                finally:
                    moe_layer.record_drop_rate(False)
            leg["one_hot_route"] = {
                "loss": ol, "loss_rel_err": abs(ol - il) / abs(il),
                "worst_param": worst, "worst_grad_rel_err": errs[worst],
                "tol": [1e-5, 1e-3], "drop_rate_index": rates["1"],
                "drop_rate_one_hot": rates["0"]}
            check(abs(ol - il) / abs(il) <= 1e-5 and errs[worst] <= 1e-3
                  and rates["1"] == rates["0"],
                  f"moe_parity: the one-hot route differs: "
                  f"{leg['one_hot_route']}")
            del og
            init = {k: v.clone() for k, v in model.state_dict().items()}
            leg["trajectory"] = adamw_trajectories(
                torch, model, init, [(b, b) for b in batches],
                lambda a, b: model.loss(a, b), device, "moe_parity")
            model.load_state_dict(init)
            prompts = [t["prompt"] for t in synthetic_traffic(
                p["chain_prompts"], prompt_cap=128,
                vocab_size=cfg.vocab_size, rate=1e9, seed=5,
                length_dist="longtail")]
            kw = dict(max_batch=8, prompt_cap=128,
                      max_new_tokens=p["chain_new"], decode_chunk=8,
                      paged=True)
            KB.reset_launch_counts()
            kern, _ = serve(torch, model, kw, prompts)
            launches = dict(KB.LAUNCHES)
            with plain_route():
                plain, _ = serve(torch, model, kw, prompts)
            diverged = divergences(torch, model, device, prompts, kern,
                                   plain)
            for d in diverged:
                check(d["argmax_margin"] < 1e-3,
                      f"moe_parity: greedy chains diverge: {d}")
            check(launches["paged_attention"] > 0,
                  "moe_parity: the engine never launched paged_attention")
            leg["paged_chains"] = {
                "requests": len(prompts), "tokens_each": p["chain_new"],
                "equal_chains": len(prompts) - len(diverged),
                "diverged": diverged, "kernel_launches": launches}
        del kg, model
        torch.cuda.empty_cache()
        out[name] = leg
    out["ok"] = True
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def fused_layer_parity(torch, layer, x, want, what):
    """A fused layer in train() mode (dropout 0.1) on the #9 route against
    the plain route: its output (1e-5 of the largest entry) and the
    gradient of every parameter and of x (1e-3 of each largest entry),
    with the dropout generators reseeded before each route."""
    from paddle_tpu_torch.ops.cuda import build as KB
    gens = [m.dropout_generator for m in layer.modules()
            if hasattr(m, "dropout_generator")]
    w = torch.randn(x.shape, generator=torch.Generator(
        device=x.device).manual_seed(3), device=x.device)
    runs = {}
    for plain in (False, True):
        for i, g in enumerate(gens):
            g.manual_seed(20 + i)
        layer.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        KB.reset_launch_counts()
        with plain_route() if plain else contextlib.nullcontext():
            y = layer(xi)
            (y.float() * w).sum().backward()
        torch.cuda.synchronize()
        grads = {n: q.grad.clone() for n, q in layer.named_parameters()
                 if q.grad is not None}
        grads["x"] = xi.grad.clone()
        runs[plain] = (y.detach(), grads, dict(KB.LAUNCHES))
    (ky, kg, kc), (py, pg, pc) = runs[False], runs[True]
    check(sum(pc.values()) == 0, f"{what}: the plain route launched a "
                                 f"kernel")
    check(all(kc[k] == n for k, n in want.items()),
          f"{what}: kernel route launches {kc}, want {want}")
    errs = {n: rel_err(kg[n], pg[n]) for n in pg}
    worst = max(errs, key=errs.get)
    res = {"out_rel_err": rel_err(ky, py), "tol": [1e-5, 1e-3],
           "grads": len(errs), "worst_grad": worst,
           "worst_grad_rel_err": errs[worst],
           "launches": {k: kc[k] for k in want}}
    check(res["out_rel_err"] <= 1e-5 and errs[worst] <= 1e-3,
          f"{what}: output or gradients differ: {res}")
    return res


def multi_transformer_decode(torch, stack, device, b, steps):
    """FusedMultiTransformer in eval(): `steps` single tokens through the
    growing (k, v) caches, the static (k, v, pos) caches and the int8
    static caches; the worst |static - growing| over the steps, each over
    the largest growing output."""
    e = stack.layers[0].fused_attn
    nh, hd, h = e.num_heads, e.head_dim, e.embed_dim
    shape = (b, steps, nh, hd)

    def static(q8):
        if q8:
            return [(torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.zeros(shape[:3], device=device),
                     torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.zeros(shape[:3], device=device), 0)
                    for _ in stack.layers]
        return [(torch.zeros(shape, device=device),
                 torch.zeros(shape, device=device), 0)
                for _ in stack.layers]
    empty = torch.zeros((b, 0, nh, hd), device=device)
    grow = [(empty, empty)] * len(stack.layers)
    fp, q8 = static(False), static(True)
    worst = {"fp": 0.0, "int8": 0.0}
    g = torch.Generator(device=device).manual_seed(5)
    stack.eval()
    with torch.no_grad():
        for _ in range(steps):
            tok = torch.randn((b, 1, h), generator=g, device=device)
            gy, grow = stack(tok, caches=grow)
            fy, fp = stack(tok, caches=fp)
            qy, q8 = stack(tok, caches=q8)
            worst["fp"] = max(worst["fp"], rel_err(fy, gy))
            worst["int8"] = max(worst["int8"], rel_err(qy, gy))
    stack.train()
    return worst


def phase_ernie_parity(torch, device, card):
    """ERNIE MLM training, kernel route against plain route, at
    ernie-3.0-medium width cut to 2 layers (B=4, S=512, task ids given,
    hidden and attention dropout 0.1 in train() mode): in f32 and bf16
    the loss and every gradient (#9 with dropout in each layer, #11 over
    V=40000), in f32 also 5-step AdamW trajectories. Then the incubate
    layers at bert-base width (768, 12 heads, FFN 3072) in f32:
    FusedTransformerEncoderLayer and a 2-layer FusedMultiTransformer on
    the #9 route against the plain route, forward and backward (dropout
    0.1); and the stack's static-cache decode, fp (k, v, pos) and int8,
    against its growing cache over 32 single tokens (fp to 1e-5 of the
    output's largest entry; int8 to 2e-2, the codes' rounding)."""
    import numpy as np
    from paddle_tpu_torch import ErnieForMaskedLM, ernie_config
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              FusedTransformerEncoderLayer)
    t_phase = time.perf_counter()
    p = ERNIE_PARITY
    cfg = ernie_config("ernie-3.0-medium", num_layers=p["layers"])
    B_, S_ = p["B"], p["S"]
    rng = np.random.RandomState(43)
    batches = []
    for _ in range(p["steps"]):
        ids = rng.randint(0, cfg.vocab_size, (B_, S_))
        lbl = rng.randint(0, cfg.vocab_size, (B_, S_))
        lbl[rng.rand(B_, S_) > 0.15] = -100
        task = rng.randint(0, cfg.task_type_vocab_size, (B_, S_))
        batches.append(tuple(torch.from_numpy(a).to(device)
                             for a in (ids, lbl, task)))
    ids, lbl, task = batches[0]
    want = {"fused_mha_fwd": p["layers"], "fused_mha_bwd": p["layers"],
            "linear_ce_fwd": 1}
    out = {"phase": "ernie_parity", "card": card,
           "model": dict(cfg_line(cfg, "float32"), preset="ernie-3.0-medium"),
           "B": B_, "S": S_, "dropout": [cfg.hidden_dropout,
                                         cfg.attention_dropout]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = ErnieForMaskedLM(cfg, device=device, dtype=dtype, seed=1)
        model.train()
        leg, kg = compare_routes(
            torch, model, lambda: model.loss(ids, lbl, task_type_ids=task),
            want, dtype, f"ernie_parity {name}")
        del kg
        if dtype == torch.float32:
            init = {k: v.clone() for k, v in model.state_dict().items()}
            leg["trajectory"] = adamw_trajectories(
                torch, model, init, batches,
                lambda a, b, t: model.loss(a, b, task_type_ids=t), device,
                "ernie_parity")
        out[name] = leg
        del model
        torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((B_, S_, p["width"]), generator=g, device=device)
    enc = FusedTransformerEncoderLayer(p["width"], p["heads"], p["ff"],
                                       dropout_rate=0.1, activation="gelu",
                                       device=device, seed=1)
    out["encoder_layer"] = fused_layer_parity(
        torch, enc, x, {"fused_mha_fwd": 1, "fused_mha_bwd": 1},
        "FusedTransformerEncoderLayer")
    del enc
    stack = FusedMultiTransformer(p["width"], p["heads"], p["ff"],
                                  dropout_rate=0.1, num_layers=2,
                                  device=device, seed=2)
    out["multi_transformer"] = fused_layer_parity(
        torch, stack, x, {"fused_mha_fwd": 2, "fused_mha_bwd": 2},
        "FusedMultiTransformer")
    worst = multi_transformer_decode(torch, stack, device, B_,
                                     p["decode_steps"])
    out["multi_transformer_decode"] = {"steps": p["decode_steps"],
                                       "static_vs_growing": worst,
                                       "tol": {"fp": 1e-5, "int8": 2e-2}}
    check(worst["fp"] <= 1e-5 and worst["int8"] <= 2e-2,
          f"FusedMultiTransformer static decode differs from its growing "
          f"cache: {worst}")
    del stack
    torch.cuda.empty_cache()
    out["ok"] = True
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def moe_active_params(n, cfg, experts):
    """bench_moe's active-parameter count: the parameters less every
    expert's FFN weights (2 H inter a layer, biases not counted), plus
    top-2's."""
    per = 2 * cfg.hidden_size * cfg.intermediate_size
    moe_layers = cfg.num_layers // 2
    return n - experts * per * moe_layers + (2 * per * moe_layers
                                             if experts else 0)


def phase_train_gpt_moe(torch, card, device, experts, moe=None):
    """bench_moe's configuration at full width (MOE_TRAIN; `experts` 0 is
    its dense twin): gpt3-350m (24 layers, hidden 1024) with 1024
    positions, bf16 parameters, 8 experts every 2nd layer (top-2 gshard,
    moe_aux_weight 0.01, capacity factor 1.0), AdamW(lr=1e-4, bf16
    moments), B=8, S=1024, model.loss(ids, ids, chunk_size=512); ids from
    np.random.RandomState(0), [8, B, S] as bench draws them, batch i % 8
    at step i. 2 warm steps, then the best of 2 windows of 8, then one
    profiled step; the drop rate at the trained router from one no-grad
    forward under record_drop_rate; learning checked on one batch
    repeated 6 times. MFU is bench's over the active parameters (6 N_active
    + 12 L H S a token); the routing overhead, given the MoE run's summary
    `moe` in the dense twin, is (dt_moe / dt_dense) / (fpt_moe /
    fpt_dense) - 1. Returns (launch counts, summary)."""
    import math
    import numpy as np
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep, gpt_config
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    t_phase = time.perf_counter()
    p = MOE_TRAIN
    B_, S_, N = p["B"], p["S"], p["N"]
    cfg = gpt_config(p["preset"], max_position_embeddings=max(1024, S_),
                     moe_num_experts=experts, moe_every_n_layers=2,
                     moe_gate="gshard", moe_aux_weight=0.01,
                     moe_capacity_factor=p["cf"])
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt,
                     lambda a, b: model.loss(a, b, chunk_size=512),
                     device=device)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (N, B_, S_)).astype(np.int64)).to(device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (ids[i % N], ids[i % N]), N)
    L = cfg.num_layers
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "linear_ce_fwd": 1}
    per_step = {k: counts[k] / (2 * N) for k in want}
    check(per_step == want, f"gpt-moe launches per step {per_step}, want "
                            f"{want}")
    best = min(windows)
    n_params = sum(q.numel() for q in model.parameters())
    n_active = moe_active_params(n_params, cfg, experts)
    per_token = 6 * n_active + 12 * L * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "a gpt-moe training loss is not finite")
    check(abs(warm[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first gpt-moe loss {warm[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size)}")
    prof = profile_call(torch, lambda: step(ids[2], ids[2]),
                        names=("fwd_wg", "dq_wg", "dkv_wg", "lce_wg",
                               "lce_merge"))
    drop = None
    if experts:
        moe_layer.record_drop_rate(True)
        try:
            with torch.no_grad():
                model.loss(ids[0], ids[0], chunk_size=512)
            drop = moe_layer.measured_drop_rate()
        finally:
            moe_layer.record_drop_rate(False)
        check(drop is not None and 0.0 <= drop < 0.5,
              f"gpt-moe drop rate {drop}")
    same = [float(step(ids[0], ids[0])) for _ in range(6)]
    check(same[-1] < same[0],
          f"the gpt-moe loss on a repeated batch did not fall: {same}")
    summary = {"ms_per_step": best / N * 1e3, "tokens_per_s": tok_s,
               "flops_per_token": per_token,
               "mfu_active": per_token * tok_s / TENSOR_FLOPS_PER_S}
    line = {"phase": "train_gpt_moe" if experts else "train_gpt_moe_dense",
            "ok": True, "card": card,
            "model": dict(cfg_line(cfg, "bfloat16"), experts=experts,
                          moe_every_n_layers=2, gate="gshard", top_k=2,
                          capacity_factor=p["cf"], moe_aux_weight=0.01),
            "config": {"B": B_, "S": S_,
                       "max_position_embeddings": max(1024, S_),
                       "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                       "loss": "model.loss(ids, ids, chunk_size=512)",
                       "ids": "np.random.RandomState(0) [8, B, S], "
                              "labels = ids",
                       "timing": "2 warm steps, best of 2 windows of 8"},
            "params": n_params, "active_params": n_active, **summary,
            "window_s": windows,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet); "
                        "active parameters (bench_moe's formula)",
            "peak_mem_bytes": peak, "first_loss": warm[0],
            "warm_losses": warm, "last_window_losses": losses,
            "repeated_batch_losses": same, "drop_rate": drop,
            "launches_per_step": per_step, "profile_step": prof}
    if moe is not None:
        line["routing_overhead"] = ((moe["ms_per_step"] / summary[
            "ms_per_step"]) / (moe["flops_per_token"] / per_token) - 1.0)
        line["moe_ms_per_step"] = moe["ms_per_step"]
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    del step, opt, model
    torch.cuda.empty_cache()
    return counts, summary


def phase_train_ernie(torch, card, device):
    """ErnieForMaskedLM at ernie-3.0-medium (6 layers, H=768, vocab
    40000) with bench_bert's settings (ERNIE_TRAIN; bench.py has no ERNIE
    row): bf16 parameters, B=32, S=512, hidden and attention dropout 0.1
    in train() mode, AdamW(lr=1e-4, bf16 moments), model.loss(ids,
    labels, chunk_size=256) (#9 with in-kernel dropout in every layer, #11
    over the tied MLM head); ids and labels drawn independently from
    np.random.RandomState(0), task ids 0. 2 warm steps, then the best of 2
    windows of 10, then one profiled step; learning checked on one batch
    repeated 6 more times with the ids as labels."""
    import math
    import numpy as np
    from paddle_tpu_torch import AdamW, ErnieForMaskedLM, TrainStep, \
        ernie_config
    t_phase = time.perf_counter()
    p = ERNIE_TRAIN
    B_, S_, N = p["B"], p["S"], p["N"]
    cfg = ernie_config(p["preset"])
    model = ErnieForMaskedLM(cfg, device=device, dtype=torch.bfloat16,
                             seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16", device=device)
    step = TrainStep(model, opt,
                     lambda a, b: model.loss(a, b, chunk_size=256),
                     device=device)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (N + 2, B_, S_))).to(device)
    lbl = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (N + 2, B_, S_))).to(device)
    warm, losses, windows, counts, peak = timed_steps(
        torch, step, lambda i: (ids[i], lbl[i]), N)
    want = {"fused_mha_fwd": cfg.num_layers,
            "fused_mha_bwd": cfg.num_layers, "linear_ce_fwd": 1}
    per_step = {k: counts[k] / (2 * N) for k in want}
    check(per_step == want, f"ernie launches per step {per_step}, want "
                            f"{want}")
    best = min(windows)
    n_params = sum(q.numel() for q in model.parameters())
    per_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    check(all(math.isfinite(x) for x in warm + losses),
          "an ERNIE training loss is not finite")
    check(abs(warm[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first ERNIE loss {warm[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size)}")
    prof = profile_call(torch, lambda: step(ids[2], lbl[2]),
                        names=("fwd_wg", "dq_wg", "dkv_wg", "lce_wg",
                               "lce_merge"))
    same = [float(step(ids[0], ids[0])) for _ in range(6)]
    check(same[-1] < same[0],
          f"the ERNIE loss on a repeated batch did not fall: {same}")
    emit({"phase": "train_ernie-3.0-medium", "ok": True, "card": card,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {"B": B_, "S": S_, "dropout": [cfg.hidden_dropout,
                                                   cfg.attention_dropout],
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                     "loss": "model.loss(ids, labels, chunk_size=256)",
                     "ids": "np.random.RandomState(0): ids, then labels",
                     "settings": "bench_bert's (bench.py has no ERNIE row)",
                     "timing": "2 warm steps, best of 2 windows of 10"},
          "params": n_params, "tokens_per_s": tok_s,
          "ms_per_step": best / N * 1e3, "window_s": windows,
          "flops_per_token": per_token,
          "mfu": per_token * tok_s / TENSOR_FLOPS_PER_S,
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "peak_mem_bytes": peak, "first_loss": warm[0],
          "warm_losses": warm, "last_window_losses": losses,
          "repeated_batch_losses": same, "launches_per_step": per_step,
          "profile_step": prof, "seconds": time.perf_counter() - t_phase})
    del step, opt, model
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------- multi-GPU training (slice 17)
# dist_one_card (a): #11's vocab-parallel route at gpt3-1.3b's head, the
# vocabulary split into 2 and 4 in-process shards
DIST_CE = {"T": 6144, "H": 2048, "V": 50304, "shards": (2, 4)}
# dist_one_card (b): a world of one rank, gpt3-1.3b widths cut to 2 layers
DIST_STEP = {"preset": "gpt3-1.3b", "layers": 2, "B": 3, "S": 2048,
             "steps": 3}
# --multi-gpu: parity at gpt3-1.3b widths cut to 2 layers, f32, on each
# mesh against the single-card step, and bench_gpt_dp's DP+TP cell at
# gpt3-6.7b's full width on dp2 x mp2
MG_WORLD = 4
MG_PARITY = {"preset": "gpt3-1.3b", "layers": 2, "B": 4, "S": 512,
             "steps": 3, "clip": 0.05, "meshes": ({"dp": 2, "mp": 2},
                                                  {"dp": 1, "mp": 4})}
MG_FULL = {"preset": "gpt3-6.7b", "mesh": {"dp": 2, "mp": 2}, "B": 8,
           "S": 2048, "N": 5, "recompute": False}
MG_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "linear_ce_fwd")
# --multi-gpu, tensor-parallel paged serving: parity at gpt3-1.3b widths
# cut to 2 layers (f32 and bf16, seed 0) on mp4 and on a dp2 x mp2 mesh
# (two engines, leaders 0 and 2) against the one-card engine on the
# leader's card, then bench_decode_paged_mp's cell at full width
MG_SERVE = {"preset": "gpt3-1.3b", "layers": 2, "B": 8, "cap": 128,
            "new": 32, "chunk": 16, "requests": 8}
MG_SERVE_FULL = {"preset": "gpt3-1.3b", "mp": 4, "B": 8, "cap": 128,
                 "new": 128, "chunk": 32, "requests": 48, "seed": 3}
SERVE_KERNELS = ("paged_attention", "paged_attention_q8",
                 "paged_prefix_attention", "paged_prefix_attention_q8",
                 "int8_matmul")
# the default run's world-of-one serving leg (dist_one_card)
DIST_SERVE = {"preset": "gpt3-1.3b", "layers": 2, "B": 8, "cap": 128,
              "new": 32, "chunk": 16, "requests": 8}


def foreign_modules():
    """The JAX or JAX-package modules this process imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def phase_dist_one_card(torch, device, card):
    """The multi-GPU slice's paths that one card exercises. (a) #11's
    vocab-parallel route at gpt3-1.3b's head (T = 3 x 2048, H 2048, V
    50304) over 2 and 4 in-process shards (`linear_cross_entropy_shards`:
    the kernel on each shard, labels shifted by its offset, then
    `vocab_parallel_merge`), in bf16 and f32, held against whole-vocabulary
    #11 and the plain version within #11's loss limit (CE_TOL); the
    control merges all but the last shard and must fail that limit. (b)
    `init_parallel_env` over NCCL at world size 1 (a file store in a
    temporary directory) and `TrainStep(mesh=build_mesh({"dp": 1, "mp":
    1}))` at gpt3-1.3b widths cut to 2 layers, bf16, 3 AdamW steps with
    the clip: losses, parameters and launch counts bitwise equal to the
    same steps without a mesh; the process group is destroyed after."""
    import os
    import tempfile
    import numpy as np
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import (AdamW, ClipGradByGlobalNorm,
                                  GPTForCausalLM, TrainStep, gpt_config)
    from paddle_tpu_torch.distributed import mpu
    from paddle_tpu_torch.ops import linear_ce as LC
    from paddle_tpu_torch.ops.cuda import build as KB
    from paddle_tpu_torch.ops.cuda import linear_ce as KL
    t0 = time.perf_counter()
    run = timer(torch, device)
    t, h, v = DIST_CE["T"], DIST_CE["H"], DIST_CE["V"]
    rows, route_launches = [], 0
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        x, w, labels, _ = ce_inputs(torch, device, t, h, v, "vh", dtype)
        whole, whole_lse = KL.linear_ce_fwd_cuda(x, w, labels)
        plain = LC.linear_cross_entropy_reference(x, w, labels)
        ltol = CE_TOL[dt][0]
        for n in DIST_CE["shards"]:
            vs = v // n
            shards = [mpu.shard_of(w, 0, 1, r, n) for r in range(n)]
            before = LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"]
            loss, lse = LC.linear_cross_entropy_shards(x, shards, labels)
            route_launches += LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"] \
                - before
            per = [KL.linear_ce_fwd_cuda(x, s, labels - r * vs)
                   for r, s in enumerate(shards)]
            ctl, _ = LC.vocab_parallel_merge(
                torch.stack([p[1] for p in per[:-1]]),
                torch.stack([p[0] for p in per[:-1]]))
            torch.cuda.synchronize()
            row = {"dtype": dt, "shards": n, "tol_loss_abs": ltol,
                   "labels_in_every_shard":
                       set((labels // vs).tolist()) == set(range(n)),
                   "err_vs_plain": float((loss - plain).abs().max()),
                   "err_vs_whole_kernel": float((loss - whole).abs().max()),
                   "lse_err_vs_whole_kernel":
                       float((lse - whole_lse).abs().max()),
                   "control": "the merge without the last shard",
                   "control_err_vs_plain": float((ctl - plain).abs().max())}
            row["control_rejected"] = row["control_err_vs_plain"] > ltol
            if dt == "bfloat16":
                row["route_ms"] = run(lambda: LC.linear_cross_entropy_shards(
                    x, shards, labels))
                row["whole_kernel_ms"] = run(
                    lambda: KL.linear_ce_fwd_cuda(x, w, labels))
            check(row["labels_in_every_shard"]
                  and row["err_vs_plain"] <= ltol
                  and row["err_vs_whole_kernel"] <= ltol
                  and row["control_rejected"],
                  f"dist_one_card: the vocab-parallel merge: {row}")
            rows.append(row)
            del shards, per, ctl
        del x, w, labels, whole, whole_lse, plain
        torch.cuda.empty_cache()
    # (b) the degenerate mesh
    cfg = gpt_config(DIST_STEP["preset"], num_layers=DIST_STEP["layers"])
    B_, S_, n = DIST_STEP["B"], DIST_STEP["S"], DIST_STEP["steps"]
    ids = torch.from_numpy(np.random.RandomState(70).randint(
        0, cfg.vocab_size, (n, B_, S_)).astype(np.int64)).to(device)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp, \
            env_set(RANK="0", WORLD_SIZE="1",
                    LOCAL_RANK=str(device.index or 0)):
        env = D.init_parallel_env(
            init_method="file://" + os.path.join(tmp, "store"))
        try:
            backend, on = D.get_group().backend, str(env.device)
            mesh = D.build_mesh({"dp": 1, "mp": 1})
            for meshed in (False, True):
                D.set_mesh(mesh if meshed else None)
                model = GPTForCausalLM(cfg, device=device,
                                       dtype=torch.bfloat16, seed=0)
                model.train()
                opt = AdamW(1e-4, parameters=model.named_parameters(),
                            moment_dtype="bfloat16",
                            grad_clip=ClipGradByGlobalNorm(1.0),
                            device=device)
                step = TrainStep(model, opt, lambda a, b: model.loss(a, b),
                                 mesh=mesh if meshed else None,
                                 device=device)
                KB.reset_launch_counts()
                losses = torch.stack([step(ids[i], ids[i])
                                      for i in range(n)])
                torch.cuda.synchronize()
                runs[meshed] = (losses, {k: p.detach().clone() for k, p in
                                         model.named_parameters()},
                                dict(KB.LAUNCHES))
                D.set_mesh(None)
                del step, opt, model
            torch.cuda.empty_cache()
            serve_rec = world_of_one_serving(torch, device, mesh)
        finally:
            D.destroy_parallel_env()
    (l0, p0, c0), (l1, p1, c1) = runs[False], runs[True]
    step_rec = {"config": {**DIST_STEP, "dtype": "bfloat16",
                           "optimizer": "AdamW(1e-4, bf16 moments), "
                                        "ClipGradByGlobalNorm(1.0)"},
                "backend": backend, "world_size": 1,
                "device": on,
                "losses_no_mesh": l0.tolist(), "losses_mesh": l1.tolist(),
                "losses_bitwise": torch.equal(l0, l1),
                "params_bitwise": all(torch.equal(p0[k], p1[k]) for k in p0),
                "launches_equal": c0 == c1,
                "launches": {k: c1[k] for k in MG_KERNELS},
                "group_destroyed": not D.is_initialized()}
    out = {"phase": "dist_one_card", "ok": True, "card": card,
           "vocab_parallel_merge": rows,
           # the route's #11 launches in the checks above (not the timing)
           "vocab_parallel_route_launches": route_launches,
           "degenerate_mesh": step_rec, "world_of_one_serving": serve_rec,
           "seconds": time.perf_counter() - t0}
    check(backend == "nccl" and step_rec["losses_bitwise"]
          and step_rec["params_bitwise"] and step_rec["launches_equal"]
          and all(c1[k] > 0 for k in MG_KERNELS)
          and step_rec["group_destroyed"],
          f"dist_one_card: the world-size-1 mesh step: {step_rec}")
    emit(out)
    del runs, p0, p1
    torch.cuda.empty_cache()
    return route_launches


def world_of_one_serving(torch, device, mesh):
    """The sharded serving engine over a world of one (`shards=1` under a
    mesh with an mp axis of 1): every device op packed, unpacked and run
    through the runner's handlers (its header broadcast is a no-op at one
    rank) on a serving table copied from wte. At mp 1 the model is the
    one-card model, so the row-parallel f32 reduction, the max-reduced
    int8 scales and #5's f32-y form do not run here (`--multi-gpu`'s
    serving_parity_mp holds them). Its chains must equal the one-card
    engine's bit for bit, fp and int8 weights, with #1 (and #5)
    launched."""
    import numpy as np
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import (GPTForCausalLM, ServingConfig,
                                  ServingEngine, gpt_config,
                                  synthetic_traffic)
    from paddle_tpu_torch.ops.cuda import build as KB
    t0 = time.perf_counter()
    p = DIST_SERVE
    cfg = gpt_config(p["preset"], num_layers=p["layers"])
    prompts = [t["prompt"] for t in synthetic_traffic(
        p["requests"], prompt_cap=p["cap"], vocab_size=cfg.vocab_size,
        rate=1e9, seed=3, length_dist="longtail")]
    legs = {}
    for wd in (None, "int8"):
        chains, launches = {}, {}
        for sharded in (False, True):
            D.set_mesh(mesh if sharded else None)
            model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                                   seed=0)
            eng = ServingEngine(model, ServingConfig(
                max_batch=p["B"], prompt_cap=p["cap"], max_new_tokens=p["new"],
                decode_chunk=p["chunk"], paged=True, weight_dtype=wd,
                shards=1 if sharded else None))
            D.set_mesh(None)
            KB.reset_launch_counts()
            reqs = [eng.submit(q) for q in prompts]
            eng.drain()
            torch.cuda.synchronize()
            launches[sharded] = {k: KB.LAUNCHES[k] for k in
                                 ("paged_attention", "int8_matmul")}
            chains[sharded] = np.stack([r.tokens for r in reqs])
            if sharded:
                runner = eng.runner_summary()
                through = eng._runner is not None and \
                    model.gpt.serving_wte is not None
            eng.close()
            del eng, model
        legs[str(wd)] = {"chains_bitwise": bool(np.array_equal(
            chains[False], chains[True])), "launches": launches[True],
            "launches_equal": launches[False] == launches[True],
            "through_runner": through, "runner_ops": runner}
    rec = {"config": {**p, "dtype": "bfloat16",
                      "traffic": "synthetic_traffic longtail seed=3"},
           "legs": legs, "seconds": time.perf_counter() - t0}
    check(all(r["chains_bitwise"] and r["launches_equal"]
              and r["through_runner"] and r["launches"]["paged_attention"] > 0
              for r in legs.values())
          and legs["int8"]["launches"]["int8_matmul"] > 0,
          f"dist_one_card: the world-of-one sharded engine: {rec}")
    torch.cuda.empty_cache()
    return rec


def profile_dist_step(torch, fn, names=(), phase="multi_gpu_profile_rank0"):
    """`profile_call` for a step with collectives: one call of fn under
    torch.profiler, read by the port's trace analysis. NCCL kernels run on
    their own streams and may overlap compute, so the device's busy time
    is the union of every lane's intervals, the NCCL time is the trace
    analysis' collective ledger (`collective_rows`, `overlap`), and the
    2% cross-check against key_averages() covers the other kernels; both
    readers' NCCL sums are reported. The record is printed before the
    check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    an = capture_analysis(prof)
    is_nccl = lambda n: "nccl" in n.lower()      # noqa: E731
    trace_nccl = sum(e["dur"] for e in an.device_events if is_nccl(e["name"]))
    trace_other = an.total_device_us() - trace_nccl
    ka_nccl = ka_other = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
        if is_nccl(e.key):
            ka_nccl += us
        else:
            ka_other += us
    ov = an.overlap()
    union = ov["collective_us"] + ov["compute_busy_us"] - ov["overlapped_us"]
    rows = an.op_totals()
    out = {"wall_s": wall, "device_busy_union_s": union / 1e6,
           "device_idle_share": 1 - union / 1e6 / wall,
           "nccl_union_ms": ov["collective_us"] / 1e3,
           "nccl_share_of_busy": ov["collective_us"] / union if union
           else None,
           "nccl_overlapped_ms": ov["overlapped_us"] / 1e3,
           "compute_busy_union_ms": ov["compute_busy_us"] / 1e3,
           "nccl_sum_ms": {"trace_analysis": trace_nccl / 1e3,
                           "key_averages": ka_nccl / 1e3},
           "other_kernels_sum_ms": {"trace_analysis": trace_other / 1e3,
                                    "key_averages": ka_other / 1e3},
           "collectives": [{k: r[k] for k in ("name", "calls", "dur_us",
                                              "busy_us", "exposed_us")}
                           for r in an.collective_rows()[:6]],
           "top_device_ops": [{"op": r["name"],
                               "device_ms": r["dur_us"] / 1e3,
                               "count": r["calls"]} for r in rows[:8]],
           "named_device_ops": [{"op": r["name"],
                                 "device_ms": r["dur_us"] / 1e3,
                                 "count": r["calls"]} for r in rows
                                if any(n in r["name"] for n in names)]}
    emit({"phase": phase, "profile": out})
    check(abs(trace_other - ka_other) <= SUMMER_TOL * max(ka_other, 1e-9),
          f"trace analysis reads {trace_other} device us of non-NCCL "
          f"kernels, key_averages() {ka_other}")
    return out


def mg_gpt(torch, device, cfg, dtype, seed, mesh, **opt_kw):
    """A GPT (a TP shard under `mesh`), its AdamW and its TrainStep whose
    loss takes an optional loss mask."""
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    import paddle_tpu_torch.distributed as D
    D.set_mesh(mesh)
    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    model.train()
    opt = AdamW(parameters=model.named_parameters(), device=device,
                **opt_kw)
    step = TrainStep(model, opt, lambda *b: model.loss(*b[:2], loss_mask=(
        b[2] if len(b) > 2 else None)), mesh=mesh, device=device)
    return model, step


def mg_parity(torch, device, axes):
    """One rank's parity leg on mesh `axes`: the single-card step (every
    rank runs it from the same seed), then the mesh step from the same
    weights (the sharded init is the single-card one, cut), MG_PARITY's
    steps on a global batch whose loss mask is uneven across the dp
    halves; returns this rank's record."""
    import numpy as np
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import ClipGradByGlobalNorm, gather_state, \
        gpt_config
    from paddle_tpu_torch.ops import linear_ce as LC
    from paddle_tpu_torch.ops.cuda import build as KB
    p = MG_PARITY
    cfg = gpt_config(p["preset"], num_layers=p["layers"])
    rs = np.random.RandomState(60)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        p["steps"], p["B"], p["S"])).astype(np.int64)).to(device)
    mask = torch.ones(p["B"], p["S"], device=device)
    mask[p["B"] // 2:, p["S"] // 8:] = 0.0
    # epsilon 1e-6: the k projection's bias has a zero gradient in exact
    # arithmetic, and at 1e-8 AdamW would turn its roundoff into steps of
    # lr (as in the repo's CPU parity tests of steps)
    opt_kw = dict(learning_rate=1e-4, weight_decay=0.01, epsilon=1e-6,
                  grad_clip=ClipGradByGlobalNorm(p["clip"]))
    ref, step = mg_gpt(torch, device, cfg, torch.float32, 1, None, **opt_kw)
    ref.zero_grad(set_to_none=True)
    ref.loss(ids[0], ids[0], loss_mask=mask).backward()
    norm = float(torch.sqrt(sum(q.grad.double().square().sum()
                                for q in ref.parameters())))
    ref.zero_grad(set_to_none=True)
    want = [float(step(ids[i], ids[i], mask)) for i in range(p["steps"])]
    want_p = {k: q.detach().clone() for k, q in ref.named_parameters()}
    del ref, step
    torch.cuda.empty_cache()
    mesh = D.build_mesh(axes)
    model, step = mg_gpt(torch, device, cfg, torch.float32, 1, mesh,
                         **opt_kw)
    KB.reset_launch_counts()
    LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"] = 0
    got = [float(step(ids[i], ids[i], mask)) for i in range(p["steps"])]
    torch.cuda.synchronize()
    counts = {k: KB.LAUNCHES[k] for k in MG_KERNELS}
    vp = LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"]
    full = gather_state({k: q.detach() for k, q in
                         model.named_parameters()}, mesh)
    errs = {k: rel_err(full[k], want_p[k]) for k in want_p}
    worst = max(errs, key=errs.get)
    g = mesh.group("mp")
    replicated = [k for k, q in model.named_parameters()
                  if getattr(q, "mp_split", None) is None]
    rep_bitwise = all(
        all(torch.equal(parts[0], parts[i]) for i in range(1, len(parts)))
        for parts in (D.all_gather(dict(model.named_parameters())[k]
                                   .detach(), group=g)
                      for k in replicated))
    D.set_mesh(None)
    rec = {"mesh": axes, "rank": mesh.rank, "coords": mesh.coords,
           "losses": got, "single_card_losses": want,
           "loss_max_rel_err": max(abs(a - b) / abs(b)
                                   for a, b in zip(got, want)),
           "param_worst": worst, "param_worst_rel_to_max": errs[worst],
           "replicated_params": len(replicated),
           "replicated_bitwise_across_mp": rep_bitwise,
           "first_grad_norm": norm, "clip": p["clip"],
           "launches": counts, "vocab_parallel_launches": vp}
    check(rec["loss_max_rel_err"] <= 1e-5 and errs[worst] <= 1e-4
          and rep_bitwise and norm > p["clip"]
          and all(c > 0 for c in counts.values()) and vp > 0,
          f"multi-GPU parity on {axes}, rank {mesh.rank}: {rec}")
    del model, step, full, want_p
    torch.cuda.empty_cache()
    return rec


def mg_full(torch, device):
    """One rank's share of bench_gpt_dp's DP+TP cell at full width
    (MG_FULL): gpt3-6.7b, dp2 x mp2, bf16, AdamW(1e-4, bf16 moments), the
    global batch of B rows (each dp rank its B / 2), 2 warm steps, the
    best of 2 windows of N, then one step profiled on rank 0."""
    import numpy as np
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import gpt_config
    from paddle_tpu_torch.ops import linear_ce as LC
    from paddle_tpu_torch.ops.cuda import build as KB
    f = MG_FULL
    B_, S_, N = f["B"], f["S"], f["N"]
    cfg = gpt_config(f["preset"], max_position_embeddings=S_,
                     use_recompute=f["recompute"])
    mesh = D.build_mesh(f["mesh"])
    t_init = time.perf_counter()
    model, step = mg_gpt(torch, device, cfg, torch.bfloat16, 0, mesh,
                         learning_rate=1e-4, moment_dtype="bfloat16")
    t_init = time.perf_counter() - t_init
    mp = mesh.axis_size("mp")
    n_params = sum(q.numel() * (mp if getattr(q, "mp_split", None)
                                else 1) for q in model.parameters())
    local_params = sum(q.numel() for q in model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (N + 2, B_, S_)).astype(np.int64)).to(device)
    warm = [float(step(ids[i], ids[i])) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KB.reset_launch_counts()
    LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"] = 0
    windows, losses = [], []
    for _ in range(2):
        D.barrier()
        t0 = time.perf_counter()
        ls = [step(ids[2 + i], ids[2 + i]) for i in range(N)]
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        losses = [float(x) for x in ls]
    counts = {k: KB.LAUNCHES[k] for k in MG_KERNELS}
    vp = LC.VOCAB_PARALLEL_LAUNCHES["linear_ce_fwd"]
    peak = torch.cuda.max_memory_allocated()
    D.barrier()
    if mesh.rank == 0:
        prof = profile_dist_step(torch, lambda: step(ids[2], ids[2]),
                                 names=("fwd_wg", "dq_wg", "dkv_wg",
                                        "lce_wg"))
    else:
        step(ids[2], ids[2])
        torch.cuda.synchronize()
        prof = None
    best = min(windows)
    L = cfg.num_layers
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "linear_ce_fwd": 1}
    per_step = {k: counts[k] / (2 * N) for k in want}
    rec = {"rank": mesh.rank, "coords": mesh.coords, "init_s": t_init,
           "params": n_params, "params_this_card": local_params,
           "warm_losses": warm, "last_window_losses": losses,
           "window_s": windows, "best_window_s": best,
           "peak_mem_bytes": peak, "launches_per_step": per_step,
           "vocab_parallel_launches": vp, "profile_step": prof}
    if prof is not None:
        rec.update(nccl_device_ms=prof["nccl_union_ms"],
                   nccl_share_of_busy=prof["nccl_share_of_busy"],
                   nccl_share_of_wall=prof["nccl_union_ms"]
                   / (prof["wall_s"] * 1e3),
                   device_idle_share=prof["device_idle_share"])
    check(all(math.isfinite(x) for x in warm + losses)
          and abs(warm[0] - math.log(cfg.vocab_size)) < 1.0
          and per_step == want and vp == 2 * N,
          f"gpt3-6.7b dp2 x mp2, rank {mesh.rank}: {rec}")
    D.set_mesh(None)
    del model, step
    torch.cuda.empty_cache()
    return rec


def watch_runner(torch, eng, group):
    """Wrap this rank's runner ops: each op's start time and this rank's
    serving-kernel launch counts at that moment, its forwards and the mp
    all-reduces it made, and a digest of every token tensor it returned
    (every rank's must be the same)."""
    import hashlib
    from paddle_tpu_torch.ops.cuda import build as KB
    rec = {"ops": [], "t": [], "counts": [], "digest": hashlib.sha256()}
    h = eng._runner.handlers
    fwd = {"prefill": lambda a: 1, "decode": lambda a: int(a[4]),
           "verify": lambda a: 1}

    def wrap(op, f):
        def run(*a, extra=None):
            rec["t"].append(time.perf_counter())
            rec["counts"].append({k: KB.LAUNCHES[k] for k in SERVE_KERNELS})
            before = group.all_reduces
            res = f(*a, extra=extra)
            rec["ops"].append((op, fwd.get(op, lambda a: 0)(a),
                               group.all_reduces - before))
            if op in fwd:
                t = res if torch.is_tensor(res) else res[0]
                rec["digest"].update(t.cpu().numpy().tobytes())
            return res
        return run
    for op in list(h):
        h[op] = wrap(op, h[op])
    return rec


def serve_legs(cfg, p):
    """mg_serving_parity's legs: (name, engine options, prompts, passes)."""
    from paddle_tpu_torch import (repeated_traffic, shared_prefix_traffic,
                                  synthetic_traffic)
    n, cap, v = p["requests"], p["cap"], cfg.vocab_size
    longtail = [t["prompt"] for t in synthetic_traffic(
        n, prompt_cap=cap, vocab_size=v, rate=1e9, seed=3,
        length_dist="longtail")]
    shared = [t["prompt"] for t in shared_prefix_traffic(
        n, n_prefixes=2, prefix_len=64, prompt_cap=cap, vocab_size=v,
        seed=3)]
    repeated = [t["prompt"] for t in repeated_traffic(
        n, n_prompts=2, prompt_len=64, vocab_size=v, seed=3)]
    return (("plain", {}, longtail, 1),
            ("prefix", dict(prefix_cache=True), shared, 2),
            ("chunked", dict(prefill_chunk=32), longtail, 1),
            ("spec", dict(prefix_cache=True, spec_decode=True, spec_k=4),
             repeated, 2),
            ("int8_kv", dict(cache_dtype="int8", prefix_cache=True,
                             prefill_chunk=32), shared, 2),
            ("int8_weights", dict(weight_dtype="int8"), longtail, 1))


def serve_chains(eng, prompts, passes):
    out = []
    for _ in range(passes):
        reqs = [eng.submit(q) for q in prompts]
        eng.drain()
        out.append([r.tokens.tolist() for r in reqs])
    return out


def mg_serving_parity(torch, device):
    """One rank's `serving_parity_mp`: for f32 and bf16 and each leg of
    `serve_legs`, the sharded engine on mp4 and on a dp2 x mp2 mesh (the
    leaders serve, the followers follow), then on each leader's card the
    one-card engine from the same seed on the same traffic. Records the
    chains' agreement (exact, or first divergence at a near-tie of the
    one-card model), the all-reduces a forward, a digest of the rank's
    tokens, a spill round trip and a cross-count rehydrate, and #1-#5's
    launches by the sharded engines on this rank."""
    import numpy as np
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import (GPTForCausalLM, ServingConfig,
                                  ServingEngine, gpt_config)
    from paddle_tpu_torch.ops.cuda import build as KB
    p = MG_SERVE
    t0 = time.perf_counter()
    cfg = gpt_config(p["preset"], num_layers=p["layers"])
    legs = serve_legs(cfg, p)
    meshes = {"mp4": D.build_mesh({"mp": 4}),
              "dp2_mp2": D.build_mesh({"dp": 2, "mp": 2})}
    base = dict(max_batch=p["B"], prompt_cap=p["cap"],
                max_new_tokens=p["new"], decode_chunk=p["chunk"], paged=True)
    launches = {k: 0 for k in SERVE_KERNELS}
    rank = D.get_rank()
    rec = {"rank": rank, "runs": []}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        single = None
        for mname, mesh in meshes.items():
            g = mesh.group("mp")
            leader = g.rank == 0
            D.set_mesh(mesh)
            model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=0)
            D.set_mesh(None)
            if leader and single is None:
                single = GPTForCausalLM(cfg, device=device, dtype=dtype,
                                        seed=0)
            for name, kw, prompts, passes in legs:
                D.set_mesh(mesh)
                eng = ServingEngine(model, ServingConfig(
                    **base, shards=mesh.axis_size("mp"), **kw))
                D.set_mesh(None)
                w = watch_runner(torch, eng, g)
                KB.reset_launch_counts()
                run = {"dtype": dt, "mesh": mname, "leg": name}
                if leader:
                    got = serve_chains(eng, prompts, passes)
                    spill = None
                    if name == "prefix":
                        blk = int(eng._prefix.match(prompts[0])[0][0])
                        pay = eng.read_block(blk)
                        dst = eng._pool.take(1)[0]
                        eng._spill_write(dst, pay)
                        back = eng.read_block(dst)
                        eng._pool.release([dst])
                        spill = {"round_trip_bitwise": all(
                            torch.equal(a, b) for a, b in zip(pay, back)),
                            "payload_shapes": [list(t.shape) for t in pay]}
                    eng.close()
                else:
                    eng.follow()
                torch.cuda.synchronize()
                for k in SERVE_KERNELS:
                    launches[k] += KB.LAUNCHES[k]
                ar_ok = all(made == 2 * cfg.num_layers * f for op, f, made
                            in w["ops"] if op in ("prefill", "decode",
                                                  "verify")) and \
                    all(made == 0 for op, f, made in w["ops"]
                        if op not in ("prefill", "decode", "verify"))
                run.update(ops=len(w["ops"]), allreduce_2L_per_forward=ar_ok,
                           forwards=sum(f for _, f, _ in w["ops"]),
                           token_digest=w["digest"].hexdigest())
                if leader:
                    one = ServingEngine(single, ServingConfig(**base, **kw))
                    want = serve_chains(one, prompts, passes)
                    div, ok = [], True
                    for a, b in zip(got, want):
                        d, o = near_ties(torch, single, prompts,
                                         [np.asarray(x) for x in a],
                                         [np.asarray(x) for x in b])
                        div += d
                        ok = ok and o
                    run.update(equal_chains=sum(
                        x == y for a, b in zip(got, want)
                        for x, y in zip(a, b)),
                        chains=sum(len(a) for a in got), diverged=div,
                        near_tie_ok=ok)
                    if spill is not None:
                        # a block spilled at this shard count rehydrates
                        # bitwise into the one-card pool
                        dst = one._pool.take(1)[0]
                        one._spill_write(dst, pay)
                        spill["cross_count_bitwise"] = all(
                            torch.equal(a, b) for a, b in
                            zip(pay, one.read_block(dst)))
                        one._pool.release([dst])
                        spill["payload_bytes"] = sum(
                            t.numel() * t.element_size() for t in pay)
                        run["spill"] = spill
                    del one
                rec["runs"].append(run)
                del eng
            del model
            torch.cuda.empty_cache()
        del single
        torch.cuda.empty_cache()
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    for run in rec["runs"]:
        check(run["allreduce_2L_per_forward"],
              f"serving parity: an op's all-reduces are not 2L a forward: "
              f"{run}")
        if "near_tie_ok" in run:
            check(run["near_tie_ok"], f"serving parity: chains diverge "
                                      f"beyond a near-tie: {run}")
            if "spill" in run:
                check(run["spill"]["round_trip_bitwise"]
                      and run["spill"]["cross_count_bitwise"],
                      f"serving parity: a spilled block moved: {run}")
    check(all(v > 0 for v in launches.values()),
          f"serving parity, rank {rank}: a serving kernel never launched: "
          f"{launches}")
    return rec


def mg_serving_full(torch, device):
    """One rank's `serving_gpt3_1.3b_mp4`: bench_decode_paged_mp's cell
    (MG_SERVE_FULL): gpt3-1.3b bf16 at mp 4, B=8, cap 128, 128 new,
    chunks of 32, 48 longtail requests from seed 3, warmed with the first
    8; then one pure decode chunk profiled on rank 0; then on rank 0 the
    one-card twin under the same warmup. Every rank sets the launch counts
    to 0 right after building its engine; each rank's wall and launches
    of the timed window (from its ops' start times and counts, the
    window's op indices broadcast by the leader) exclude the warmup, the
    profiled chunk and the drain. The walls go to rank 0's
    record_shard_steps."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import (GPTForCausalLM, ServingConfig,
                                  ServingEngine, ServingMetrics, gpt_config,
                                  synthetic_traffic)
    from paddle_tpu_torch.ops.cuda import build as KB
    from paddle_tpu_torch.profiler import StepMonitor
    f = MG_SERVE_FULL
    cfg = gpt_config(f["preset"])
    traffic = [t["prompt"] for t in synthetic_traffic(
        f["requests"], prompt_cap=f["cap"], vocab_size=cfg.vocab_size,
        rate=1e9, seed=f["seed"], length_dist="longtail")]
    conf = dict(max_batch=f["B"], prompt_cap=f["cap"],
                max_new_tokens=f["new"], decode_chunk=f["chunk"], paged=True)
    mesh = D.build_mesh({"mp": f["mp"]})
    g = mesh.group("mp")
    D.set_mesh(mesh)
    # peak memory a card: weights, tables, pools and the run, every rank
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16, seed=0)
    eng = ServingEngine(model, ServingConfig(**conf, shards=f["mp"]))
    D.set_mesh(None)
    w = watch_runner(torch, eng, g)
    KB.reset_launch_counts()          # every rank, before any op
    B = f["B"]

    def timed(e, marks=None):
        """The bench's run: warm with the first B requests, then every
        request with the queue kept below B; `marks` receives this
        rank's op count at the window's start and end. Its launches are
        the window's (the counts' difference across it)."""
        for q in traffic[:B]:
            e.submit(q)
        e.drain()
        e.metrics = ServingMetrics()
        rc0 = e.monitor.recompiles
        torch.cuda.synchronize()
        before = {k: KB.LAUNCHES[k] for k in SERVE_KERNELS}
        if marks is not None:
            marks.append(len(w["t"]))
        t0 = time.perf_counter()
        for q in traffic:
            e.submit(q)
            while e.queue_depth >= B:
                e.step()
        while e.busy:
            e.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if marks is not None:
            marks.append(len(w["t"]))
        s = e.summary()
        return {"tokens_out": e.metrics.counters["tokens_out"],
                "seconds": dt,
                "tokens_per_s": e.metrics.counters["tokens_out"] / dt,
                "ttft_p50_s": s["ttft_seconds"]["p50"],
                "tpot_p50_s": s["tpot_seconds"]["p50"],
                "steady_recompiles": e.monitor.recompiles - rc0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "pool_bytes": e._pool.num_blocks * e._pool.bytes_per_block,
                "launches": {k: KB.LAUNCHES[k] - before[k]
                             for k in SERVE_KERNELS}}
    window = torch.zeros(2, dtype=torch.int64, device=device)
    prof = None
    if eng.is_leader:
        marks = []
        res = timed(eng, marks)
        # one pure decode chunk, profiled: admit B (prefills and a first
        # chunk), then the next step decodes only
        for q in traffic[:B]:
            eng.submit(q)
        eng.step()
        prof = profile_dist_step(torch, eng.step, names=("decode_part",),
                                 phase="serving_mp4_profile_rank0")
        eng.drain()
        eng.close()
        window[0], window[1] = marks[0], marks[1]
    else:
        eng.follow()
        res = {}
    torch.cuda.synchronize()
    res.update(peak_mem_bytes=torch.cuda.max_memory_allocated(),
               pool_bytes=eng._pool.num_blocks * eng._pool.bytes_per_block,
               tables_bytes=eng._tables_bytes,
               runner=eng.runner_summary(),
               allreduce_2L_per_forward=all(
                   made == 2 * cfg.num_layers * n for op, n, made in w["ops"]
                   if op in ("prefill", "decode")))
    D.broadcast(window, src=g.ranks[0], group=g)
    i0, i1 = (int(x) for x in window.tolist())
    # the window's ops are i0 .. i1 - 1; op i1 (the profiled chunk's
    # first) starts after them on every rank
    res["launches"] = {k: w["counts"][i1][k] - w["counts"][i0][k]
                       for k in SERVE_KERNELS}
    res["window_ops"] = i1 - i0
    wall = torch.tensor([w["t"][i1] - w["t"][i0]], dtype=torch.float64,
                        device=device)
    walls = D.all_gather(wall, group=g).view(-1).tolist()
    res["window_wall_s"] = walls[g.rank]
    rec = {"rank": D.get_rank(), "full": res}
    del eng, model
    torch.cuda.empty_cache()
    if g.rank == 0:
        mon = StepMonitor(track_memory=False)
        rec["shard_skew"] = mon.record_shard_steps(
            {r: x for r, x in enumerate(walls)}, step=0)
        rec["straggling"] = mon.straggling
        rec["profile"] = prof
        # the one-card twin on this card, under the same warmup
        torch.cuda.reset_peak_memory_stats()
        single = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                                seed=0)
        rec["single"] = timed(ServingEngine(single, ServingConfig(**conf)))
        del single
        torch.cuda.empty_cache()
    D.barrier()
    # the cell (fp weights and KV, whole-prompt prefills) runs #1 alone
    check(res["allreduce_2L_per_forward"]
          and res["launches"]["paged_attention"] > 0,
          f"serving mp4, rank {D.get_rank()}: {res}")
    return rec


def multi_gpu_rank(work_dir, training=True):
    """One rank of `--multi-gpu` (started by distributed.spawn with the
    rank environment set): NCCL on cuda:LOCAL_RANK, the training parity
    legs and full-width run (unless `training` is False), then the
    serving ones; its record goes to work_dir/rank{r}.json."""
    import torch
    import paddle_tpu_torch.distributed as D
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = D.init_parallel_env()
    device = env.device
    rec = {"rank": env.rank, "device": str(device),
           "backend": D.get_group().backend}
    path = Path(work_dir, f"rank{env.rank}.json")
    if training:
        rec["parity"] = []
        for axes in MG_PARITY["meshes"]:
            rec["parity"].append(mg_parity(torch, device, axes))
            path.write_text(json.dumps(rec))   # what a failure leaves
        rec["full"] = mg_full(torch, device)
        path.write_text(json.dumps(rec))
    rec["serving_parity"] = mg_serving_parity(torch, device)
    path.write_text(json.dumps(rec))
    rec["serving_full"] = mg_serving_full(torch, device)
    rec["foreign_modules"] = foreign_modules()
    check(rec["backend"] == "nccl" and not rec["foreign_modules"],
          f"rank {env.rank}: {rec['backend']}, {rec['foreign_modules']}")
    D.barrier()
    rec["complete"] = True
    path.write_text(json.dumps(rec))
    D.destroy_parallel_env()


def multi_gpu(torch, card, which="all") -> int:
    """`--multi-gpu`: MG_WORLD ranks on MG_WORLD cards (exits 2 with fewer
    cards): the kernels built once here, then the ranks spawned; their
    records become the phase lines. `which` "serving" leaves out the
    training phases (multi_gpu_parity, train_gpt3_6.7b_dp2_mp2)."""
    training = which == "all"
    import tempfile
    import paddle_tpu_torch.distributed as D
    n = torch.cuda.device_count()
    if n < MG_WORLD:
        print(f"chip_smoke.py --multi-gpu: {n} CUDA devices, needs "
              f"{MG_WORLD}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_build(torch, card)
    phase_int8_matmul_shards(torch, torch.device("cuda", 0), card)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    with tempfile.TemporaryDirectory() as work:
        try:
            D.spawn(multi_gpu_rank, args=(work, training), nprocs=MG_WORLD,
                    timeout=1000)
        except BaseException:
            # what the ranks finished, then the failure
            emit({"phase": "multi_gpu_partial", "ok": False, "ranks": [
                json.loads(Path(work, f"rank{r}.json").read_text())
                if Path(work, f"rank{r}.json").exists() else None
                for r in range(MG_WORLD)]})
            raise
        recs = [json.loads(Path(work, f"rank{r}.json").read_text())
                for r in range(MG_WORLD)]
    if training:
        mg_training_lines(recs, card, cards)
    serving_lines(recs, card, cards)
    check(not foreign_modules(), "JAX or the JAX package was imported")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": MG_WORLD}})
    return 0


def mg_training_lines(recs, card, cards):
    """The training phases' lines from the ranks' records."""
    for i, axes in enumerate(MG_PARITY["meshes"]):
        legs = [r["parity"][i] for r in recs]
        emit({"phase": "multi_gpu_parity", "ok": True, "card": card,
              "mesh": axes, "config": {**MG_PARITY, "meshes": None,
                                       "dtype": "float32",
                                       "optimizer": "AdamW(1e-4, wd 0.01, eps 1e-6)"},
              "limits": {"loss_rel": 1e-5, "param_rel_to_max": 1e-4,
                         "replicated": "bitwise across mp"},
              "ranks": legs})
    full = [r["full"] for r in recs]
    r0 = full[0]
    best = max(r["best_window_s"] for r in full)
    B_, S_, N = MG_FULL["B"], MG_FULL["S"], MG_FULL["N"]
    cfg_p = r0["params"]
    from paddle_tpu_torch import gpt_config
    cfg = gpt_config(MG_FULL["preset"], max_position_embeddings=S_)
    per_token = 6 * cfg_p + 12 * cfg.num_layers * cfg.hidden_size * S_
    tok_s = B_ * S_ * N / best
    emit({"phase": "train_gpt3_6.7b_dp2_mp2", "ok": True, "cards": cards,
          "model": cfg_line(cfg, "bfloat16"),
          "config": {**MG_FULL, "dtype": "bfloat16",
                     "optimizer": "AdamW(lr=1e-4, moment_dtype=bfloat16)",
                     "loss": "model.loss (vocab-parallel #11)",
                     "ids": "np.random.RandomState(0), labels = ids",
                     "timing": "2 warm steps, best of 2 windows of 5, "
                               "the slowest rank's"},
          "params": cfg_p, "ms_per_step": best / N * 1e3,
          "tokens_per_s": tok_s, "tokens_per_s_per_card": tok_s / MG_WORLD,
          "mfu": per_token * tok_s / (MG_WORLD * TENSOR_FLOPS_PER_S),
          "mfu_peak": "989 TFLOP/s dense bf16 a card (H100 SXM data sheet)",
          "peak_mem_bytes_per_card": [r["peak_mem_bytes"] for r in full],
          "nccl_device_ms_rank0": r0.get("nccl_device_ms"),
          "nccl_share_of_busy_rank0": r0.get("nccl_share_of_busy"),
          "nccl_share_of_wall_rank0": r0.get("nccl_share_of_wall"),
          "device_idle_share_rank0": r0.get("device_idle_share"),
          "ranks": full})


def serving_lines(recs, card, cards):
    """The serving phases' lines from the ranks' records, and their
    cross-rank gates."""
    from paddle_tpu_torch import gpt_config
    sp = [r["serving_parity"] for r in recs]
    digests = {}
    for rr in sp:
        for run in rr["runs"]:
            key = (run["dtype"], run["mesh"], run["leg"])
            digests.setdefault(key, []).append(run["token_digest"])
    same = {"/".join(k): len(set(v[:2])) == 1 and len(set(v[2:])) == 1
            if k[1] == "dp2_mp2" else len(set(v)) == 1
            for k, v in digests.items()}
    emit({"phase": "serving_parity_mp", "ok": True, "card": card,
          "config": {**MG_SERVE, "dtypes": ["float32", "bfloat16"],
                     "meshes": ["mp4", "dp2_mp2"], "seed": 0},
          "limits": {"chains": "equal, or first divergence at a near-tie "
                               "of the one-card model (f32 1e-3; bf16 two "
                               "units of the larger logit)",
                     "tokens": "bitwise across the ranks of an engine",
                     "all_reduces": "2 * num_layers a forward",
                     "spill": "bitwise round trip and cross-count "
                              "rehydrate"},
          "runs": [run for rr in sp for run in rr["runs"]
                   if "near_tie_ok" in run],
          "tokens_bitwise_across_ranks": same,
          "launches_per_rank": [rr["launches"] for rr in sp],
          "seconds": [rr["seconds"] for rr in sp]})
    check(all(same.values()), f"serving parity: ranks' tokens differ: "
                              f"{same}")
    sf = [r["serving_full"] for r in recs]
    s0 = sf[0]
    full, single = s0["full"], s0["single"]
    prof = s0["profile"]
    coll = [c for c in prof["collectives"] if "AllReduce" in c["name"]
            or "all_reduce" in c["name"].lower()]
    n_ar = sum(c["calls"] for c in coll)
    emit({"phase": "serving_gpt3_1.3b_mp4", "ok": True, "cards": cards,
          "model": cfg_line(gpt_config(MG_SERVE_FULL["preset"]), "bfloat16"),
          "config": {**MG_SERVE_FULL, "paged": True, "kv_block": 16,
                     "traffic": "synthetic_traffic longtail seed=3",
                     "source": "bench.py:652-738 bench_decode_paged_mp"},
          "tokens_per_s": full["tokens_per_s"],
          "single_card_tokens_per_s": single["tokens_per_s"],
          "mp_vs_single": full["tokens_per_s"] / single["tokens_per_s"],
          "ttft_p50_s": full["ttft_p50_s"], "tpot_p50_s": full["tpot_p50_s"],
          "single_card_ttft_p50_s": single["ttft_p50_s"],
          "single_card_tpot_p50_s": single["tpot_p50_s"],
          "steady_recompiles": full["steady_recompiles"],
          "single_card_steady_recompiles": single["steady_recompiles"],
          "peak_mem_bytes_per_card": [r["full"]["peak_mem_bytes"]
                                      for r in sf],
          "single_card_peak_mem_bytes": single["peak_mem_bytes"],
          "pool_bytes_per_card": full["pool_bytes"],
          "single_card_pool_bytes": single["pool_bytes"],
          "serving_tables_bytes_per_card": full["tables_bytes"],
          "runner_leader": full["runner"],
          "runner_followers": [r["full"]["runner"] for r in sf[1:]],
          "profiled_decode_chunk_rank0": {
              "tokens": MG_SERVE_FULL["chunk"],
              "nccl_all_reduce_calls": n_ar,
              "nccl_all_reduce_calls_per_token": n_ar
              / MG_SERVE_FULL["chunk"],
              "nccl_device_ms": prof["nccl_union_ms"],
              "nccl_share_of_busy": prof["nccl_share_of_busy"],
              "nccl_share_of_wall": prof["nccl_union_ms"]
              / (prof["wall_s"] * 1e3),
              "device_idle_share": prof["device_idle_share"],
              "wall_s": prof["wall_s"]},
          "shard_skew": s0["shard_skew"], "straggling": s0["straggling"],
          "window_ops_per_rank": [r["full"]["window_ops"] for r in sf],
          "launches_per_rank": [r["full"]["launches"] for r in sf]})
    check(full["steady_recompiles"] == 0 and
          n_ar == 2 * 24 * MG_SERVE_FULL["chunk"],
          f"serving mp4: recompiles {full['steady_recompiles']}, "
          f"{n_ar} NCCL all-reduces in a {MG_SERVE_FULL['chunk']}-token "
          f"chunk")
    # every rank ran the window's ops, so every rank launched the same
    check(all(r["full"]["launches"] == full["launches"] for r in sf),
          f"serving mp4: the ranks' window launches differ: "
          f"{[r['full']['launches'] for r in sf]}")


def parity_repeats(torch, device, card, n) -> int:
    """resnet_parity alone, n times: after each run's record, one line
    with the cases that ran again and the gates that failed."""
    bad = 0
    for i in range(n):
        try:
            rec, failed = phase_resnet_parity(torch, device, card), None
        except SmokeFailure as exc:
            bad += 1
            rec, failed = getattr(exc, "record", None), str(exc)
        cases = {} if rec is None else dict(
            rec["optimizers"], dgc_2p24p1=rec["dgc_2p24p1"])
        emit({"phase": "resnet_parity_repeat", "run": i,
              "rerun": {k: v["rerun"] for k, v in cases.items()
                        if "rerun" in v},
              "failed": failed})
    emit({"phase": "resnet_parity_repeats", "runs": n, "failed": bad})
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity-repeats", type=int, default=0, metavar="N",
                    help="run resnet_parity alone N times")
    ap.add_argument("--multi-gpu", nargs="?", const="all",
                    choices=("all", "serving"),
                    help=f"the multi-GPU run on {MG_WORLD} cards ("
                         f"'serving': its serving phases alone)")
    args = ap.parse_args(argv)
    repeats = args.parity_repeats
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
    if repeats:
        return parity_repeats(torch, device, card, repeats)
    if args.multi_gpu:
        return multi_gpu(torch, card, args.multi_gpu)

    phase_build(torch, card)
    kern = phase_kernels(torch, device, card)
    kern.update(phase_prefix_kernels(torch, device, card))
    kern.update(phase_int8_matmul(torch, device, card))
    # #6's phase ends with F.scaled_dot_product_attention (its yardstick)
    # and #11's starts with a #11 launch: that order once had the launch
    # refused with "invalid argument" while each kernel library linked a
    # runtime of its own, and it stays to show the shared runtime fixed it
    kern.update(phase_flash_kernels(torch, device, card))
    kern.update(phase_linear_ce(torch, device, card))
    kern.update(phase_fused_mha(torch, device, card))
    kern.update(phase_fused_mha_bias(torch, device, card))
    kern.update(phase_layer_norm(torch, device, card))
    kern.update(phase_flash_packed(torch, device, card))
    phase_engine_parity(torch, device, card)
    phase_engine_parity(torch, device, card, preset="gpt3-2.7b")
    phase_train_parity(torch, device, card)
    vocab_parallel = phase_dist_one_card(torch, device, card)
    phase_train_parity_fused(torch, device, card)
    phase_encoder_parity(torch, device, card)
    phase_swin_parity(torch, device, card)
    from paddle_tpu_torch import GPTForCausalLM, gpt_config
    model = GPTForCausalLM(gpt_config("gpt3-1.3b"), device=device,
                           dtype=torch.bfloat16, seed=0)
    launches = {}
    paged_runs = phase_serving(torch, model, card, launches)
    phase_prefix_spec(torch, model, card, launches)
    phase_slice3(torch, model, card, launches, paged_runs)
    phase_serving_ops(torch, model, card, launches, paged_runs)
    del model
    torch.cuda.empty_cache()
    counts, default = phase_train_full(torch, card, device)
    add_launches(launches, counts)
    counts, _ = phase_train_full(torch, card, device, fused=True,
                                 default=default)
    add_launches(launches, counts)
    add_launches(launches, phase_observability_train(torch, card, device))
    add_launches(launches, phase_train_gpt27(torch, card, device))
    add_launches(launches, phase_train_bert(torch, card, device))
    add_launches(launches, phase_train_vit(torch, card, device))
    add_launches(launches, phase_train_swin(torch, card, device))
    phase_resnet_parity(torch, device, card)
    phase_train_resnet50(torch, card, device, channels_last=True)
    phase_train_resnet50(torch, card, device, channels_last=False)
    phase_moe_parity(torch, device, card)
    phase_ernie_parity(torch, device, card)
    counts, moe = phase_train_gpt_moe(torch, card, device, experts=8)
    add_launches(launches, counts)
    counts, _ = phase_train_gpt_moe(torch, card, device, experts=0, moe=moe)
    add_launches(launches, counts)
    add_launches(launches, phase_train_ernie(torch, card, device))

    rows = []
    for name in ("paged_attention", "paged_attention_q8",
                 "paged_prefix_attention", "paged_prefix_attention_q8",
                 "int8_matmul", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "linear_ce_fwd", "fused_mha_fwd", "fused_mha_bwd",
                 "fused_mha_bias_fwd", "fused_mha_bias_bwd",
                 "layer_norm_fwd", "layer_norm_bwd", "flash_packed_fwd",
                 "flash_packed_bwd_dq", "flash_packed_bwd_dkv"):
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
        if name == "linear_ce_fwd":
            # the vocab-parallel route's launches of #11 (dist_one_card)
            rows[-1]["vocab_parallel_launches"] = vocab_parallel
    check(not any(m == "jax" or m.startswith(("jax.", "paddle_tpu."))
                  or m == "paddle_tpu" for m in sys.modules),
          "JAX or the JAX package was imported")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card_line(), flush=True)
    # the default run uses one device, cuda:0 (--multi-gpu uses four)
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
