#!/usr/bin/env python3
"""Time variants of a kernel source against the checkout's, in one process
on one card.

    python3 tools/torch_kernel_ab.py [--source STEM] [VARIANT.cu ...]
    python3 tools/torch_kernel_ab.py --sass-ops

Run from the root of a checkout on a machine with an NVIDIA GPU. STEM names
the source under `paddle_tpu_torch/ops/cuda/csrc/`: `flash_attention` (#6,
the default), `paged_prefix_attention` (#3 and #4), `linear_ce` (#11),
`fused_mha` (#9), `paged_attention` (#1 and #2), `int8_matmul` (#5),
`fused_mha_bias` (#10) or `layer_norm` (#8).
Each VARIANT.cu is a full replacement of that source (same C entry
points); it is built with the package's nvcc flags beside a copy of the
headers, and its library stands in for the checkout's while it is timed.
At the shapes `chip_smoke.py` times the kernel, every library runs in
turns (checkout, variants, checkout, variants reversed), each timed as
`chip_smoke.py` times kernels (median of 50 launches, L2 flushed), with
its errors against the plain versions:
  * flash_attention: every bf16 FLASH_CASES shape, the forward, dQ and
    dK/dV kernels, their per-row errors and a digest of their outputs (equal digests: bitwise
    equal outputs, so a parent's source shows whether the checkout's
    kernels still compute the same bits);
  * fused_mha: FMHA_TIMED, the forward and the backward (its three
    passes) and their per-row errors;
  * paged_attention: #1 and #2 in bf16 at head dims 128 and 80, with the
    max abs error;
  * paged_prefix_attention: every window of WINDOWS at head dims 128 and
    80, #3 and #4 in bf16, with the max abs error;
  * linear_ce: CE_TIMED, the forward, with the max abs loss error;
  * int8_matmul: every bf16 GEMM_CASES shape, with the max abs error and
    a digest of the output;
  * fused_mha_bias: FMB_TIMED, the forward (its plan pass included) and
    the backward, their per-row errors and a digest of their outputs;
  * layer_norm: every LN_CASES shape in bf16 with gamma and beta, the
    forward and the backward (both its launches), their errors against
    the plain versions and a digest of their outputs.
A library that refuses a shape (its launch raises) is recorded with the
error for that shape and timed no further there. With no variant it
times the checkout's kernels alone. Prints ptxas's
"Potential Performance Loss" lines (serialised wgmmas) of every build and
the kernels of each variant that spill, then one JSON line per shape.

--sass-ops builds the checkout's libraries and prints one JSON line: the
count of each opcode of SASS_OPS in every redesigned kernel that
`chip_smoke.py` checks (SASS_CHECKS), by its tag (`chip_smoke.redesigned`).
The dropout generator's integer work is #9's forward's excess over #6's at
the same head dim bucket.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention", "paged_prefix_attention", "linear_ce",
           "fused_mha", "paged_attention", "int8_matmul", "fused_mha_bias",
           "layer_norm")
SASS_OPS = ("IMAD", "LOP3", "SHF", "IADD3", "ISETP", "SEL", "FSEL", "MUFU",
            "FFMA", "FMUL", "HGMMA")


def digest(torch, *ts):
    """sha256 of the tensors' bytes (bitwise equal tensors, equal digests)"""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def flash_cases(torch, cs, dev):
    """(case, {metric: fn}, errors fn) at every bf16 FLASH_CASES shape
    (FLASH_TIMED: the shapes whose times the smoke reports)."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import flash_attention as KF
    for case in cs.FLASH_CASES:
        name, b, sq, _, h, d, causal, kv_len = case
        leaves, split = cs.flash_leaves(torch, dev, case, torch.bfloat16)
        q, k, v = split(leaves)
        g = torch.Generator(device=dev).manual_seed(22)
        dout = torch.randn(b, sq, h, d, generator=g,
                           device=dev).to(torch.bfloat16)
        kw = dict(causal=causal, scale=d ** -0.5, kv_len=kv_len)
        po, _ = FA.flash_forward_reference(q, k, v, causal=causal,
                                           kv_len=kv_len)

        def timed(kw=kw, q=q, k=k, v=v, dout=dout):
            o, lse = KF.flash_fwd_cuda(q, k, v, **kw)
            delta = KF.flash_delta(o, dout)
            return {"fwd_ms": lambda: KF.flash_fwd_cuda(q, k, v, **kw),
                    "dq_ms": lambda: KF.flash_bwd_dq_cuda(
                        q, k, v, dout, lse, delta, **kw),
                    "dkv_ms": lambda: KF.flash_bwd_dkv_cuda(
                        q, k, v, dout, lse, delta, **kw)}

        def errors(kw=kw, q=q, k=k, v=v, dout=dout, po=po, causal=causal,
                   kv_len=kv_len):
            o, lse = KF.flash_fwd_cuda(q, k, v, **kw)
            delta = KF.flash_delta(o, dout)
            dq = KF.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, **kw)
            dk, dv = KF.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, **kw)
            pg = FA.flash_bwd_reference(q, k, v, o, lse, dout, causal=causal,
                                        kv_len=kv_len)
            return {"row_err": [cs.row_err(a, r) for a, r in
                                zip((o, dq, dk, dv), (po, *pg))],
                    "digest": digest(torch, o, lse, dq, dk, dv)}
        yield name, timed, errors


def fmha_cases(torch, cs, dev):
    """#9 at FMHA_TIMED: the forward and the backward."""
    from paddle_tpu_torch.ops import fused_mha as FM
    from paddle_tpu_torch.ops.cuda import fused_mha as KM
    for case in (c for c in cs.FMHA_CASES if c[0] in cs.FMHA_TIMED):
        name, b, s, nh, hd, dt, causal, lens, p = case
        qkv, dout, kv, seed = cs.fmha_inputs(torch, dev, case)
        kw = dict(lens=kv, causal=causal, dropout_p=p, seed=seed)
        po = FM.fused_mha_reference(qkv, nh, **kw)
        pg = FM.fused_mha_bwd_reference(qkv, dout, nh, **kw)

        def timed(qkv=qkv, dout=dout, nh=nh, kw=kw):
            _, lse = KM.fused_mha_fwd_cuda(qkv, nh, **kw)
            return {"fwd_ms": lambda: KM.fused_mha_fwd_cuda(qkv, nh, **kw),
                    "bwd_ms": lambda: KM.fused_mha_bwd_cuda(qkv, dout, lse,
                                                            nh, **kw)}

        def errors(qkv=qkv, dout=dout, nh=nh, hd=hd, kw=kw, po=po, pg=pg):
            o, lse = KM.fused_mha_fwd_cuda(qkv, nh, **kw)
            g = KM.fused_mha_bwd_cuda(qkv, dout, lse, nh, **kw)
            errs = cs.fmha_errs(o, g, po, pg, nh, hd)
            return {"row_err": {n: e[0] for n, e in errs.items()},
                    "digest": digest(torch, o, lse, g)}
        yield name, timed, errors


def decode_cases(torch, cs, dev):
    """#1 and #2 in bf16 at head dims 128 and 80, phase 2's inputs."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    for q8 in (False, True):
        kern = K.paged_attention_q8_cuda if q8 else K.paged_attention_cuda
        plain = A.paged_attention_reference_q8 if q8 else \
            A.paged_attention_reference
        for d in (cs.D, 80):
            q, pools, tables, lens = cs.kernel_inputs(
                torch, dev, torch.bfloat16, q8, d)
            args = (q, *pools, tables, lens)
            want = plain(*args)

            def timed(kern=kern, args=args):
                return {"ms": lambda: kern(*args)}

            def errors(kern=kern, args=args, want=want):
                got = kern(*args)
                return {"max_abs_err": float((got.float() - want.float())
                                             .abs().max()),
                        "digest": digest(torch, got)}
            yield f"{'q8' if q8 else 'bf16'}_D{d}", timed, errors


def prefix_cases(torch, cs, dev):
    """#3 and #4 in bf16 at every window and head dims 128 and 80."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    for q8 in (False, True):
        kern = K.paged_prefix_attention_q8_cuda if q8 else \
            K.paged_prefix_attention_cuda
        plain = A.paged_prefix_attention_reference_q8 if q8 else \
            A.paged_prefix_attention_reference
        for s in cs.WINDOWS:
            for d in (cs.D, 80):
                q, pools, tables, start = cs.prefix_inputs(
                    torch, dev, torch.bfloat16, q8, s, d)
                args = (q, *pools, tables, start)
                want = plain(*args)

                def timed(kern=kern, args=args):
                    return {"ms": lambda: kern(*args)}

                def errors(kern=kern, args=args, want=want):
                    got = kern(*args)
                    return {"max_abs_err": float((got.float() - want.float())
                                                 .abs().max())}
                yield (f"{'q8' if q8 else 'bf16'}_S{s}_D{d}", timed, errors)


def ce_cases(torch, cs, dev):
    """#11's forward at CE_TIMED."""
    from paddle_tpu_torch.ops import linear_ce as LC
    from paddle_tpu_torch.ops.cuda import linear_ce as KL
    for name, t, h, v, layout, dt in cs.CE_CASES:
        if name not in cs.CE_TIMED:
            continue
        x, w, labels, _ = cs.ce_inputs(torch, dev, t, h, v, layout,
                                       getattr(torch, dt))
        want = LC.linear_cross_entropy_reference(x, w, labels, layout)

        def timed(x=x, w=w, labels=labels, layout=layout):
            return {"ms": lambda: KL.linear_ce_fwd_cuda(x, w, labels,
                                                        w_layout=layout)}

        def errors(x=x, w=w, labels=labels, layout=layout, want=want):
            got, _ = KL.linear_ce_fwd_cuda(x, w, labels, w_layout=layout)
            return {"max_abs_err": float((got - want).abs().max())}
        yield name, timed, errors


def gemm_cases(torch, cs, dev):
    """#5 in bf16 at every GEMM_CASES shape, phase 2's inputs."""
    from paddle_tpu_torch.ops.cuda import int8_matmul as KM
    from paddle_tpu_torch.ops.int8_matmul import int8_matmul_reference
    for m, name, k, n, layout in cs.GEMM_CASES:
        x, q, s = cs.gemm_inputs(torch, dev, m, k, n, layout,
                                 torch.bfloat16)
        want = int8_matmul_reference(x, q, s, layout)

        def timed(x=x, q=q, s=s, layout=layout):
            return {"ms": lambda: KM.int8_matmul_cuda(x, q, s,
                                                      w_layout=layout)}

        def errors(x=x, q=q, s=s, layout=layout, want=want):
            got = KM.int8_matmul_cuda(x, q, s, w_layout=layout)
            return {"max_abs_err": float((got.float() - want.float())
                                         .abs().max()),
                    "digest": digest(torch, got)}
        yield f"M{m}_{name}", timed, errors


def fmb_cases(torch, cs, dev):
    """#10 at FMB_TIMED: the forward and the backward."""
    from paddle_tpu_torch.ops import fused_mha_bias as FMB
    from paddle_tpu_torch.ops.cuda import fused_mha_bias as KMB
    for case in (c for c in cs.FMB_CASES if c[0] in cs.FMB_TIMED):
        name, b, s, nh, hd, r_n, dt, hw = case
        qkv, dout, bias = cs.fmb_inputs(torch, dev, case)
        po = FMB.fused_mha_bias_reference(qkv, bias, nh)
        pg, pb = FMB.fused_mha_bias_bwd_reference(qkv, bias, dout, nh)

        def timed(qkv=qkv, dout=dout, bias=bias, nh=nh):
            _, ml, plan = KMB.fused_mha_bias_fwd_cuda(qkv, bias, nh)
            return {"fwd_ms": lambda: KMB.fused_mha_bias_fwd_cuda(qkv, bias,
                                                                  nh),
                    "bwd_ms": lambda: KMB.fused_mha_bias_bwd_cuda(
                        qkv, bias, dout, ml, plan, nh)}

        def errors(qkv=qkv, dout=dout, bias=bias, nh=nh, hd=hd, po=po,
                   pg=pg, pb=pb):
            o, dq, db, _ = cs.fmb_run(KMB, qkv, bias, dout, nh)
            errs = cs.fmb_errs(o, dq, db, po, pg, pb, nh, hd)
            return {"row_err": {n: e[0] for n, e in errs.items()},
                    "digest": digest(torch, o, dq, db)}
        yield name, timed, errors


def ln_cases(torch, cs, dev):
    """#8 in bf16 with gamma and beta at every LN_CASES shape."""
    from paddle_tpu_torch.ops import layer_norm as LN
    from paddle_tpu_torch.ops.cuda import layer_norm as KL
    for name, r, h in cs.LN_CASES:
        x, g, b, dy = cs.ln_inputs(torch, dev, r, h, torch.bfloat16)
        po, _, _ = LN.fused_layer_norm_reference(x, g, b, 1e-5)

        def timed(x=x, g=g, b=b, dy=dy):
            _, mu, rs = KL.layer_norm_fwd_cuda(x, g, b, 1e-5)
            return {"fwd_ms": lambda: KL.layer_norm_fwd_cuda(x, g, b, 1e-5),
                    "bwd_ms": lambda: KL.layer_norm_bwd_cuda(dy, x, mu, rs,
                                                             g)}

        def errors(x=x, g=g, b=b, dy=dy, po=po):
            out, mu, rs = KL.layer_norm_fwd_cuda(x, g, b, 1e-5)
            dx, dg, db = KL.layer_norm_bwd_cuda(dy, x, mu, rs, g)
            pdx, pdg, pdb = LN.fused_layer_norm_bwd_reference(dy, x, mu, rs,
                                                              g)
            return {"row_err": {"out": cs.row_err(out, po),
                                "dx": cs.row_err(dx, pdx)},
                    "rel_err": {"dgamma": cs.rel_err(dg, pdg),
                                "dbeta": cs.rel_err(db, pdb)},
                    "digest": digest(torch, out, mu, rs, dx, dg, db)}
        yield name, timed, errors


def sass_op_counts(cs, KB):
    """{tag: {"total": instructions, opcode: count}} of every redesigned
    kernel in the libraries of chip_smoke's SASS_CHECKS."""
    libs = KB.build()
    tool = cs.cuobjdump(KB._nvcc())
    counts = {}
    for lib, (kernels, _) in cs.SASS_CHECKS.items():
        for name, text in cs.sass_by_kernel(tool, libs[lib]).items():
            tag = cs.redesigned(name)
            if tag is None or tag.partition("<")[0] not in kernels:
                continue
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", text)
            counts[tag] = {"total": len(ops), **{
                o: sum(1 for x in ops if x.split("_")[0] == o
                       or x.startswith(o + ".")) for o in SASS_OPS}}
    return counts


CASES = {"flash_attention": flash_cases,
         "paged_prefix_attention": prefix_cases, "linear_ce": ce_cases,
         "fused_mha": fmha_cases, "paged_attention": decode_cases,
         "int8_matmul": gemm_cases, "fused_mha_bias": fmb_cases,
         "layer_norm": ln_cases}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=SOURCES, default="flash_attention")
    ap.add_argument("--sass-ops", action="store_true",
                    help="print the redesigned kernels' opcode counts")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    stem = args.source
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops.cuda import build as KB
    if args.sass_ops:
        print(json.dumps({"card": cs.card_line(),
                          "sass_op_counts": sass_op_counts(cs, KB)}))
        return 0

    libs = {"checkout": KB.load_library(stem)}
    logs = {"checkout": (KB.BUILD_DIR / "nvcc.log").read_text()}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(args.variants):
            d = Path(tmp) / f"v{i}"
            d.mkdir()
            for h in KB.CSRC.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            shutil.copy(src, d / f"{stem}.cu")
            so = d / "lib.so"
            r = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-o", str(so),
                                str(d / f"{stem}.cu")],
                               capture_output=True, text=True)
            if r.returncode:
                print(f"{src}: nvcc failed\n{r.stderr[-3000:]}",
                      file=sys.stderr)
                return 1
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in KB._ENTRY_POINTS[stem].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            libs[src] = lib
            logs[src] = r.stdout + r.stderr
        for name, log in logs.items():
            for ln in log.splitlines():
                if "Potential Performance Loss" in ln and stem in ln:
                    print(f"{name}: {ln.strip()}")
            if name != "checkout":   # the smoke's build phase prints those
                spills = {k: n for k, n in cs.spill_bytes(log).items() if n}
                print(f"{name}: spill bytes {spills}")

        dev = torch.device("cuda", 0)
        run = cs.timer(torch, dev)
        names = list(libs)
        order = names + names[:1] + names[:0:-1]
        for case, timed, errors in CASES[stem](torch, cs, dev):
            res = {}
            for tag in order:
                KB._libs[stem] = libs[tag]
                try:
                    row = errors()
                    row.update({k: run(fn) for k, fn in timed().items()})
                except RuntimeError as exc:    # the library refused it
                    row = {"error": str(exc)}
                res.setdefault(tag, []).append(row)
            KB._libs[stem] = libs["checkout"]
            same = {tag: all(r.get("digest") == res["checkout"][0].get(
                "digest") for r in rows) for tag, rows in res.items()}
            print(json.dumps({"case": case, "source": stem,
                              "card": cs.card_line(), "runs": res,
                              "bitwise_equal_to_checkout": same}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
