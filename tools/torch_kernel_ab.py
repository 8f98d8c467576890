#!/usr/bin/env python3
"""Time variants of a kernel source against the checkout's, in one process
on one card.

    python3 tools/torch_kernel_ab.py [--source STEM] [VARIANT.cu ...]

Run from the root of a checkout on a machine with an NVIDIA GPU. STEM names
the source under `paddle_tpu_torch/ops/cuda/csrc/`: `flash_attention` (#6,
the default), `paged_prefix_attention` (#3 and #4) or `linear_ce` (#11).
Each VARIANT.cu is a full replacement of that source (same C entry
points); it is built with the package's nvcc flags beside a copy of the
headers, and its library stands in for the checkout's while it is timed.
At the shapes `chip_smoke.py` times the kernel, every library runs in
turns (checkout, variants, checkout, variants reversed), each timed as
`chip_smoke.py` times kernels (median of 50 launches, L2 flushed), with
its errors against the plain versions:
  * flash_attention: FLASH_TIMED, the forward, dQ and dK/dV kernels and
    their per-row errors;
  * paged_prefix_attention: every window of WINDOWS at head dims 128 and
    80, #3 and #4 in bf16, with the max abs error;
  * linear_ce: CE_TIMED, the forward, with the max abs loss error.
With no variant it times the checkout's kernels alone. Prints ptxas's
"Potential Performance Loss" lines (serialised wgmmas) of every build and
the kernels of each variant that spill, then one JSON line per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention", "paged_prefix_attention", "linear_ce")


def flash_cases(torch, cs, dev):
    """(case, {metric: fn}, errors fn) at FLASH_TIMED."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import flash_attention as KF
    for case in (c for c in cs.FLASH_CASES if c[0] in cs.FLASH_TIMED):
        name, b, sq, _, h, d, causal, _ = case
        leaves, split = cs.flash_leaves(torch, dev, case, torch.bfloat16)
        q, k, v = split(leaves)
        g = torch.Generator(device=dev).manual_seed(22)
        dout = torch.randn(b, sq, h, d, generator=g,
                           device=dev).to(torch.bfloat16)
        kw = dict(causal=causal, scale=d ** -0.5)
        po, _ = FA.flash_forward_reference(q, k, v, causal=causal)

        def timed(kw=kw, q=q, k=k, v=v, dout=dout):
            o, lse = KF.flash_fwd_cuda(q, k, v, **kw)
            delta = KF.flash_delta(o, dout)
            return {"fwd_ms": lambda: KF.flash_fwd_cuda(q, k, v, **kw),
                    "dq_ms": lambda: KF.flash_bwd_dq_cuda(
                        q, k, v, dout, lse, delta, **kw),
                    "dkv_ms": lambda: KF.flash_bwd_dkv_cuda(
                        q, k, v, dout, lse, delta, **kw)}

        def errors(kw=kw, q=q, k=k, v=v, dout=dout, po=po, causal=causal):
            o, lse = KF.flash_fwd_cuda(q, k, v, **kw)
            delta = KF.flash_delta(o, dout)
            dq = KF.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, **kw)
            dk, dv = KF.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, **kw)
            pg = FA.flash_bwd_reference(q, k, v, o, lse, dout, causal=causal)
            return {"row_err": [cs.row_err(a, r) for a, r in
                                zip((o, dq, dk, dv), (po, *pg))]}
        yield name, timed, errors


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


CASES = {"flash_attention": flash_cases,
         "paged_prefix_attention": prefix_cases, "linear_ce": ce_cases}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=SOURCES, default="flash_attention")
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
                row = errors()
                row.update({k: run(fn) for k, fn in timed().items()})
                res.setdefault(tag, []).append(row)
            KB._libs[stem] = libs["checkout"]
            print(json.dumps({"case": case, "source": stem,
                              "card": cs.card_line(), "runs": res}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
