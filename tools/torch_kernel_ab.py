#!/usr/bin/env python3
"""Time variants of the flash-attention kernel source (#6) against the
checkout's, in one process on one card.

    python3 tools/torch_kernel_ab.py [VARIANT.cu ...]

Run from the root of a checkout on a machine with an NVIDIA GPU. Each
VARIANT.cu is a full replacement of
`paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu` (same C entry
points); it is built with the package's nvcc flags beside a copy of the
headers, and its library stands in for the checkout's while it is timed.
At the shapes `chip_smoke.py` times #6 (FLASH_TIMED), every library runs
the forward, dQ and dK/dV kernels in turns (checkout, variants, checkout,
variants reversed), each timed as `chip_smoke.py` times kernels (median of
50 launches, L2 flushed), with its per-row errors against the plain
versions. With no variant it times the checkout's kernels alone. Prints
ptxas's "Potential Performance Loss" lines (serialised wgmmas) of every
build, then one JSON line per shape.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(variants) -> int:
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import build as KB
    from paddle_tpu_torch.ops.cuda import flash_attention as KF

    libs = {"checkout": KB.load_library("flash_attention")}
    logs = {"checkout": (KB.BUILD_DIR / "nvcc.log").read_text()}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(variants):
            d = Path(tmp) / f"v{i}"
            d.mkdir()
            for h in KB.CSRC.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            shutil.copy(src, d / "flash_attention.cu")
            so = d / "lib.so"
            r = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-o", str(so),
                                str(d / "flash_attention.cu")],
                               capture_output=True, text=True)
            if r.returncode:
                print(f"{src}: nvcc failed\n{r.stderr[-3000:]}",
                      file=sys.stderr)
                return 1
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in KB._ENTRY_POINTS["flash_attention"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            libs[src] = lib
            logs[src] = r.stdout + r.stderr
        for name, log in logs.items():
            for ln in log.splitlines():
                if "Potential Performance Loss" in ln and \
                        "flash_attention" in ln:
                    print(f"{name}: {ln.strip()}")

        dev = torch.device("cuda", 0)
        run = cs.timer(torch, dev)
        names = list(libs)
        order = names + names[:1] + names[:0:-1]
        for case in (c for c in cs.FLASH_CASES if c[0] in cs.FLASH_TIMED):
            name, b, sq, _, h, d, causal, _ = case
            leaves, split = cs.flash_leaves(torch, dev, case,
                                            torch.bfloat16)
            q, k, v = split(leaves)
            g = torch.Generator(device=dev).manual_seed(22)
            dout = torch.randn(b, sq, h, d, generator=g,
                               device=dev).to(torch.bfloat16)
            kw = dict(causal=causal, scale=d ** -0.5)
            po, _ = FA.flash_forward_reference(q, k, v, causal=causal)
            res = {}
            for tag in order:
                KB._libs["flash_attention"] = libs[tag]
                o, lse = KF.flash_fwd_cuda(q, k, v, **kw)
                delta = KF.flash_delta(o, dout)
                dq = KF.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, **kw)
                dk, dv = KF.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                               **kw)
                pg = FA.flash_bwd_reference(q, k, v, o, lse, dout,
                                            causal=causal)
                res.setdefault(tag, []).append({
                    "fwd_ms": run(lambda: KF.flash_fwd_cuda(q, k, v, **kw)),
                    "dq_ms": run(lambda: KF.flash_bwd_dq_cuda(
                        q, k, v, dout, lse, delta, **kw)),
                    "dkv_ms": run(lambda: KF.flash_bwd_dkv_cuda(
                        q, k, v, dout, lse, delta, **kw)),
                    "row_err": [cs.row_err(a, r) for a, r in
                                zip((o, dq, dk, dv), (po, *pg))]})
            KB._libs["flash_attention"] = libs["checkout"]
            print(json.dumps({"case": name, "card": cs.card_line(),
                              "runs": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
