"""Kernels #1-#4 (paged decode and window attention, fp and int8 pools) of
this checkout against those of another checkout, on the card: bitwise,
except the decode kernels (#1 and #2) and the windows (#3 and #4) with a
bf16 q, which are held to their phase-2 limits.

Head dims that are not a multiple of 32 take a masked instantiation of
the paged kernels; this test holds that every head dim the kernels took
before (32 to 256 by 32) still gives the other checkout's outputs (say,
an older commit unpacked with ``git archive``).
#3 and #4 in bf16 run a tensor-core tile kernel that rounds P (P *
v_scale for int8 pools) to bf16 once and sums in another order than the
warp-per-row kernel it replaced, so against a checkout from before that
kernel they are held to their phase-2 limit in `chip_smoke.py` (allclose
at 2e-2) instead. #1 and #2 split each row into partitions merged in a
fixed order: the same f32 arithmetic summed in another order than the
one-CTA-per-row kernel they replaced, so they too are held to their
phase-2 limits (allclose at 2e-2 in bf16, 1e-5 in f32); #3 and #4 in f32
stay bitwise.
Each checkout builds and runs its kernels in a process of its own, on
the inputs of `chip_smoke.py`'s phase 2. It needs an NVIDIA GPU and the
other checkout's path in ``PADDLE_TPU_TORCH_OTHER``, and skips without
either. On a machine with a card, without the JAX package's test
settings:

    PADDLE_TPU_TORCH_OTHER=DIR python3 tests/test_torch_paged_bitwise.py
"""
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
HEAD_DIMS = range(32, 257, 32)


def _dump(root, out):
    """Child: the kernels of the checkout at `root` on phase 2's inputs
    at every head dim in HEAD_DIMS, f32 and bf16, fp and int8 pools,
    decode and every window; saved to `out`."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch
    import paddle_tpu_torch
    assert paddle_tpu_torch.__file__.startswith(root), \
        f"imported {paddle_tpu_torch.__file__}, not the one in {root}"
    from paddle_tpu_torch.ops.cuda import paged_attention as K
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    res = {}
    for d in HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for q8 in (False, True):
                q, pools, tables, lens = smoke.kernel_inputs(torch, dev, dt,
                                                             q8, d)
                f = K.paged_attention_q8_cuda if q8 else \
                    K.paged_attention_cuda
                res[f"decode D={d} {dt} q8={q8}"] = f(q, *pools, tables,
                                                      lens).cpu()
                for w in smoke.WINDOWS:
                    q, pools, tables, st = smoke.prefix_inputs(
                        torch, dev, dt, q8, w, d)
                    f = K.paged_prefix_attention_q8_cuda if q8 else \
                        K.paged_prefix_attention_cuda
                    res[f"window S={w} D={d} {dt} q8={q8}"] = f(
                        q, *pools, tables, st).cpu()
    torch.save(res, out)


# #3 and #4 with a bf16 q: their phase-2 limit, not bitwise (see above)
TILE_TOL = 2e-2
# #1 and #2: their phase-2 limits by dtype (see above)
DECODE_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def _limit(key):
    """The allclose limit two checkouts' outputs are held to, None for
    bitwise."""
    dt = "bfloat16" if "bfloat16" in key else "float32"
    if key.startswith("decode"):
        return DECODE_TOL[dt]
    return TILE_TOL if dt == "bfloat16" else None


def compare(other):
    """{"compared": n, "differ": [keys]} of the two checkouts' outputs:
    keys whose outputs are not bitwise equal, or not within their limit
    (`_limit`)."""
    import torch
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, root in (("other", other), ("this", str(REPO))):
            outs[tag] = str(Path(tmp) / f"{tag}.pt")
            r = subprocess.run([sys.executable, __file__, "--dump", root,
                                outs[tag]], capture_output=True, text=True,
                               timeout=900)
            assert r.returncode == 0, \
                f"{tag} checkout failed: {r.stderr[-3000:]}"
        a, b = torch.load(outs["other"]), torch.load(outs["this"])
    assert a.keys() == b.keys()
    return {"compared": len(a),
            "differ": [k for k in a if not (
                torch.equal(a[k], b[k]) if _limit(k) is None else
                torch.allclose(a[k].float(), b[k].float(),
                               atol=_limit(k), rtol=_limit(k)))]}


@pytest.fixture
def other_checkout():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernels are CUDA only")
    other = os.environ.get("PADDLE_TPU_TORCH_OTHER")
    if not other:
        pytest.skip("PADDLE_TPU_TORCH_OTHER names no checkout to compare "
                    "with")
    return other


@pytest.mark.cuda
def test_paged_kernels_bitwise_equal_to_other_checkout(other_checkout):
    res = compare(other_checkout)
    assert not res["differ"], res


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dump"]:
        _dump(*sys.argv[2:4])
    else:
        res = compare(os.environ["PADDLE_TPU_TORCH_OTHER"])
        print({"compared": res["compared"],
               "equal": res["compared"] - len(res["differ"]),
               "differ": res["differ"]})
        sys.exit(1 if res["differ"] else 0)
