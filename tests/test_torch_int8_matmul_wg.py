"""Kernel #5's warpgroup route (bf16 x, "nk" layout: `i8_wg` in
`ops/cuda/csrc/int8_matmul.cu`) sized on the CPU before it reaches the
card.

The kernel computes y^T = W x^T with the codes as the wgmma's A operand,
widened in registers by a magic-number route: the code's sign bit flipped
gives c + 128, which as the low mantissa byte of 2^23 is the f32
2^23 + c + 128; subtracting 2^23 + 128 leaves c, and one round-to-nearest
cvt packs two codes as bf16. Here that route is emulated bit for bit in
numpy over every int8 value. The K extent is split over a thread-block
cluster: rank r sums code chunks [r * per, (r + 1) * per) of 128 (at up to
64 tokens a CTA, two warpgroups of the CTA take alternate chunks, their
partials added in warpgroup order), and the ranks' f32 partials meet in
rank order. That summation order is emulated
in f32 at `chip_smoke.py`'s GEMM_CASES widths with K cut to 256-1024 and
held against the plain version and the JAX `int8_matmul` in interpret
mode on the same numpy inputs, at the card phase's limits (1e-2 in bf16,
1e-4 in f32, rtol = atol). The launch plan (`wg_plan`) is a pure function
of the shape and the SM count, checked for every M the serving and
training paths run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.int8_matmul import int8_matmul as j_int8_matmul
from paddle_tpu_torch.ops.cuda import int8_matmul as KM
from paddle_tpu_torch.ops.int8_matmul import int8_matmul_reference

SMS = 132                                    # an H100 SXM
KS_SMALL = 2      # chunk warpgroups of i8_wg at up to 64 tokens (KS)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# chip_smoke.py's GEMM_WIDTHS (gpt3-1.3b) and GEMM_CASES' M
WIDTHS = {"qkv": (2048, 6144), "out": (2048, 2048), "up": (2048, 8192),
          "down": (8192, 2048), "lm_head": (2048, 50304)}
MS = (8, 72, 128, 1024)


def _instantiations():
    """(tokens a CTA, cluster sizes) `launch_nk_bf16` in int8_matmul.cu
    takes: the switch's cases and the cluster check, the one list the
    host's plan must keep within."""
    import re
    from pathlib import Path
    src = (Path(KM.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    body = src[src.index("cudaError_t launch_nk_bf16("):]
    body = body[:body.index("\n}\n")]
    tokens = tuple(int(t) for t in
                   re.findall(r"case (\d+): return launch_wg<\1,", body))
    clusters = tuple(int(c) for c in re.findall(r"cs != (\d+)", body))
    return tokens, clusters


WG_TOKENS, WG_CLUSTERS = _instantiations()


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4 i) & 7 of the eight bytes (x bytes 0-3, y bytes 4-7)."""
    src = (x.astype(np.uint64) | (y.astype(np.uint64) << 32))
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= (((src >> np.uint64(8 * b)) & np.uint64(0xFF))
                .astype(np.uint32) << np.uint32(8 * i))
    return out


def _bf16_rn_bits(f):
    """The bf16 bits cvt.rn.bf16x2.f32 gives for finite f32 values."""
    u = f.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _widen2(pair):
    """`widen2` of int8_matmul.cu: two codes (bits 0-7, 8-15 of a uint32)
    -> (lo, hi) bf16 bits."""
    u = pair ^ np.uint32(0x8080)
    magic = np.full_like(u, 0x4B000000)
    lo = _byte_perm(u, magic, 0x7440).view(np.float32) - np.float32(8388736)
    hi = _byte_perm(u, magic, 0x7441).view(np.float32) - np.float32(8388736)
    return _bf16_rn_bits(lo), _bf16_rn_bits(hi)


def test_widening_route_is_exact_for_every_code():
    """Every int8 value, in both halves of a pair, comes out as the bf16
    of float(code) (the -128 the quantizer never writes included)."""
    codes = np.arange(-128, 128, dtype=np.int64)
    lo_c, hi_c = np.meshgrid(codes, codes[::-1], indexing="ij")
    lo_c, hi_c = lo_c.ravel(), hi_c.ravel()
    pair = ((lo_c & 0xFF) | ((hi_c & 0xFF) << 8)).astype(np.uint32)
    lo, hi = _widen2(pair)
    want_lo = _bf16_rn_bits(lo_c.astype(np.float32))
    want_hi = _bf16_rn_bits(hi_c.astype(np.float32))
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    # and bf16 holds each code exactly: the low 16 bits of its f32 are 0
    f = codes.astype(np.float32).view(np.uint32)
    assert not np.any(f & 0xFFFF)
    back = (want_lo.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(back, lo_c.astype(np.float32))


def _split_k(x, q, s, cs, ks):
    """The kernel's sum for x [M, K] (x's dtype) and q [N, K]: f32 (f64
    for an f64 x) sums over each cluster rank's chunks, the rank's chunk i
    going to warpgroup i mod ks, each warpgroup's sum in chunk order, the
    warpgroups' added in order, then the ranks' in rank order; the scale
    on the sum, the cast to x's dtype."""
    m, k = x.shape
    c = KM.WG_CHUNK
    chunks = -(-k // c)
    per = -(-chunks // cs)
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, qf = x.to(wide), q.to(wide)
    acc = None
    for r in range(cs):
        own = range(r * per, min(chunks, (r + 1) * per))
        part = torch.zeros(m, q.shape[0], dtype=wide)
        for w in range(ks):
            wsum = torch.zeros(m, q.shape[0], dtype=wide)
            for i in list(own)[w::ks]:
                wsum = wsum + xf[:, i * c:(i + 1) * c] @ \
                    qf[:, i * c:(i + 1) * c].t()
            part = part + wsum
        acc = part if acc is None else acc + part
    return (acc * s).to(x.dtype)


def _inputs(m, k, n, seed):
    """chip_smoke.py's gemm_inputs at the scale of tests/
    test_int8_matmul.py (x*0.3, w*0.1, per-channel quantization), from
    numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.3).astype(np.float32)
    w = (rng.randn(n, k) * 0.1).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=1, keepdims=True) / 127.0, 1e-12)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return x, q, s.reshape(-1).astype(np.float32)


@pytest.mark.parametrize("k", [256, 1024])
@pytest.mark.parametrize("name", ["qkv", "out", "down"])
@pytest.mark.parametrize("m", [8, 72])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_k_order_stays_within_the_limits(m, name, k, dtype,
                                               monkeypatch):
    """The cluster's summation order at the plan's cluster size for the
    real width (GEMM_CASES' K cut to 256 or 1024, N cut to 512 for time),
    and at every cluster size the kernel takes, against the plain version
    and the JAX kernel in interpret mode."""
    n = min(WIDTHS[name][1], 512)
    x, q, s = _inputs(m, k, n, seed=m + k + n)
    xt = torch.from_numpy(x).to(dtype)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    plain = int8_matmul_reference(xt, qt, st, "nk").float()
    monkeypatch.setenv("PADDLE_TPU_INT8_MATMUL", "1")
    jax_x = jnp.asarray(xt.float().numpy(), jnp.bfloat16 if
                        dtype == torch.bfloat16 else jnp.float32)
    jk = np.asarray(j_int8_matmul(jax_x, jnp.asarray(q), jnp.asarray(s),
                                  w_layout="nk", interpret=True)
                    .astype(jnp.float32))
    tol = TOL[dtype]
    nt, _, plan_cs, _ = KM.wg_plan(m, WIDTHS[name][1], k, SMS)
    ks = KS_SMALL if nt <= 64 else 1
    for cs in sorted({plan_cs, *WG_CLUSTERS}):
        got = _split_k(xt, qt, st, cs, ks).float()
        torch.testing.assert_close(got, plain, rtol=tol, atol=tol)
        np.testing.assert_allclose(got.numpy(), jk, rtol=tol, atol=tol)


@pytest.mark.parametrize("ks", [1, KS_SMALL])
def test_split_k_order_is_a_reordering_only(ks):
    """In f64 the split sum equals the plain sum to rounding: a rank with
    no chunk (K of 3 chunks over 4 ranks), or a warpgroup with none, adds
    an exact zero."""
    x, q, s = _inputs(8, 384, 128, seed=5)
    xt, qt, st = (torch.from_numpy(a).double() for a in (x, q, s))
    want = (xt @ qt.t()) * st
    for cs in WG_CLUSTERS:
        got = _split_k(xt, qt, st, cs, ks)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _paths_ms():
    """Every M the model's int8 paths run at gpt3-1.3b widths: decode
    steps (1-8 live rows, ServingConfig(max_batch=8)), spec verify windows
    (B x (spec_k + 1), spec_k up to 8), prefill chunks (32), a paged
    prefill (128), the static prefill (8 x 128), the ragged case."""
    ms = set(range(1, 9)) | {b * (k + 1) for b in range(1, 9)
                             for k in range(1, 9)}
    return sorted(ms | {3, 32, 128, 1024})


def test_instantiations_read_from_the_source():
    assert WG_TOKENS == (8, 16, 32, 64, 128) and WG_CLUSTERS == (1, 2, 4)


def test_plan_is_cached():
    KM.wg_plan.cache_clear()
    KM.wg_plan(8, 6144, 2048, SMS)
    KM.wg_plan(8, 6144, 2048, SMS)
    assert KM.wg_plan.cache_info().hits == 1


@pytest.mark.parametrize("m", _paths_ms())
def test_plan_is_a_valid_instantiation_for_every_path_m(m):
    for name, (k, n) in WIDTHS.items():
        nt, nwg, cs, ctas = KM.wg_plan(m, n, k, SMS)
        assert nt in WG_TOKENS and cs in WG_CLUSTERS
        assert nwg == (1 if nt <= 64 else 2)
        if m <= 64:
            assert nt >= m and (nt == 8 or nt // 2 < m)   # least holding m
        else:
            assert nt in (64, 128)
        chunks = -(-k // KM.WG_CHUNK)
        assert cs == 1 or 4 * (cs // 2) <= chunks      # each rank >= 2
        tiles = -(-n // (64 * nwg)) * -(-m // nt)
        assert ctas == tiles * cs
        # the split grows only while the launch fits what the card holds
        held = 3 * SMS // 2 if nwg == 1 else SMS
        assert cs == 1 or ctas <= held


# GEMM_CASES' bf16 "nk" launches on an H100 (132 SMs): (tokens a CTA,
# warpgroups, cluster, CTAs)
PLANS = {
    (8, "qkv"): (8, 1, 2, 192), (8, "out"): (8, 1, 4, 128),
    (8, "up"): (8, 1, 1, 128), (8, "down"): (8, 1, 4, 128),
    (8, "lm_head"): (8, 1, 1, 786),
    (72, "qkv"): (128, 2, 2, 96), (72, "out"): (64, 1, 2, 128),
    (72, "up"): (128, 2, 2, 128), (72, "down"): (64, 1, 2, 128),
    (128, "qkv"): (128, 2, 2, 96), (128, "lm_head"): (128, 2, 1, 393),
    (1024, "qkv"): (128, 2, 1, 384), (1024, "out"): (128, 2, 1, 128),
    (1024, "up"): (128, 2, 1, 512), (1024, "down"): (128, 2, 1, 128),
}


@pytest.mark.parametrize("m, name", sorted(PLANS))
def test_plan_at_the_phase_shapes(m, name):
    k, n = WIDTHS[name]
    assert KM.wg_plan(m, n, k, SMS) == PLANS[(m, name)]


def test_decode_plans_fill_the_card():
    """At a decode step every width launches CTAs for at least 3/4 of the
    SMs (two fit an SM), so the weight stream runs on nearly every SM."""
    for name, (k, n) in WIDTHS.items():
        assert KM.wg_plan(8, n, k, SMS)[3] * 4 >= 3 * SMS, name


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# mangled names as nvcc 12 writes them for the slice's new kernels, and the
# tags chip_smoke.py's build phase files them under
MANGLED = {
    "_ZN47_GLOBAL__N__9aafbb6f_14_int8_matmul_cu_671d4bdd5i8_wgILi128ELi2ELi1"
    "ELi4EEEv14CUtensorMap_stS1_PKfP13__nv_bfloat16iiiii": ("i8_wg<128>",
                                                          True),
    "_ZN47_GLOBAL__N__9aafbb6f_14_int8_matmul_cu_671d4bdd5i8_wgILi8ELi1ELi2E"
    "Li8EEEv14CUtensorMap_stS1_PKfP13__nv_bfloat16iiiii": ("i8_wg<8>", True),
    "_ZN50_GLOBAL__N__6c111181_17_fused_mha_bias_cu_7b89f7688mhb_planENS_6"
    "ParamsE": ("mhb_plan", True),
    "_ZN50_GLOBAL__N__6c111181_17_fused_mha_bias_cu_7b89f7687mhb_fwdILi32ELi"
    "64EEEvNS_6ParamsE": ("mhb_fwd<32>", True),
    "_ZN50_GLOBAL__N__6c111181_17_fused_mha_bias_cu_7b89f7686mhb_dbILi32ELi3"
    "EEEvNS_6ParamsE": ("mhb_db<32>", True),
    "_ZN50_GLOBAL__N__6c111181_17_fused_mha_bias_cu_7b89f7687mhb_dkvILi64ELi"
    "32EEEvNS_6ParamsE": ("mhb_dkv<64>", False),
    "_ZN47_GLOBAL__N__9aafbb6f_14_int8_matmul_cu_671d4bdd10int8_mm_tcILi2ELi2"
    "ELi2ELi4ELi32EEEvPK13__nv_bfloat16PKaPKfPS1_iii": (None, None),
}


@pytest.mark.parametrize("name", sorted(MANGLED))
def test_build_phase_files_the_new_kernels(name):
    """chip_smoke.py's SASS and spill checks find #5's and #10's new
    kernels by these tags: every i8_wg instantiation and #10's at head
    dim 32 must spill nothing; the first design's kernels are no part of
    the checks."""
    cs = _chip_smoke()
    tag, must = MANGLED[name]
    assert cs.redesigned(name) == tag
    if tag is not None:
        assert cs.spill_free(tag) is must
        lib = "int8_matmul" if tag.startswith("i8_wg") else "fused_mha_bias"
        assert tag.partition("<")[0] in cs.SASS_CHECKS[lib][0]
