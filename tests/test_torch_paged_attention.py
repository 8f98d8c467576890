"""PyTorch port vs JAX package: paged KV writes, int8 KV quantization and
paged decode attention.

The port's `paged_attention` / `paged_attention_q8` take their plain
PyTorch route for CPU tensors; here that route is held against the JAX
Pallas kernels run in interpret mode (as tests/test_paged_kv.py runs them)
and against the JAX gather references, on the same numpy inputs. Rows
with lens == 0 are compared only where both sides define them (the kernel
gives zeros, the references masked-uniform garbage), i.e. not at all:
parity covers live rows.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops.pallas.paged_attention import (paged_attention_kernel,
                                                   paged_attention_q8_kernel)
from paddle_tpu_torch.ops import attention as tattn

# f32 on both sides; the two only differ in summation order
RTOL = ATOL = 2e-5
BS, NH, HD, MB = 4, 4, 32, 4


def _paged_inputs(lens, seed, q8=False):
    """Pools holding every row's positions [0, lens[b]) in its own
    blocks, scattered through the pool, plus q, tables and lens."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    nb = 1 + B * MB + 3
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, MB), np.int32)
    for b, ln in enumerate(lens):
        n = -(-ln // BS)
        tables[b, :n] = perm[b * MB:b * MB + n]
    q = (rng.randn(B, 1, NH, HD) * 0.5).astype(np.float32)
    if q8:
        codes = [rng.randint(-127, 128, (nb, BS, NH, HD)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.rand(nb, BS, NH) * 0.02 + 1e-3).astype(np.float32)
                  for _ in range(2)]
        pools = (codes[0], scales[0], codes[1], scales[1])
    else:
        pools = tuple((rng.randn(nb, BS, NH, HD) * 0.5).astype(np.float32)
                      for _ in range(2))
    return q, pools, tables, np.asarray(lens, np.int32)


LENS = [(5, 8, 1, 16), (4, 12, 7, 3), (16, 2, 9, 13)]


@pytest.mark.parametrize("lens", LENS)
def test_paged_attention_matches_jax_kernel_and_reference(lens):
    q, (kp, vp), tables, ln = _paged_inputs(lens, seed=sum(lens))
    got = tattn.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp),
                                torch.from_numpy(tables),
                                torch.from_numpy(ln)).numpy()
    jq, jk, jv, jt, jl = map(jnp.asarray, (q, kp, vp, tables, ln))
    kern = np.asarray(paged_attention_kernel(jq, jk, jv, jt, jl,
                                             interpret=True))
    ref = np.asarray(jattn.paged_attention_reference(jq, jk, jv, jt, jl))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lens", LENS)
def test_paged_attention_q8_matches_jax_kernel_and_reference(lens):
    q, pools, tables, ln = _paged_inputs(lens, seed=7 + sum(lens), q8=True)
    got = tattn.paged_attention_q8(
        torch.from_numpy(q), *map(torch.from_numpy, pools),
        torch.from_numpy(tables), torch.from_numpy(ln)).numpy()
    jargs = [jnp.asarray(a) for a in (q,) + pools + (tables, ln)]
    kern = np.asarray(paged_attention_q8_kernel(*jargs, interpret=True))
    ref = np.asarray(jattn.paged_attention_reference_q8(*jargs))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_paged_attention_score_dtype_matches_jax_reference():
    """The serving path passes score_dtype=model dtype; in bf16 the
    plain route rounds the stored scores like the JAX reference."""
    q, (kp, vp), tables, ln = _paged_inputs((5, 8, 1, 16), seed=3)
    bf = torch.bfloat16
    got = tattn.paged_attention(
        torch.from_numpy(q).to(bf), torch.from_numpy(kp).to(bf),
        torch.from_numpy(vp).to(bf), torch.from_numpy(tables),
        torch.from_numpy(ln), score_dtype=bf).float().numpy()
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    ref = jattn.paged_attention_reference(
        *j, jnp.asarray(tables), jnp.asarray(ln), score_dtype=jnp.bfloat16)
    # bf16 output: one bf16 ulp (2^-8 relative) of the largest values
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_paged_cache_write_matches_jax_exactly():
    rng = np.random.RandomState(11)
    nb = 12
    pool = rng.randn(nb, BS, NH, HD).astype(np.float32)
    new = rng.randn(4, 1, NH, HD).astype(np.float32)
    tables = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0],
                       [9, 10, 11, 2]], np.int32)
    lens = np.array([5, 3, 0, 17], np.int32)    # 17 clips to the last slot
    want = np.asarray(jattn.paged_cache_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(lens)))
    got = torch.from_numpy(pool.copy())
    tattn.paged_cache_write(got, torch.from_numpy(new),
                            torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_prefill_write_matches_jax_exactly():
    rng = np.random.RandomState(12)
    nb, S = 12, 8
    pool = np.zeros((nb, BS, NH, HD), np.float32)
    new = rng.randn(2, S, NH, HD).astype(np.float32)
    # row 1 holds one block: its columns past the table go to the trash
    # block 0, whose contents both sides leave to scatter order
    tables = np.array([[4, 6], [8, 0]], np.int32)
    want = np.asarray(jattn.paged_prefill_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables)))
    got = torch.from_numpy(pool.copy())
    tattn.paged_prefill_write(got, torch.from_numpy(new),
                              torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(13)
    x = (rng.randn(3, 5, NH, HD) * 2.0).astype(np.float32)
    jc, js = jattn.quantize_kv(jnp.asarray(x))
    tc, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    # codes may differ by one where x/scale sits on a rounding edge
    assert np.abs(tc.numpy().astype(np.int32)
                  - np.asarray(jc).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_q8_writes_match_jax():
    rng = np.random.RandomState(14)
    nb = 10
    new = rng.randn(3, 1, NH, HD).astype(np.float32)
    tables = np.array([[2, 3, 0, 0], [5, 0, 0, 0], [7, 8, 9, 0]], np.int32)
    lens = np.array([6, 1, 9], np.int32)
    codes = np.zeros((nb, BS, NH, HD), np.int8)
    scales = np.zeros((nb, BS, NH), np.float32)
    jc, js = jattn.paged_cache_write_q8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(tables), jnp.asarray(lens))
    tc, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    tattn.paged_cache_write_q8(tc, ts, torch.from_numpy(new),
                               torch.from_numpy(tables),
                               torch.from_numpy(lens))
    assert np.abs(tc.numpy().astype(np.int32)
                  - np.asarray(jc).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
