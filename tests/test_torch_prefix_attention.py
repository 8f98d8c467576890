"""PyTorch port vs JAX package: multi-token paged attention over a cached
prefix (suffix prefill, chunked prefill, speculative verify) and the
offset prefill writes that feed it.

The port's `paged_prefix_attention` / `paged_prefix_attention_q8` take
their plain PyTorch route for CPU tensors; here that route is held against
the JAX Pallas kernels run in interpret mode and against the JAX gather
references, on the same numpy inputs, over every query row (padding rows
included: both sides define them).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops.pallas.paged_attention import (
    paged_prefix_attention_kernel, paged_prefix_attention_q8_kernel)
from paddle_tpu_torch.ops import attention as tattn

# f32 on both sides; the two only differ in summation order
RTOL = ATOL = 2e-5
BS, NH, HD, MB = 4, 4, 8, 4


def _pools(n_rows, seed, q8=False):
    """n_rows table rows of MB blocks each, every position written through
    the JAX prefill write (codes and scales through its q8 form)."""
    rng = np.random.RandomState(seed)
    nb = 1 + n_rows * MB
    tables = np.arange(1, nb, dtype=np.int32).reshape(n_rows, MB)
    K = rng.randn(n_rows, MB * BS, NH, HD).astype(np.float32) * 0.3
    V = rng.randn(n_rows, MB * BS, NH, HD).astype(np.float32) * 0.3
    t = jnp.asarray(tables)
    if q8:
        kc = jnp.zeros((nb, BS, NH, HD), jnp.int8)
        ks = jnp.zeros((nb, BS, NH), jnp.float32)
        vc, vs = jnp.zeros_like(kc), jnp.zeros_like(ks)
        for b in range(n_rows):
            kc, ks = jattn.paged_prefill_write_q8(
                kc, ks, jnp.asarray(K[b:b + 1]), t[b:b + 1])
            vc, vs = jattn.paged_prefill_write_q8(
                vc, vs, jnp.asarray(V[b:b + 1]), t[b:b + 1])
        pools = (kc, ks, vc, vs)
    else:
        kp = jnp.zeros((nb, BS, NH, HD), jnp.float32)
        vp = jnp.zeros_like(kp)
        for b in range(n_rows):
            kp = jattn.paged_prefill_write(kp, jnp.asarray(K[b:b + 1]),
                                           t[b:b + 1])
            vp = jattn.paged_prefill_write(vp, jnp.asarray(V[b:b + 1]),
                                           t[b:b + 1])
        pools = (kp, vp)
    return tuple(np.asarray(p) for p in pools), tables


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# the (S, start) cases of the JAX package's multi-token kernel tests, plus
# a window whose frontier passes the table's extent (start + S > MB * BS)
@pytest.mark.parametrize("s,start", [
    (1, (8, 3, 0)),          # S = 1: the decode case
    (4, (4, 0, 1)),          # window starting at a block boundary
    (4, (3, 5, 0)),          # window crossing a block boundary
    (5, (11, 2, 7)),         # odd window, mixed offsets
    (8, (8, 0, 0)),          # two whole blocks
    (6, (14, 12, 0)),        # frontier past MB * BS
])
def test_prefix_attention_matches_jax_kernel_and_reference(s, start):
    (kp, vp), tables = _pools(3, seed=0)
    q = (np.random.RandomState(7).randn(3, s, NH, HD) * 0.3).astype(
        np.float32)
    st = np.asarray(start, np.int32)
    got = tattn.paged_prefix_attention(*_torch(q, kp, vp, tables,
                                               st)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, st)]
    kern = np.asarray(paged_prefix_attention_kernel(*jargs, interpret=True))
    ref = np.asarray(jattn.paged_prefix_attention_reference(*jargs))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,start", [(1, (8, 3)), (4, (4, 0)), (6, (10, 2)),
                                     (9, (15, 0))])
def test_prefix_attention_q8_matches_jax_kernel_and_reference(s, start):
    pools, tables = _pools(2, seed=1, q8=True)
    q = (np.random.RandomState(1).randn(2, s, NH, HD) * 0.3).astype(
        np.float32)
    st = np.asarray(start, np.int32)
    got = tattn.paged_prefix_attention_q8(
        *_torch(q, *pools, tables, st)).numpy()
    jargs = [jnp.asarray(a) for a in (q,) + pools + (tables, st)]
    kern = np.asarray(paged_prefix_attention_q8_kernel(*jargs,
                                                       interpret=True))
    ref = np.asarray(jattn.paged_prefix_attention_reference_q8(*jargs))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_prefix_attention_bf16_score_dtype_matches_jax_reference():
    """The serving path passes score_dtype=model dtype; in bf16 the plain
    route rounds the stored scores like the JAX reference."""
    (kp, vp), tables = _pools(3, seed=2)
    q = (np.random.RandomState(3).randn(3, 5, NH, HD) * 0.3).astype(
        np.float32)
    st = np.asarray((11, 2, 7), np.int32)
    bf = torch.bfloat16
    tq, tk, tv, tt, ts = _torch(q, kp, vp, tables, st)
    got = tattn.paged_prefix_attention(tq.to(bf), tk.to(bf), tv.to(bf), tt,
                                       ts, score_dtype=bf).float().numpy()
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    ref = jattn.paged_prefix_attention_reference(
        *j, jnp.asarray(tables), jnp.asarray(st), score_dtype=jnp.bfloat16)
    # bf16 output: within one bf16 ulp (2^-8 relative) of the values
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("q8", [False, True])
def test_k1_window_is_decode(q8):
    """A one-token window at start = lens - 1 attends exactly what the
    decode attention does with lens attendable rows."""
    pools, tables = _pools(3, seed=3, q8=q8)
    q = (np.random.RandomState(1).randn(3, 1, NH, HD) * 0.3).astype(
        np.float32)
    lens = np.asarray([9, 4, 1], np.int32)       # incl. a block boundary
    tq, *tp = _torch(q, *pools)
    tt, tl = _torch(tables, lens)
    if q8:
        got = tattn.paged_prefix_attention_q8(tq, *tp, tt, tl - 1)
        want = tattn.paged_attention_q8(tq, *tp, tt, tl)
        jwant = jattn.paged_attention_reference_q8(
            *[jnp.asarray(a) for a in (q,) + pools + (tables, lens)])
    else:
        got = tattn.paged_prefix_attention(tq, *tp, tt, tl - 1)
        want = tattn.paged_attention(tq, *tp, tt, tl)
        jwant = jattn.paged_attention_reference(
            *[jnp.asarray(a) for a in (q,) + pools + (tables, lens)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=RTOL,
                               atol=ATOL)


def test_prefix_mask_matches_jax():
    st = np.asarray([0, 5, 13], np.int32)
    got = tattn.paged_prefix_mask(4, 16, torch.from_numpy(st)).numpy()
    want = np.asarray(jattn.paged_prefix_mask(4, 16, jnp.asarray(st)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [(0, 3), (5, 1), (2, 9)])
def test_prefill_write_with_start_matches_jax_exactly(start):
    rng = np.random.RandomState(sum(start))
    nb, S = 12, 6
    pool = rng.randn(nb, BS, NH, HD).astype(np.float32)
    new = rng.randn(2, S, NH, HD).astype(np.float32)
    tables = np.array([[4, 6, 2, 0], [8, 5, 0, 0]], np.int32)
    st = np.asarray(start, np.int32)
    want = np.asarray(jattn.paged_prefill_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        start=jnp.asarray(st)))
    got = torch.from_numpy(pool.copy())
    tattn.paged_prefill_write(got, torch.from_numpy(new),
                              torch.from_numpy(tables), torch.from_numpy(st))
    # block 0 takes the trash writes in an order both sides leave open
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


def test_prefill_write_pad_past_table_goes_to_trash():
    """Padding positions past the table width land in the trash block,
    never clipped into the last entry over a real suffix column (the JAX
    package's test of the same name, through the port)."""
    bs, nh, hd = 4, 2, 4
    pool = torch.zeros(4, bs, nh, hd)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)   # width 2
    new = np.random.RandomState(0).randn(1, 8, nh, hd).astype(np.float32)
    tattn.paged_prefill_write(pool, torch.from_numpy(new), tables,
                              torch.tensor([4], dtype=torch.int32))
    np.testing.assert_array_equal(pool.numpy()[2], new[0, :4])
    assert np.abs(pool.numpy()[0]).sum() > 0
    assert np.abs(pool.numpy()[3]).sum() == 0


def test_q8_prefill_write_with_start_matches_jax():
    rng = np.random.RandomState(21)
    nb = 10
    new = rng.randn(2, 5, NH, HD).astype(np.float32)
    tables = np.array([[2, 3, 4, 0], [5, 6, 0, 0]], np.int32)
    st = np.asarray([3, 6], np.int32)
    codes = np.zeros((nb, BS, NH, HD), np.int8)
    scales = np.zeros((nb, BS, NH), np.float32)
    jc, js = jattn.paged_prefill_write_q8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(tables), start=jnp.asarray(st))
    tc, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    tattn.paged_prefill_write_q8(tc, ts, torch.from_numpy(new),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(st))
    # codes may differ by one where x/scale sits on a rounding edge
    assert np.abs(tc.numpy()[1:].astype(np.int32)
                  - np.asarray(jc)[1:].astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:],
                               rtol=1e-6)
