"""PyTorch port vs JAX package: the static decode stack.

The same small f32 GPT (2 layers, H=64, 4 heads, vocab 128), converted
from the JAX package's weights, runs `generate_static`,
`generate_static_ragged`, `generate` and `prefill_static` /
`decode_static` through the port's CPU route and through the JAX
methods on the same numpy prompts. Greedy token chains must be equal
exactly, for fp and int8 KV caches and bf16-free (f32) or weight-only
int8 weights (``PADDLE_TPU_Q8_DECODE_MIN=4096`` quantizes the toy widths
as the JAX tests do).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CAP, NEW = 8, 6
LENS = [CAP, 5, 3, 7]
MODES = [(w, c) for w in (None, "int8") for c in (None, "int8")]
# the EOS and resume checks run at both ends of the matrix: every branch
# they add is dtype-independent host logic
ENDS = [(None, None), ("int8", "int8")]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(state, cfg))
    return jm, tm


@pytest.fixture(autouse=True)
def _toy_q8_gate(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_Q8_DECODE_MIN", "4096")


def _ragged(lens=LENS, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG["vocab_size"], (len(lens), CAP)).astype(
        np.int64)
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
    return ids


def _j(x):
    return np.asarray(x.numpy())


def test_static_cache_ops_match_jax():
    """static_cache_update writes in place at the cursor and raises on
    overflow; the int8 form's codes and scales and dequantize_kv equal the
    JAX ops bit for bit."""
    import jax.numpy as jnp
    from paddle_tpu.ops import attention as JA
    from paddle_tpu_torch.ops import attention as TA
    rng = np.random.RandomState(7)
    buf = rng.randn(2, 6, 3, 8).astype(np.float32)
    new = rng.randn(2, 2, 3, 8).astype(np.float32)
    tbuf = torch.from_numpy(buf.copy())
    out = TA.static_cache_update(tbuf, torch.from_numpy(new), 3)
    assert out is tbuf
    np.testing.assert_array_equal(
        tbuf.numpy(), np.asarray(JA.static_cache_update(
            jnp.asarray(buf), jnp.asarray(new), jnp.int32(3))))
    with pytest.raises(ValueError, match="overflow"):
        TA.static_cache_update(tbuf, torch.from_numpy(new), 5)
    codes = torch.zeros(2, 6, 3, 8, dtype=torch.int8)
    scale = torch.zeros(2, 6, 3)
    TA.static_cache_update_q8(codes, scale, torch.from_numpy(new), 1)
    jc, js = JA.static_cache_update_q8(jnp.zeros((2, 6, 3, 8), jnp.int8),
                                       jnp.zeros((2, 6, 3)),
                                       jnp.asarray(new), jnp.int32(1))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = TA.dequantize_kv(codes, scale, dt).float().numpy()
        want = JA.dequantize_kv(jc, js, jdt).astype(jnp.float32)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("weight_dtype, cache_dtype", MODES)
def test_generate_static_and_ragged_match_jax(models, weight_dtype,
                                              cache_dtype):
    jm, tm = models
    ids = _ragged()
    kw = dict(max_new_tokens=NEW, weight_dtype=weight_dtype,
              cache_dtype=cache_dtype)
    want = _j(jm.generate_static_ragged(paddle.to_tensor(ids), LENS, **kw))
    got = tm.generate_static_ragged(ids, LENS, **kw)
    assert got.dtype == torch.int64 and got.shape == (len(LENS), CAP + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    full = ids[:, :5]
    want = _j(jm.generate_static(paddle.to_tensor(full), **kw))
    np.testing.assert_array_equal(tm.generate_static(full, **kw).numpy(),
                                  want)


@pytest.mark.parametrize("weight_dtype, cache_dtype", ENDS)
def test_eos_masking_matches_jax(models, weight_dtype, cache_dtype):
    """Row 0's first token is EOS: it emits EOS to the end, the others
    are unaffected; the ragged and unragged paths both equal JAX."""
    jm, tm = models
    ids = _ragged()
    kw = dict(max_new_tokens=NEW, weight_dtype=weight_dtype,
              cache_dtype=cache_dtype)
    eos = int(_j(jm.generate_static_ragged(paddle.to_tensor(ids), LENS,
                                           **kw))[0, CAP])
    want = _j(jm.generate_static_ragged(paddle.to_tensor(ids), LENS,
                                        eos_token_id=eos, **kw))
    got = tm.generate_static_ragged(ids, LENS, eos_token_id=eos, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, CAP:] == eos).all()
    want = _j(jm.generate_static(paddle.to_tensor(ids[:, :5]),
                                 eos_token_id=eos, **kw))
    got = tm.generate_static(ids[:, :5], eos_token_id=eos, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_jax_and_generate_static(models):
    """The growing-cache path: greedy equals the JAX `generate` and the
    port's generate_static; with EOS every row done stops it early."""
    jm, tm = models
    ids = _ragged()[:, :5]
    got = tm.generate(ids, max_new_tokens=4).numpy()
    np.testing.assert_array_equal(
        got, _j(jm.generate(paddle.to_tensor(ids), max_new_tokens=4)))
    np.testing.assert_array_equal(
        got, tm.generate_static(ids, max_new_tokens=4).numpy())
    eos = int(got[0, 5])
    masked = tm.generate(ids, max_new_tokens=4, eos_token_id=eos).numpy()
    static = tm.generate_static(ids, max_new_tokens=4, eos_token_id=eos)
    np.testing.assert_array_equal(masked,
                                  static.numpy()[:, :masked.shape[1]])
    short = tm.generate(ids[:1], max_new_tokens=4, eos_token_id=eos).numpy()
    assert short.shape == (1, 6) and short[0, -1] == eos
    sampled = tm.generate(ids, max_new_tokens=4, temperature=0.9, top_k=5,
                          seed=3)
    assert torch.equal(sampled, tm.generate(ids, max_new_tokens=4,
                                            temperature=0.9, top_k=5,
                                            seed=3))
    assert ((sampled >= 0) & (sampled < CFG["vocab_size"])).all()


def test_generate_prefill_is_causal():
    """The port's `generate` equals a step-by-step full forward even where
    attention is far from uniform (init 0.5): its prefill over the empty
    growing cache is causal. The JAX package's eager `generate` attends
    its prompt without a causal mask; at the default init 0.02 the two
    agree (test above), here only the port equals the full forward."""
    cfg = pt.GPTConfig(**CFG, initializer_range=0.5)
    tm = pt.GPTForCausalLM(cfg, device="cpu", seed=4)
    ids = torch.from_numpy(_ragged()[:, :6])
    got = tm.generate(ids, max_new_tokens=5)
    cur = ids
    with torch.no_grad():
        for _ in range(5):
            nxt = tm(cur)[:, -1].argmax(-1, keepdim=True)
            cur = torch.cat([cur, nxt], dim=1)
    assert torch.equal(got, cur)
    assert torch.equal(got, tm.generate_static(ids, max_new_tokens=5))


@pytest.mark.parametrize("weight_dtype, cache_dtype", ENDS)
def test_prefill_decode_chunked_fan_out_and_donation(models, weight_dtype,
                                                     cache_dtype):
    """prefill_static + decode_static equal the JAX pair; the [1, 2, 2]
    chunked resume equals the one-shot decode; two decodes from one state
    give equal chains; donate_cache=True consumes its state."""
    jm, tm = models
    ids = _ragged()
    kw = dict(weight_dtype=weight_dtype, cache_dtype=cache_dtype)
    L = CAP + NEW
    jst = jm.prefill_static(paddle.to_tensor(ids), max_len=L,
                            prompt_lens=LENS, **kw)
    want = _j(jm.decode_static(jst, 5))
    st = tm.prefill_static(ids, max_len=L, prompt_lens=LENS, **kw)
    assert set(st) == set(jst)
    one = tm.decode_static(st, 5)
    np.testing.assert_array_equal(one.numpy(), want)
    np.testing.assert_array_equal(tm.decode_static(st, 5).numpy(), want)
    parts, cur = [], st
    for n in (1, 2, 2):
        toks, cur = tm.decode_static(cur, n, return_state=True,
                                     donate_cache=True)
        parts.append(toks)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want)
    assert st["caches"] is None          # the first chunk donated it
    with pytest.raises(ValueError, match="consumed"):
        tm.decode_static(st, 1)
    # the unragged state resumes the same way
    jst = jm.prefill_static(paddle.to_tensor(ids[:, :5]), max_len=L, **kw)
    want = _j(jm.decode_static(jst, 4))
    st = tm.prefill_static(ids[:, :5], max_len=L, **kw)
    toks, st2 = tm.decode_static(st, 1, return_state=True)
    rest = tm.decode_static(st2, 3)
    np.testing.assert_array_equal(torch.cat([toks, rest], 1).numpy(), want)


def test_decode_static_guards(models):
    """Capacity, stale-weight and dtype guards, and the argument checks."""
    _, tm0 = models
    tm = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(tm0.state_dict())
    ids = _ragged()[:, :5]
    st = tm.prefill_static(ids, max_len=8)
    with pytest.raises(ValueError, match="exceeding the prefill state"):
        tm.decode_static(st, 5)             # 5 + 5 - 1 rows > 8
    assert tm.decode_static(st, 4).shape == (4, 4)
    with pytest.raises(ValueError, match="return_state"):
        tm.decode_static(st, 2, donate_cache=True)
    with pytest.raises(ValueError, match="max_new_tokens >= 1"):
        tm.decode_static(st, 0)
    with pytest.raises(ValueError, match="must exceed the prompt"):
        tm.prefill_static(ids, max_len=5)
    with pytest.raises(ValueError, match="cache_dtype"):
        tm.prefill_static(ids, max_len=8, cache_dtype="float16")
    assert tm.prefill_static(ids, max_len=8, cache_dtype="float32")["c8"] \
        is False
    with pytest.raises(ValueError, match="prompt_lens"):
        tm.prefill_static(ids, max_len=8, prompt_lens=[6, 1, 1, 1])
    with torch.no_grad():                     # an in-place optimizer step
        tm.gpt.h[1].mlp.up.weight.add_(1e-3)
    with pytest.raises(ValueError, match="parameters changed"):
        tm.decode_static(st, 2)
    st = tm.prefill_static(ids, max_len=8)
    tm.to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype changed"):
        tm.decode_static(st, 2)
