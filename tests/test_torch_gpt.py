"""PyTorch port vs JAX package: GPT weights, forward and paged serving.

One small f32 GPT (2 layers, H=64, 4 heads, vocab 128) is built in the
JAX package; its state dict goes through `state_dict_from_paddle` into
the port, and both models see the same numpy prompts.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import BlockPool as JBlockPool
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch.models.gpt import sample_logits

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)
CAP, NEW, BS = 8, 6, 4


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, cfg))
    return jm, tm, np_state


def _prompts(lens, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG["vocab_size"], (len(lens), CAP)).astype(
        np.int64)
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
    return ids


def test_converter_round_trip(models):
    jm, tm, np_state = models
    sd = tm.state_dict()
    assert set(sd) == set(np_state)
    for name, arr in np_state.items():
        got = sd[name].numpy()
        if got.ndim == 2 and name.endswith(("qkv.weight", "out.weight",
                                            "up.weight", "down.weight")):
            got = got.T                 # nn.Linear [out, in] -> mpu [in, out]
        np.testing.assert_array_equal(got, arr, err_msg=name)
    # the tied head is wte itself: no separate parameter to drift
    assert not hasattr(tm, "lm_head")


def test_converter_rejects_mismatched_state(models):
    _, _, np_state = models
    bad = dict(np_state)
    bad.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        pt.state_dict_from_paddle(bad, pt.GPTConfig(**CFG))


def test_forward_logits_match_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(2).randint(0, CFG["vocab_size"], (2, 12))
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    # f32 on both sides; 1e-4 absorbs summation-order differences
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _chains_port(tm, ids, lens, cache_dtype):
    pool = pt.BlockPool.for_model(tm, num_blocks=24, block_size=BS,
                                  cache_dtype=cache_dtype)
    pools = pool.make_pools()
    mb = pool.blocks_needed(CAP + NEW - 1)
    tables = np.stack([(pool.alloc(i, CAP + NEW - 1),
                        pool.table_row(i, mb))[1] for i in range(len(lens))])
    pools, first = tm.prefill_paged(ids, np.int32(lens), pools, tables,
                                    cache_dtype=cache_dtype)
    out = [first.numpy().astype(np.int64)[:, None]]
    ln, pend = np.int32(lens), first.numpy()
    done = np.zeros(len(lens), bool)
    for c in (2, 3):                   # two chunks: resume must be exact
        toks, pools, ln, done = tm.decode_paged(
            pools, tables, ln, pend, done, c, cache_dtype=cache_dtype)
        out.append(toks.numpy())
        pend = toks.numpy()[:, -1]
    return np.concatenate(out, axis=1)


def _chains_jax(jm, ids, lens, cache_dtype):
    pool = JBlockPool.for_model(jm, num_blocks=24, block_size=BS,
                                cache_dtype=cache_dtype)
    pools = pool.make_pools()
    mb = pool.blocks_needed(CAP + NEW - 1)
    tables = np.stack([(pool.alloc(i, CAP + NEW - 1),
                        pool.table_row(i, mb))[1] for i in range(len(lens))])
    pools, first = jm.prefill_paged(ids, np.int32(lens), pools, tables,
                                    cache_dtype=cache_dtype)
    first = np.asarray(first.numpy())
    out = [first.astype(np.int64)[:, None]]
    ln, pend = np.int32(lens), first
    done = np.zeros(len(lens), bool)
    for c in (2, 3):
        toks, pools, ln, done = jm.decode_paged(
            pools, tables, ln, pend, done, c, cache_dtype=cache_dtype)
        out.append(np.asarray(toks.numpy()))
        pend = np.asarray(toks.numpy())[:, -1]
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_greedy_chains_match_jax(models, cache_dtype):
    """prefill_paged + two decode_paged chunks on ragged prompts (a full
    cap row, one at a block boundary, a 1-token one) give JAX's greedy
    chains exactly, for model-dtype and int8 pools."""
    jm, tm, _ = models
    lens = [CAP, 4, 1, 6]
    ids = _prompts(lens)
    got = _chains_port(tm, ids, lens, cache_dtype)
    want = _chains_jax(jm, ids, lens, cache_dtype)
    np.testing.assert_array_equal(got, want)
    # and JAX's one-shot static oracle agrees on every row
    ref = np.asarray(jm.generate_static_ragged(
        paddle.to_tensor(ids), lens, max_new_tokens=NEW,
        cache_dtype=cache_dtype).numpy())[:, CAP:]
    np.testing.assert_array_equal(got, ref)


def test_sample_logits_semantics():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 5.0, 0.0, 0.0]])
    # greedy: argmax, first index on ties (JAX's convention)
    assert sample_logits(logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        # top_k=2 keeps {1, 3} in row 0 and {0, 1} in row 1
        tk = sample_logits(logits, g, temperature=1.0, top_k=2).tolist()
        assert tk[0] in (1, 3) and tk[1] in (0, 1)
        # top_p=0 keeps rank 0 only: degrades to argmax
        assert sample_logits(logits[:1], g, temperature=0.7,
                             top_p=0.0).tolist() == [1]
    # top_p keeps the smallest prefix whose preceding mass is < p
    sharp = torch.tensor([[0.0, 10.0, 9.0, -10.0]])
    seen = {sample_logits(sharp, g, temperature=1.0, top_p=0.9).item()
            for _ in range(50)}
    assert seen <= {1, 2} and 1 in seen
