"""PyTorch port vs JAX package: the weight-only int8 GEMM (kernel #5) and
the model's int8 payload.

The port's plain `int8_matmul` / `int8_linear_nd` (the CPU route) take the
same numpy inputs as the JAX Pallas kernel in interpret mode and as its
XLA fallback; f32 outputs agree within rtol = atol = 1e-4 (different
summation orders over K <= 256 at the scale of tests/test_int8_matmul.py:
x*0.3, w*0.1). The payload the port quantizes from converted weights
equals the JAX package's `_decode_quantized_params` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops.pallas.int8_matmul import int8_linear_nd as j_linear_nd
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul as j_int8_matmul
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.cuda import int8_matmul as cuda_mm
from paddle_tpu_torch.ops.int8_matmul import (int8_linear_nd, int8_matmul,
                                              int8_matmul_reference)

TOL = dict(rtol=1e-4, atol=1e-4)


def _quant(w, axis):
    s = np.maximum(np.max(np.abs(w), axis=axis, keepdims=True) / 127.0,
                   1e-12)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _case(m, k, n, layout, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.3).astype(np.float32)
    if layout == "kn":
        q, s = _quant((rng.randn(k, n) * 0.1).astype(np.float32), axis=0)
    else:
        q, s = _quant((rng.randn(n, k) * 0.1).astype(np.float32), axis=1)
    return x, q, s.reshape(-1)


@pytest.mark.parametrize("m, k, n, layout", [
    (8, 256, 512, "kn"), (13, 128, 384, "kn"), (8, 128, 640, "nk"),
    (3, 48, 100, "nk"), (72, 128, 256, "nk")])
def test_plain_matches_jax_kernel_and_fallback(m, k, n, layout, monkeypatch):
    """Both layouts, M not a multiple of 8, ragged N: the port's CPU route
    against the Pallas kernel (interpret mode, where the JAX shape gate
    admits the shape) and against the JAX fallback."""
    x, q, s = _case(m, k, n, layout, seed=m + n)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(s), w_layout=layout).numpy()
    monkeypatch.setenv("PADDLE_TPU_INT8_MATMUL", "0")
    fallback = j_int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                             w_layout=layout)
    np.testing.assert_allclose(got, np.asarray(fallback), **TOL)
    if m % 8 == 0 and k % 128 == 0 and n % 128 == 0:
        monkeypatch.setenv("PADDLE_TPU_INT8_MATMUL", "1")
        kern = j_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                             jnp.asarray(s), w_layout=layout, interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_nd_wrapper_adds_bias_after_the_cast(layout, monkeypatch):
    """[2, 4, K] input with a bias through the N-d wrappers."""
    x, q, s = _case(8, 128, 256, layout, seed=3)
    x = x.reshape(2, 4, 128)
    b = np.random.RandomState(4).randn(256).astype(np.float32)
    got = int8_linear_nd(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s), torch.from_numpy(b),
                         w_layout=layout).numpy()
    monkeypatch.setenv("PADDLE_TPU_INT8_MATMUL", "1")
    want = j_linear_nd(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                       jnp.asarray(b), w_layout=layout, interpret=True)
    assert got.shape == (2, 4, 256)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bf16_plain_version_widens_exactly():
    """bf16 x: the f32 accumulator and the cast follow the scale, so the
    plain version equals the dequantized f32 product rounded once."""
    x, q, s = _case(8, 64, 96, "nk", seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = int8_matmul_reference(xb, torch.from_numpy(q), torch.from_numpy(s),
                                "nk")
    want = (xb.float() @ torch.from_numpy(q).float().t()
            * torch.from_numpy(s)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("change, match", [
    (dict(k=40), "multiple of 16"),
    (dict(x_dtype=torch.float16), "float32 or bfloat16"),
    (dict(s_shape=(1, 64)), "s must be"),
    (dict(layout="kk"), "w_layout"),
    ({}, "needs CUDA tensors"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    k = change.get("k", 32)
    x = torch.zeros(4, k, dtype=change.get("x_dtype", torch.float32))
    q = torch.zeros(64, k, dtype=torch.int8)
    s = torch.ones(change.get("s_shape", (64,)))
    before = cuda_mm.LAUNCHES["int8_matmul"]
    with pytest.raises(ValueError, match=match):
        cuda_mm.int8_matmul_cuda(x, q, s, w_layout=change.get("layout",
                                                               "nk"))
    assert cuda_mm.LAUNCHES["int8_matmul"] == before


CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, intermediate_size=128)


@pytest.mark.parametrize("tie", [True, False])
def test_payload_equals_jax_decode_quantized_params(tie, monkeypatch):
    """Codes and scales of every quantized parameter, bit for bit, with
    convert.py's transposes applied: projections and an untied head per
    output channel, wte per row, wpe per column."""
    monkeypatch.setenv("PADDLE_TPU_Q8_DECODE_MIN", "4096")
    paddle.seed(3)
    jm = JGPT(JGPTConfig(**CFG, tie_word_embeddings=tie))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = pt.GPTConfig(**CFG, tie_word_embeddings=tie)
    tm = pt.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(state, cfg))
    names = [n for n, _ in jm.named_parameters()]
    jq = {names[i]: v for i, v in jm._decode_quantized_params().items()}
    tq = tm.quantized_params()
    assert set(jq) == set(tq)
    assert "gpt.wpe.weight" in tq and "gpt.wte.weight" in tq
    assert ("lm_head.weight" in tq) == (not tie)
    for name, (jcodes, jscale) in jq.items():
        codes, scale = (t.numpy() for t in tq[name])
        jcodes, jscale = np.asarray(jcodes), np.asarray(jscale)
        if name in ("gpt.wte.weight", "gpt.wpe.weight"):
            np.testing.assert_array_equal(codes, jcodes)
            np.testing.assert_array_equal(scale, jscale)
        else:                         # JAX [in, out] -> the port's [out, in]
            np.testing.assert_array_equal(codes, jcodes.T)
            np.testing.assert_array_equal(scale, jscale.T)
    assert tq["gpt.wpe.weight"][1].shape == (1, CFG["hidden_size"])
    assert tq["gpt.wte.weight"][1].shape == (CFG["vocab_size"], 1)


def test_payload_is_cached_per_set_of_weights(monkeypatch):
    """One quantization per set of weights: reused while the parameters
    stand, rebuilt after an in-place update; only parameters at or above
    the size gate are quantized."""
    monkeypatch.setenv("PADDLE_TPU_Q8_DECODE_MIN", "8192")
    tm = pt.GPTForCausalLM(pt.GPTConfig(**CFG), device="cpu")
    a = tm._q8("int8")
    assert tm._q8("int8") is a
    assert a["h"][0]["attn.out"] is None          # 64 x 64 < 8192
    assert a["h"][0]["attn.qkv"][0].dtype == torch.int8
    assert a["wpe"] is None                       # 64 x 64 < 8192
    with torch.no_grad():
        tm.gpt.h[0].attn.qkv.weight.mul_(2.0)
    b = tm._q8("int8")
    assert b is not a
    assert torch.equal(b["h"][0]["attn.qkv"][0], a["h"][0]["attn.qkv"][0])
    assert torch.allclose(b["h"][0]["attn.qkv"][1],
                          2 * a["h"][0]["attn.qkv"][1])
    assert tm._q8(None) is None
    with pytest.raises(ValueError, match="weight_dtype"):
        tm._q8("int4")
