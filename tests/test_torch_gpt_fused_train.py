"""PyTorch port vs JAX package: GPT training through both opt-in kernel
routes at once (PADDLE_TPU_FUSED_LN=1: every LayerNorm through the fused
LayerNorm; PADDLE_TPU_FLASH_PACKED=1: attention through packed flash
attention on the qkv projection), with save_qkv recompute and int8 Adam
moments, against the JAX GPT's default route with the same recompute and
moments (on the CPU the JAX opt-ins are refused by their platform test).

hidden 256 = 2 heads of 128, 2 layers, S=256, f32, 3 AdamW steps at lr
1e-3 on the same numpy batches. Tolerances: losses 1e-5 relative; the
parameters as in test_torch_adam_int8 (1e-5 absolute, up to 0.1% of a
parameter's elements within one step, 1e-3, where a moment code sits one
step apart), since the routes differ from JAX's in f32 summation order
only (the one-pass LayerNorm variance against the two-pass one among
them).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import layer_norm as LN
from test_torch_adam_int8 import _assert_params_match
from test_torch_train import _decay, _ids

CFG = dict(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=2,
           max_position_embeddings=256, use_recompute=True,
           recompute_policy="save_qkv")


def test_opt_in_routes_with_recompute_and_int8_moments_match_jax(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_PACKED", "1")
    calls = {"ln": 0, "packed": 0}

    def spy(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(LN, "fused_layer_norm_reference",
                        spy("ln", LN.fused_layer_norm_reference))
    monkeypatch.setattr(FA, "flash_packed_forward_reference",
                        spy("packed", FA.flash_packed_forward_reference))
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.train()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tcfg = pt.GPTConfig(**CFG)
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    tm.train()
    for n, p in jm.named_parameters():
        p.name = n
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_decay, moment_dtype="int8",
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(jm, jopt, lambda a, b: jm.loss(a, b))
    topt = pt.AdamW(1e-3, parameters=tm.named_parameters(),
                    weight_decay=0.01, apply_decay_param_fun=_decay,
                    moment_dtype="int8",
                    grad_clip=pt.ClipGradByGlobalNorm(1.0), device="cpu")
    ts = pt.TrainStep(tm, topt, lambda a, b: tm.loss(a, b), device="cpu")
    for i in range(3):
        a = _ids(2, 256, CFG["vocab_size"], 60 + i)
        jl = float(js(paddle.to_tensor(a), paddle.to_tensor(a)))
        tl = float(ts(torch.from_numpy(a), torch.from_numpy(a)))
        assert tl == pytest.approx(jl, rel=1e-5), f"step {i + 1}"
    _assert_params_match(jm, tm)
    # every step ran the fused LayerNorm 2 L + 1 times in the forward and
    # 2 L more in the recomputed regions, the packed attention L + L times
    L = CFG["num_layers"]
    assert calls == {"ln": 3 * (4 * L + 1), "packed": 3 * 2 * L}
    assert all("moment1_q" in st for st in ts._opt_state)
