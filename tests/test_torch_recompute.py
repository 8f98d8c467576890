"""PyTorch port vs JAX package: recompute (`GPTConfig(use_recompute=True,
recompute_policy=...)`) on GPT training.

For every policy the port's loss and gradients with recompute equal its
own without (the same operations run again: asserted to 1e-6, in practice
bit for bit) and match the JAX GPT with the same policy in train() mode.
JAX parity at 1e-5 relative on the loss and 2e-5 absolute on gradients,
as in test_torch_train (f32; the port's flash and fused-CE routes against
the JAX reference attention and chunked CE: summation order only). Hidden
dropout is compared within the port only (the JAX dropout stream has no
counterpart): recomputed regions must redraw the masks the forward drew.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import recompute as R
from test_torch_train import CFG_G, _ids, _port_layout

POLICIES = [None, "save_qkv", "save_attn", "save_big", "dots"]


def _port_grads(cfg, ids, policy, use, seed=0):
    m = pt.GPTForCausalLM(pt.GPTConfig(**cfg, use_recompute=use,
                                       recompute_policy=policy),
                          device="cpu", seed=seed)
    m.train()
    loss = m.loss(ids, ids)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in m.named_parameters()}, m


@pytest.fixture(scope="module")
def jax_pair():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**CFG_G))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return np_state


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_equals_no_recompute_and_matches_jax(policy, jax_pair):
    np_state = jax_pair
    ids = _ids(2, 128, CFG_G["vocab_size"], 11)
    # the JAX GPT under the same policy, in train() mode (its remat runs
    # only there), from the same weights
    jcfg = JGPTConfig(**CFG_G, use_recompute=True, recompute_policy=policy)
    jm = JGPT(jcfg)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})
    jm.train()
    jid = paddle.to_tensor(ids)
    jl = jm.loss(jid, jid)
    jl.backward()
    tcfg = pt.GPTConfig(**CFG_G, use_recompute=True, recompute_policy=policy)
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    tm.train()
    tid = torch.from_numpy(ids)
    tl = tm.loss(tid, tid)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tgrads[n].numpy(),
                                   _port_layout(n, p.grad.numpy()),
                                   atol=2e-5, rtol=0, err_msg=n)
    # the same model without recompute: the same loss and gradients
    tm.config.use_recompute = False
    tm.zero_grad(set_to_none=True)
    tl2 = tm.loss(tid, tid)
    tl2.backward()
    assert float(tl2.detach()) == pytest.approx(float(tl.detach()),
                                                rel=1e-6, abs=0)
    for n, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, tgrads[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_recomputed_regions_redraw_the_dropout_masks(policy):
    """hidden_dropout 0.1 draws its masks from the model's generator, which
    torch.utils.checkpoint does not stash: each region replays the
    generator state it started from, so the backward sees the forward's
    masks."""
    cfg = dict(CFG_G, hidden_dropout=0.1)
    ids = torch.from_numpy(_ids(2, 128, cfg["vocab_size"], 12))
    l0, g0, m0 = _port_grads(cfg, ids, None, False, seed=3)
    l1, g1, m1 = _port_grads(cfg, ids, policy, True, seed=3)
    assert l1 == l0
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6)
    # the generators end in the same state: the next draws agree
    assert torch.equal(m0.dropout_generator.get_state(),
                       m1.dropout_generator.get_state())


def test_recompute_runs_in_train_mode_only(monkeypatch):
    import paddle_tpu_torch.models.gpt as G
    ids = torch.from_numpy(_ids(2, 128, CFG_G["vocab_size"], 13))
    m = pt.GPTForCausalLM(pt.GPTConfig(**CFG_G, use_recompute=True,
                                       recompute_policy="save_qkv"),
                          device="cpu")
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return R.checkpoint_segment(*a, **k)
    monkeypatch.setattr(G, "checkpoint_segment", spy)
    m.eval()
    m.loss(ids, ids)
    assert calls == []
    m.train()
    m.loss(ids, ids)
    # save_qkv: two regions a block
    assert len(calls) == 2 * CFG_G["num_layers"]


def test_policies_resolve_like_jax_and_callables_are_refused():
    assert R.resolve_policy(None) is None
    assert R.resolve_policy("save_qkv") == ("qkv_proj",)
    assert R.resolve_policy("save_attn") == ("qkv_proj", "attn_ctx")
    assert R.resolve_policy("save_big") == ("qkv_proj", "attn_ctx",
                                            "mlp_up")
    assert R.resolve_policy("dots") == "dots"
    with pytest.raises(ValueError, match="callable"):
        R.resolve_policy(lambda *a, **k: True)
    with pytest.raises(ValueError, match="unknown policy"):
        R.resolve_policy("save_everything")
    with pytest.raises(ValueError, match="unknown policy"):
        pt.GPTConfig(**CFG_G, use_recompute=True, recompute_policy="x")
    with pytest.raises(ValueError, match="unknown checkpoint tag"):
        R.checkpoint_tag(torch.zeros(1), "ffn")
    # a save-list policy needs a function that can be cut at its tags
    with pytest.raises(ValueError, match="recompute_segments"):
        R.recompute(torch.sin, torch.zeros(2, requires_grad=True),
                    policy="save_qkv")


def test_recompute_of_a_plain_function_keeps_only_its_inputs():
    x = torch.randn(8, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)

    def f(a):
        return torch.tanh(a @ w).sum()
    for policy in (None, "dots"):
        g = torch.autograd.grad(R.recompute(f, x, policy=policy), (x, w))
        want = torch.autograd.grad(f(x), (x, w))
        for a, b in zip(g, want):
            assert torch.equal(a, b)
