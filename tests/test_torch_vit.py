"""PyTorch port vs JAX package: the Vision Transformer (patch embedding as
one product with the conv weight, pre-LN blocks through the fused MHA,
cls-token pooling, the head) and its training gradients.

Small f32 models are built in the JAX package; their state dicts go
through `model_state_from_paddle` into the port, and both sides see the
same numpy images. On the CPU the JAX model takes its reference attention
(the fused kernel's gate holds only on a TPU) and the port the fused MHA's
plain twin: the same function. Two shapes: image 32 with patch 16 (S = 5)
and image 224 with patch 16 (S = 197, the ragged length of vit-l16 at
224^2) at a narrow width. Tolerances: 1e-5 relative on the loss, 2e-5
absolute on logits and gradients (f32, summation order only).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ViTConfig as JViTConfig
from paddle_tpu.models import VisionTransformer as JViT
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight
from paddle_tpu_torch.ops import fused_mha as FM

CASES = {
    "s5": dict(image_size=32, patch_size=16, hidden_size=128, num_layers=2,
               num_heads=2, intermediate_size=256, num_classes=10),
    "s197": dict(image_size=224, patch_size=16, hidden_size=128,
                 num_layers=2, num_heads=2, intermediate_size=256,
                 num_classes=10),
}
ATOL = 2e-5


def _pair(cfg, seed=0):
    paddle.seed(seed)
    jm = JViT(JViTConfig(**cfg))
    jm.eval()
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.VisionTransformer(pt.ViTConfig(**cfg), device="cpu")
    tm.load_state_dict(pt.model_state_from_paddle(np_state, tm))
    return jm, tm


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_every_grad_match_jax(case):
    cfg = CASES[case]
    jm, tm = _pair(cfg)
    rng = np.random.RandomState(1)
    hw = cfg["image_size"]
    img = rng.randn(2, 3, hw, hw).astype(np.float32)
    lab = rng.randint(0, cfg["num_classes"], (2,)).astype(np.int64)
    assert FM.use_fused_mha(pt.ViTConfig(**cfg).num_patches + 1,
                            cfg["num_heads"],
                            cfg["hidden_size"] // cfg["num_heads"])
    jlog = jm(paddle.to_tensor(img))
    jl = paddle.nn.CrossEntropyLoss()(jlog, paddle.to_tensor(lab))
    jl.backward()
    tlog = tm(torch.from_numpy(img))
    tl = torch.nn.functional.cross_entropy(tlog, torch.from_numpy(lab))
    tl.backward()
    np.testing.assert_allclose(tlog.detach().numpy(), jlog.numpy(),
                               atol=ATOL, rtol=0)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tp = dict(tm.named_parameters())
    jp = dict(jm.named_parameters())
    assert set(tp) == set(jp)
    for n, p in jp.items():
        g = p.grad.numpy()
        if _is_linear_weight(n, g.ndim):
            g = g.T
        np.testing.assert_allclose(tp[n].grad.numpy(), g, atol=ATOL,
                                   rtol=0, err_msg=n)


def test_patchify_is_the_strided_conv():
    tm = pt.VisionTransformer(pt.ViTConfig(**CASES["s5"]), device="cpu")
    img = torch.from_numpy(np.random.RandomState(2).randn(
        2, 3, 40, 40).astype(np.float32))          # a partial patch floored
    from paddle_tpu_torch.models.vit import _patchify_matmul
    pe = tm.patch_embed
    want = pe(img).flatten(2).transpose(1, 2)
    got = _patchify_matmul(img, pe.weight, pe.bias, 16)
    assert torch.allclose(got, want, atol=1e-5)


def test_non_fused_route_matches_the_fused_route(monkeypatch):
    """PADDLE_TPU_FUSED_MHA=0 sends attention to the reference route: the
    same logits in f32."""
    cfg = CASES["s5"]
    _, tm = _pair(cfg)
    img = torch.from_numpy(np.random.RandomState(3).randn(
        2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        fused = tm(img)
        monkeypatch.setenv("PADDLE_TPU_FUSED_MHA", "0")
        plain = tm(img)
    assert torch.allclose(fused, plain, atol=ATOL)


def test_presets_and_train_mode_dropout():
    cfg = pt.vit_config("vit-l16")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_patches + 1) == (1024, 24, 16, 197)
    tm = pt.VisionTransformer(pt.ViTConfig(**dict(CASES["s5"],
                                                  hidden_dropout=0.2)),
                              device="cpu", seed=2)
    img = torch.from_numpy(np.random.RandomState(4).randn(
        2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        ev = tm(img)
        tm.train()
        a, b = tm(img), tm(img)
        tm.eval()
        assert torch.equal(tm(img), ev)
    assert not torch.equal(a, b)
