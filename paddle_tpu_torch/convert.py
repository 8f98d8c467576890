"""Carry GPT weights from the JAX package's state dict into the port.

The JAX package names its GPT parameters exactly as the port does
(``gpt.wte.weight``, ``gpt.h.{i}.attn.qkv.weight``, ``gpt.ln_f.bias``, ...)
but stores every mpu projection weight ``[in, out]`` (qkv ``[H, 3H]``),
where ``nn.Linear`` stores ``[out, in]``. So the map is by name, with those
2-D projection weights transposed. The qkv output columns keep their
``[3, num_heads, head_dim]`` order, and the tied LM head stays tied: it is
wte itself, so there is no separate head entry to carry.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_PROJECTIONS = ("attn.qkv.weight", "attn.out.weight", "mlp.up.weight",
                "mlp.down.weight")


def state_dict_from_paddle(np_state: Dict[str, np.ndarray],
                           cfg) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from a JAX-package GPTForCausalLM
    (``{k: np.asarray(v) for k, v in m.state_dict().items()}``) to a
    state dict `GPTForCausalLM.load_state_dict` takes. Raises on a missing
    or unexpected name, or a shape the config does not give."""
    expected = _expected_shapes(cfg)
    missing = sorted(set(expected) - set(np_state))
    extra = sorted(set(np_state) - set(expected))
    if missing or extra:
        raise KeyError(f"state dict does not match the GPT config: missing "
                       f"{missing[:4]}, unexpected {extra[:4]}")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(np_state[name])
        if name.endswith(_PROJECTIONS) or name == "lm_head.weight":
            arr = arr.T
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} after "
                             f"transpose, config gives {shape}")
        out[name] = torch.from_numpy(np.array(arr))   # a writable copy
    return out


def _expected_shapes(cfg) -> Dict[str, tuple]:
    """Port-side (``nn.Linear`` layout) shape of every GPT parameter."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"gpt.wte.weight": (v, h),
              "gpt.wpe.weight": (cfg.max_position_embeddings, h),
              "gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"gpt.h.{i}."
        shapes.update({
            p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
            p + "attn.qkv.weight": (3 * h, h), p + "attn.qkv.bias": (3 * h,),
            p + "attn.out.weight": (h, h), p + "attn.out.bias": (h,),
            p + "ln_2.weight": (h,), p + "ln_2.bias": (h,),
            p + "mlp.up.weight": (m, h), p + "mlp.up.bias": (m,),
            p + "mlp.down.weight": (h, m), p + "mlp.down.bias": (h,)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (v, h)
    return shapes
