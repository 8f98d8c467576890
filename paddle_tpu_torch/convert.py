"""Carry model weights, and a whole training state, from the JAX package
into the port.

The JAX package names its parameters exactly as the port does
(``gpt.wte.weight``, ``gpt.h.{i}.attn.qkv.weight``,
``bert.encoder.{i}.attention.qkv.weight``, ``blocks.{i}.up.weight``, ...)
but stores every Linear and mpu projection weight ``[in, out]`` (qkv
``[H, 3H]``), where ``nn.Linear`` stores ``[out, in]``. So the map is by
name, with those 2-D weights transposed; embedding tables, conv weights,
Swin's relative-position tables (``attn.rel_bias_table``, no ``.weight``
suffix) and everything else carry over as they are. The qkv output columns keep
their ``[3, num_heads, head_dim]`` order, and a tied LM or MLM head stays
tied: it is the embedding table itself, so there is no separate entry to
carry. A ResNet's batch-norm buffers (``bn1._mean``, ``bn1._variance``)
carry over by name like parameters. Raw parameters that keep the JAX
layout carry over as they are too: an MoE block's ``gate_weight``, ``w1``,
``b1``, ``w2`` and ``b2``, the fused transformer layers' ``qkv_weight``,
``linear_weight``, ... (no ``.weight`` suffix), and a `FusedLinear`'s
``weight``, which is marked ``keeps_paddle_layout``. `model_state_from_paddle`
maps onto any port model's own state dict; `state_dict_from_paddle` maps
GPT (dense or MoE) from its config alone.

Tensor parallelism: `shard_state_from_paddle` gives one ``mp`` rank's
shard of a GPT state (the port model built under that mesh loads it), and
`gather_state` joins the ranks' shards back into the full state. The
split (`tp_split`) is the mpu layers': qkv's 3H rows are ``[3, nh, hd]``,
so rank r takes heads [r nh / mp, (r + 1) nh / mp) of q, of k and of v
(and the same rows of the bias), not a contiguous third of 3H, which is
how the JAX PartitionSpec tiles the global array (XLA reshards there, and
the port has no partitioner to do so); mlp.up's rows and bias and the
vocabulary rows of wte and an untied head are cut contiguously, attn.out's
and mlp.down's columns too; everything else is replicated.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# 2-D ".weight" entries that are tables, not Linear weights
_TABLES = ("wte.weight", "wpe.weight", "_embeddings.weight")
_Q_BLOCK = 2048   # the int8 Adam moments' block (optimizer.py)
# blockwise int8 moment state: codes [blocks, 2048] and scales [blocks]
_Q8_KEYS = {"moment1_q": lambda nb: (nb, _Q_BLOCK),
            "moment2_q": lambda nb: (nb, _Q_BLOCK),
            "moment1_s": lambda nb: (nb,), "moment2_s": lambda nb: (nb,)}
# optimizer state shaped like its parameter, of every optimizer
_PARAM_SHAPED_KEYS = ("moment1", "moment2", "velocity", "moment",
                      "inf_norm", "avg_squared_grad", "avg_squared_update",
                      "mean_square", "mean_grad", "momentum", "error")


def _is_linear_weight(name: str, ndim: int) -> bool:
    return ndim == 2 and name.endswith(".weight") and \
        not name.endswith(_TABLES)


def _paddle_layout(model: torch.nn.Module) -> frozenset:
    """Names of the parameters marked ``keeps_paddle_layout``."""
    return frozenset(n for n, p in model.named_parameters()
                     if getattr(p, "keeps_paddle_layout", False))


def _map(np_state: Dict[str, np.ndarray],
         expected: Dict[str, tuple],
         keep: frozenset = frozenset()) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` by name onto the port-side `expected`
    shapes, Linear weights transposed ``[in, out]`` -> ``[out, in]``
    (the names in `keep` are not). Raises on a missing or unexpected name
    or a shape that does not match."""
    missing = sorted(set(expected) - set(np_state))
    extra = sorted(set(np_state) - set(expected))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:4]}, unexpected {extra[:4]}")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(np_state[name])
        if name not in keep and _is_linear_weight(name, arr.ndim):
            arr = arr.T
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} after "
                             f"transpose, the model gives {shape}")
        out[name] = _to_torch(arr)
    return out


# name suffix -> (dim, groups) of the tensor-parallel split, port layouts
_TP_SPLIT = (("attn.qkv.weight", (0, 3)), ("attn.qkv.bias", (0, 3)),
             ("attn.out.weight", (1, 1)), ("mlp.up.weight", (0, 1)),
             ("mlp.up.bias", (0, 1)), ("mlp.down.weight", (1, 1)),
             ("gpt.wte.weight", (0, 1)), ("lm_head.weight", (0, 1)))


def tp_split(name: str):
    """(dim, groups) of a GPT parameter's split over ``mp`` (see
    `distributed.mpu.shard_of`), or None for a replicated one."""
    for suffix, rule in _TP_SPLIT:
        if name == suffix or name.endswith("." + suffix):
            return rule
    return None


# an MoE block's experts, split on dim 0 over ``ep``
_EP_SPLIT = ("mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2")


def ep_split(name: str):
    """(dim, groups) of a GPT parameter's split over ``ep`` (an MoE
    block's experts), or None."""
    return (0, 1) if name.endswith(_EP_SPLIT) else None


def _axis(mesh, axis):
    if mesh is None:
        return 1, 0
    return mesh.axis_size(axis), mesh.axis_rank(axis)


def _shard(name, t, mesh):
    from .distributed.mpu import shard_of
    for axis, rule in (("mp", tp_split(name)), ("ep", ep_split(name))):
        n, r = _axis(mesh, axis)
        if n > 1 and rule is not None:
            t = shard_of(t, rule[0], rule[1], r, n)
    return t


def shard_state_from_paddle(np_state: Dict[str, np.ndarray], cfg,
                            mesh=None) -> Dict[str, torch.Tensor]:
    """`state_dict_from_paddle`, then this rank's ``mp`` shard of every
    split parameter (`tp_split`) and its ``ep`` shard of every expert
    tensor (`ep_split`) of `mesh` (the active mesh when None): the state
    the model built under that mesh loads (``dp`` and ``sp`` ranks hold
    whole copies)."""
    from .distributed.mesh import get_mesh
    mesh = mesh if mesh is not None else get_mesh()
    return {k: _shard(k, v, mesh)
            for k, v in state_dict_from_paddle(np_state, cfg).items()}


def gather_state(state: Dict[str, torch.Tensor], mesh=None,
                 zero=None) -> Dict[str, torch.Tensor]:
    """The full state from this rank's shards: every split parameter
    (`tp_split`) all-gathered over the ``mp`` group of `mesh` (the active
    one) and rejoined, every expert tensor (`ep_split`) over its ``ep``
    group; replicated entries as they are. Under ZeRO stage 3
    (`zero`: a TrainStep's `zero` runtime) an entry that names one of its
    parameters is first made whole from its owner. Every rank of the
    groups must call it; the tensors must lie on the groups' device."""
    from .distributed.collective import all_gather
    from .distributed.mesh import axis_group
    from .distributed.mpu import gather_shards
    groups = {"mp": axis_group("mp", mesh), "ep": axis_group("ep", mesh)}
    if zero is not None and zero.stage >= 3:
        state = {k: zero.full_param(zero.index[k]) if k in zero.index
                 else v for k, v in state.items()}
    out = {}
    for k, v in state.items():
        for axis, rule in (("mp", tp_split(k)), ("ep", ep_split(k))):
            g = groups[axis]
            if g is not None and rule is not None:
                parts = all_gather(v.detach().contiguous(), group=g)
                v = gather_shards(list(parts.unbind(0)), rule[0], rule[1])
        out[k] = v
    return out


def _model_shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def state_dict_from_paddle(np_state: Dict[str, np.ndarray],
                           cfg) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from a JAX-package GPTForCausalLM
    (``{k: np.asarray(v) for k, v in m.state_dict().items()}``) to a
    state dict `GPTForCausalLM.load_state_dict` takes. Raises on a missing
    or unexpected name, or a shape the config does not give."""
    return _map(np_state, _expected_shapes(cfg))


def model_state_from_paddle(np_state: Dict[str, np.ndarray],
                            model: torch.nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from a JAX-package model (GPT, BERT, ViT,
    Swin, ...) onto the state dict of the port `model` of the same
    architecture."""
    return _map(np_state, _model_shapes(model), _paddle_layout(model))


def _to_torch(arr) -> torch.Tensor:
    """A writable tensor copy of a numpy array; bf16 arrays (ml_dtypes,
    which torch.from_numpy does not take) pass through f32 exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def train_state_from_paddle(jax_state: Dict, model: torch.nn.Module,
                            mesh=None) -> Dict:
    """Map a JAX-package ``TrainStep.state_dict()`` (step, the trainable
    parameters, per-parameter optimizer state, optimizer scalars, scaler)
    onto the port's ``TrainStep.set_state_dict`` layout for the port
    `model` (GPT, BERT, ViT, Swin, ResNet, ...). The optimizer state is
    any optimizer's: state shaped like its parameter (Adam's
    ``moment1``/``moment2``, Momentum's ``velocity``, ...) takes the
    parameter's ``[in, out]`` -> ``[out, in]`` transpose, and blockwise
    int8 codes and scales carry over as they are (the port blocks them in
    the JAX element order), so a port run resumes a JAX run on the same
    trajectory. Like the JAX state, this holds trainable parameters only:
    buffers (a ResNet's running statistics) travel in the model's own
    state dict. For a tensor-parallel GPT (`mesh`, else the active mesh,
    with ``mp`` > 1) the parameters and their parameter-shaped optimizer
    state (AdamW's moments, ...) are this rank's shards (`tp_split`; over
    ``ep``, `ep_split`); blockwise int8 moments are refused there."""
    from .distributed.mesh import get_mesh
    mesh = mesh if mesh is not None else get_mesh()
    n_mp = _axis(mesh, "mp")[0]
    keep = _paddle_layout(model)
    full = {}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        shape = list(p.shape)
        for attr, axis in (("mp_split", "mp"), ("ep_split", "ep")):
            rule = getattr(p, attr, None)
            if rule is not None:
                shape[rule[0]] *= _axis(mesh, axis)[0]
        full[n] = tuple(shape)
    params = _map(jax_state["params"], full, keep)
    out = {"step": int(jax_state.get("step", 0)), "params": params,
           "opt_extra": dict(jax_state.get("opt_extra", {}))}
    if "opt" in jax_state:
        opt = {}
        for name, st in jax_state["opt"].items():
            if name not in params:
                raise KeyError(f"optimizer state for unknown parameter "
                               f"{name}")
            flip = name not in keep and \
                _is_linear_weight(name, params[name].dim())
            entry = {}
            nb = -(-params[name].numel() // _Q_BLOCK)
            for k, v in st.items():
                if k in _PARAM_SHAPED_KEYS:
                    t = _to_torch(np.asarray(v).T if flip else v)
                    want = tuple(params[name].shape)
                elif k in _Q8_KEYS and (n_mp > 1 or ep_split(name)
                                        and _axis(mesh, "ep")[0] > 1):
                    raise NotImplementedError(
                        f"{name}.{k}: blockwise int8 moments do not shard "
                        f"over mp or ep")
                elif k in _Q8_KEYS:
                    t = _to_torch(v)
                    want = _Q8_KEYS[k](nb)
                else:
                    raise NotImplementedError(
                        f"{name}: optimizer state {k!r} is not ported")
                if tuple(t.shape) != want:
                    raise ValueError(f"{name}.{k}: shape {tuple(t.shape)} "
                                     f"!= {want} for parameter "
                                     f"{tuple(params[name].shape)}")
                entry[k] = _shard(name, t, mesh) \
                    if k in _PARAM_SHAPED_KEYS else t
            opt[name] = entry
        out["opt"] = opt
    out["params"] = {k: _shard(k, v, mesh) for k, v in params.items()}
    if "scaler" in jax_state:
        out["scaler"] = dict(jax_state["scaler"])
    return out


def _expected_shapes(cfg) -> Dict[str, tuple]:
    """Port-side (``nn.Linear`` layout) shape of every GPT parameter; an
    MoE block's experts and router keep the JAX shapes."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    e, n = cfg.moe_num_experts, max(1, cfg.moe_every_n_layers)
    shapes = {"gpt.wte.weight": (v, h),
              "gpt.wpe.weight": (cfg.max_position_embeddings, h),
              "gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"gpt.h.{i}."
        shapes.update({
            p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
            p + "attn.qkv.weight": (3 * h, h), p + "attn.qkv.bias": (3 * h,),
            p + "attn.out.weight": (h, h), p + "attn.out.bias": (h,),
            p + "ln_2.weight": (h,), p + "ln_2.bias": (h,)})
        if e and i % n == n - 1:
            shapes.update({
                p + "mlp.gate_weight": (h, e), p + "mlp.w1": (e, h, m),
                p + "mlp.b1": (e, m), p + "mlp.w2": (e, m, h),
                p + "mlp.b2": (e, h)})
        else:
            shapes.update({
                p + "mlp.up.weight": (m, h), p + "mlp.up.bias": (m,),
                p + "mlp.down.weight": (h, m), p + "mlp.down.bias": (h,)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (v, h)
    return shapes
