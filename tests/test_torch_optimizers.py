"""PyTorch port vs JAX package: the eleven optimizers (and AdamW's
`lr_ratio`), the three gradient clips, through both callers.

A small parameter set shaped like ResNet-50's kinds (a 3x3 conv weight,
a batch-norm scale and shift, the head's Linear weight and bias) takes 5
steps on seeded numpy gradients, through `Optimizer.step()` against the
JAX eager `step()` and through `TrainStep` against the JAX `TrainStep`
(whose loss, sum(p * G) over the parameters, gives each gradient G
exactly). Tolerances: f32 parameters and optimizer state within 1e-6 of
each tensor's largest magnitude; bf16 parameters within one bf16 step of
each element, and their f32 state within one bf16 step of the state's
largest magnitude. The Linear weight is [in, out] in the JAX package and
[out, in] in the port (its gradient and state transposed alike).

Divergences pinned here (ROADMAP C1): the JAX `TrainStep` applies only
ClipGradByGlobalNorm and skips the other two clips, the port applies all
three in both callers; Lamb's `exclude_from_weight_decay_fn` receives the
JAX Parameter there and the name in the port; `AdamW(lr_ratio=)` is
accepted and never read on both sides (Paddle would scale the rate).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.optimizer import optimizer as JO
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _is_linear_weight
from paddle_tpu_torch.optimizer.optimizer import quantile_linear

# name -> JAX-layout shape and the gradient scale drawn for it
SHAPES = {"conv1.weight": ((8, 4, 3, 3), 0.05), "bn1.weight": ((8,), 0.2),
          "bn1.bias": ((8,), 0.1), "fc.weight": ((6, 5), 0.5),
          "fc.bias": ((5,), 1.0)}
STEPS = 5


def _no_bn(name):
    return not name.startswith("bn1.")


# name -> (JAX class, port class, kwargs, JAX-only kwargs, port-only)
CASES = {
    "SGD": ("SGD", dict(learning_rate=0.05, weight_decay=0.01), {}, {}),
    "Momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=1e-3), {}, {}),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.8,
                                           use_nesterov=True), {}, {}),
    "Adam": ("Adam", dict(learning_rate=0.01, weight_decay=0.01), {}, {}),
    "AdamW": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05), {},
              {}),
    "AdamW_decay_fun": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05,
                                      apply_decay_param_fun=_no_bn), {}, {}),
    "AdamW_lr_ratio": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05,
                                     lr_ratio=lambda p: 0.1), {}, {}),
    "Adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01), {},
               {}),
    "Adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1), {}, {}),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9,
                                  weight_decay=0.01), {}, {}),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01), {}, {}),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True), {}, {}),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02), {},
             {}),
    "Lamb_exclude": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02),
                     dict(exclude_from_weight_decay_fn=lambda p:
                          p.name.endswith("bias")),
                     dict(exclude_from_weight_decay_fn=lambda n:
                          n.endswith("bias"))),
    "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1, lars_coeff=0.01,
                                          lars_weight_decay=0.001), {}, {}),
    "DGCMomentum": ("DGCMomentum", dict(learning_rate=0.05, sparsity=0.8,
                                        weight_decay=1e-3), {}, {}),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _init_params(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for n, (shape, _) in SHAPES.items():
        a = rng.uniform(-0.5, 0.5, shape)
        if n == "bn1.weight":
            a = 1.0 + 0.1 * a
        out[n] = a.astype(np.float32)
    return out


def _grads(seed=1):
    rng = np.random.RandomState(seed)
    return [{n: (rng.randn(*shape) * s).astype(np.float32)
             for n, (shape, s) in SHAPES.items()} for _ in range(STEPS)]


def _port_layout(name, a):
    return a.T if _is_linear_weight(name, a.ndim) else a


def _jax_opt(case, params, **extra):
    cls, kw, jkw, _ = CASES[case]
    return getattr(paddle.optimizer, cls)(parameters=params,
                                          **{**kw, **jkw, **extra})


def _port_opt(case, named, **extra):
    cls, kw, _, tkw = CASES[case]
    return getattr(pt.optimizer, cls)(parameters=named, device="cpu",
                                      **{**kw, **tkw, **extra})


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what, state=False):
    """f32: max |got - want| <= 1e-6 max |want|; bf16 parameters: within
    one bf16 step per element; bf16 runs' f32 state: one bf16 step of its
    largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        tol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol, what
    elif state:
        tol = 2.0 ** -8 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol, what
    else:
        step = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2 ** 16
        bad = np.abs(got - want) > step
        assert not bad.any(), f"{what}: {int(bad.sum())} elements more " \
                              f"than one bf16 step apart"


def _jax_params(init, jdt):
    out = []
    for n, a in init.items():
        p = Parameter(jnp.asarray(a).astype(jdt))
        p.name = n
        out.append(p)
    return out


def _port_params(init, tdt):
    return [(n, torch.nn.Parameter(torch.from_numpy(
        np.array(_port_layout(n, a))).to(tdt))) for n, a in init.items()]


def _compare(jparams, jstates, tparams, tstates, dtype, what):
    for (n, tp), jp, js, ts in zip(tparams, jparams, jstates, tstates):
        _close(tp, _port_layout(n, _np(jp._data if hasattr(jp, "_data")
                                       else jp)), dtype, f"{what} {n}")
        assert set(ts) == set(js), (what, n, set(ts), set(js))
        for k in js:
            _close(ts[k], _port_layout(n, _np(js[k])), dtype,
                   f"{what} {n} {k}", state=True)


# ------------------------------------------------------------ eager
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_step_matches_jax(case, dtype):
    jdt, tdt = DTYPES[dtype]
    init, grads = _init_params(), _grads()
    jparams = _jax_params(init, jdt)
    tparams = _port_params(init, tdt)
    jopt = _jax_opt(case, jparams)
    topt = _port_opt(case, tparams)
    for i, g in enumerate(grads):
        for p in jparams:
            p.grad = Tensor(jnp.asarray(g[p.name]).astype(jdt))
        for n, p in tparams:
            p.grad = torch.from_numpy(
                np.ascontiguousarray(_port_layout(n, g[n]))).to(tdt)
        jopt.step()
        topt.step()
        _compare(jparams, [jopt._states[id(p)] for p in jparams], tparams,
                 [topt._states[n] for n, _ in tparams], dtype,
                 f"{case} step {i + 1}")
    # the trajectory moved every parameter
    for (n, tp), a in zip(tparams, init.values()):
        assert not np.array_equal(_np(tp), _port_layout(n, a)), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_state_dict_round_trips(case):
    """Three steps, the optimizer's state dict into a fresh optimizer
    over copies of the parameters, two more steps on each: equal."""
    init, grads = _init_params(), _grads()
    a = _port_params(init, torch.float32)
    b = _port_params(init, torch.float32)
    oa = _port_opt(case, a)
    for i in range(STEPS):
        if i == 3:
            for (_, pb), (_, pa) in zip(b, a):
                pb.data.copy_(pa.data)
            ob = _port_opt(case, b)
            ob.set_state_dict(oa.state_dict())
        for n, p in a + (b if i >= 3 else []):
            p.grad = torch.from_numpy(
                np.ascontiguousarray(_port_layout(n, grads[i][n])))
        oa.step()
        if i >= 3:
            ob.step()
    for (n, pa), (_, pb) in zip(a, b):
        assert torch.equal(pa, pb), n
        for k in oa._states[n]:
            assert torch.equal(oa._states[n][k], ob._states[n][k]), (n, k)


# -------------------------------------------------------- TrainStep
class _JNet(paddle.nn.Layer):
    def __init__(self, init, jdt):
        super().__init__()
        self.conv1 = paddle.nn.Conv2D(4, 8, 3, bias_attr=False)
        self.bn1 = paddle.nn.BatchNorm2D(8)
        self.fc = paddle.nn.Linear(6, 5)
        for n, p in self.named_parameters():
            p.set_value(jnp.asarray(init[n]))
            p.name = n
        self.to(dtype="bfloat16" if jdt == jnp.bfloat16 else "float32")
        for n, p in self.named_parameters():
            p.name = n


class _TNet(torch.nn.Module):
    def __init__(self, init, tdt):
        super().__init__()
        self.conv1 = pt.nn.Conv2D(4, 8, 3, bias_attr=False, device="cpu")
        self.bn1 = pt.nn.BatchNorm2D(8, device="cpu")
        self.fc = torch.nn.Linear(6, 5)
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(torch.from_numpy(
                    np.ascontiguousarray(_port_layout(n, init[n]))))
        self.to(tdt)


def _jax_loss(jm):
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]

    def loss(*gs):
        total = None
        for p, g in zip(params, gs):
            term = (p * g).sum()
            total = term if total is None else total + term
        return total.astype("float32")
    return names, loss


def _port_loss(tm):
    params = [p for _, p in tm.named_parameters()]

    def loss(*gs):
        return sum((p * g).sum() for p, g in zip(params, gs)).float()
    return loss


def _batches(names, grads, jdt, tdt):
    jb = [[paddle.to_tensor(jnp.asarray(g[n]).astype(jdt)) for n in names]
          for g in grads]
    tb = [[torch.from_numpy(np.ascontiguousarray(
        _port_layout(n, g[n]))).to(tdt) for n in names] for g in grads]
    return jb, tb


def _train_steps(case, dtype, clip=None):
    jdt, tdt = DTYPES[dtype]
    init, grads = _init_params(), _grads()
    jm, tm = _JNet(init, jdt), _TNet(init, tdt)
    names, jloss = _jax_loss(jm)
    extra = {} if clip is None else dict(grad_clip=clip[0])
    js = paddle.jit.TrainStep(jm, _jax_opt(case, jm.parameters(), **extra),
                              jloss)
    textra = {} if clip is None else dict(grad_clip=clip[1])
    ts = pt.TrainStep(tm, _port_opt(case, tm.named_parameters(), **textra),
                      _port_loss(tm), device="cpu")
    return init, grads, names, jm, tm, js, ts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax_and_its_state_resumes(case, dtype):
    jdt, tdt = DTYPES[dtype]
    init, grads, names, jm, tm, js, ts = _train_steps(case, dtype)
    jb, tb = _batches(names, grads, jdt, tdt)
    saved = None
    for i in range(STEPS):
        if i == 3:
            saved = js.state_dict()
        js(*jb[i])
        ts(*tb[i])
        _compare([p for _, p in jm.named_parameters()], js._opt_state,
                 list(tm.named_parameters()), ts._opt_state, dtype,
                 f"{case} TrainStep step {i + 1}")
    # the JAX state after 3 steps resumes in a fresh port model and
    # optimizer (every state key carried, Linear state transposed)
    tm2 = _TNet(_init_params(seed=9), tdt)
    ts2 = pt.TrainStep(tm2, _port_opt(case, tm2.named_parameters()),
                       _port_loss(tm2), device="cpu")
    ts2.set_state_dict(pt.train_state_from_paddle(saved, tm2))
    assert ts2._step_i == 3
    for i in range(3, STEPS):
        ts2(*tb[i])
    _compare([p for _, p in jm.named_parameters()], js._opt_state,
             list(tm2.named_parameters()), ts2._opt_state, dtype,
             f"{case} resumed")


# ------------------------------------------------------------ clips
CLIPS = {"global_norm": ("ClipGradByGlobalNorm", (0.5,)),
         "norm": ("ClipGradByNorm", (0.3,)),
         "value": ("ClipGradByValue", (0.05,)),
         "value_min": ("ClipGradByValue", (0.08, -0.02))}


def _clip_pair(kind):
    cls, args = CLIPS[kind]
    return getattr(paddle.nn, cls)(*args), getattr(pt.nn, cls)(*args)


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clips_in_the_eager_step_match_jax(kind):
    jclip, tclip = _clip_pair(kind)
    init, grads = _init_params(), _grads()
    jparams = _jax_params(init, jnp.float32)
    tparams = _port_params(init, torch.float32)
    jopt = _jax_opt("Momentum", jparams, grad_clip=jclip)
    topt = _port_opt("Momentum", tparams, grad_clip=tclip)
    for i, g in enumerate(grads):
        for p in jparams:
            p.grad = Tensor(jnp.asarray(g[p.name]))
        for n, p in tparams:
            p.grad = torch.from_numpy(np.ascontiguousarray(
                _port_layout(n, g[n])))
        jopt.step()
        topt.step()
        _compare(jparams, [jopt._states[id(p)] for p in jparams], tparams,
                 [topt._states[n] for n, _ in tparams], "float32",
                 f"{kind} step {i + 1}")
    # the clip was active: an unclipped run ends elsewhere
    free = _port_params(init, torch.float32)
    fopt = _port_opt("Momentum", free)
    for g in grads:
        for n, p in free:
            p.grad = torch.from_numpy(np.ascontiguousarray(
                _port_layout(n, g[n])))
        fopt.step()
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(free,
                                                               tparams))


@pytest.mark.parametrize("kind", ["norm", "value"])
def test_train_step_applies_every_clip_where_jax_skips_two(kind):
    """The divergence: the port's TrainStep applies ClipGradByNorm and
    ClipGradByValue (so it equals the JAX eager step with the clip), while
    the JAX TrainStep ignores them (so it equals the port without a
    clip)."""
    jclip, tclip = _clip_pair(kind)
    init, grads, names, jm, tm, js, ts = _train_steps(
        "Momentum", "float32", clip=(jclip, tclip))
    jb, tb = _batches(names, grads, jnp.float32, torch.float32)
    jparams = _jax_params(init, jnp.float32)
    jopt = _jax_opt("Momentum", jparams, grad_clip=_clip_pair(kind)[0])
    tfree = _TNet(init, torch.float32)
    tsf = pt.TrainStep(tfree, _port_opt("Momentum", tfree.named_parameters()),
                       _port_loss(tfree), device="cpu")
    for i, g in enumerate(grads):
        js(*jb[i])
        ts(*tb[i])
        tsf(*tb[i])
        for p in jparams:
            p.grad = Tensor(jnp.asarray(g[p.name]))
        jopt.step()
    # port TrainStep == JAX eager with the clip
    _compare(jparams, [jopt._states[id(p)] for p in jparams],
             list(tm.named_parameters()), ts._opt_state, "float32",
             f"{kind}: port TrainStep vs JAX eager")
    # JAX TrainStep == port TrainStep without any clip
    _compare([p for _, p in jm.named_parameters()], js._opt_state,
             list(tfree.named_parameters()), tsf._opt_state, "float32",
             f"{kind}: JAX TrainStep vs port without clip")
    assert not torch.equal(tm.fc.weight, tfree.fc.weight)


def test_lr_ratio_changes_nothing_on_either_side():
    init, grads = _init_params(), _grads()
    out = {}
    for ratio in (None, lambda p: 0.1):
        jparams = _jax_params(init, jnp.float32)
        tparams = _port_params(init, torch.float32)
        jopt = paddle.optimizer.AdamW(0.01, parameters=jparams,
                                      lr_ratio=ratio)
        topt = pt.AdamW(0.01, parameters=tparams, lr_ratio=ratio,
                        device="cpu")
        for g in grads:
            for p in jparams:
                p.grad = Tensor(jnp.asarray(g[p.name]))
            for n, p in tparams:
                p.grad = torch.from_numpy(np.ascontiguousarray(
                    _port_layout(n, g[n])))
            jopt.step()
            topt.step()
        out[ratio is None] = ([_np(p._data) for p in jparams],
                              [_np(p) for _, p in tparams])
    for a, b in zip(out[True][0], out[False][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- DGC quantile
@pytest.mark.parametrize("n,q", [(1000, 0.999), (1001, 0.999), (37, 0.5),
                                 (2 ** 24 + 1, 0.999), (5, 0.8)])
def test_dgc_quantile_matches_jnp_quantile(n, q):
    """`jnp.quantile`'s linear interpolation with its f32 position (at
    2^24 + 1 elements the f32 position is whole, so no interpolation:
    a double-precision position would land between two elements), past
    `torch.quantile`'s 2^24-element limit."""
    x = np.random.RandomState(n % 1000).rand(n).astype(np.float32)
    want = float(jnp.quantile(jnp.asarray(x), q))
    got = float(quantile_linear(torch.from_numpy(x), q))
    assert got == pytest.approx(want, rel=1e-7, abs=0), (got, want)
    if n > 2 ** 24:
        with pytest.raises(RuntimeError):
            torch.quantile(torch.from_numpy(x), q)


def test_every_optimizer_is_exported_under_the_jax_name():
    names = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
             "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "DGCMomentum"]
    for n in names:
        assert getattr(pt.optimizer, n) is getattr(pt, n)
        assert getattr(JO, n) is getattr(paddle.optimizer, n)
    assert {c[0] for c in CASES.values()} == set(names)
    assert jax.devices()[0].platform == "cpu"


def test_every_optimizer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = torch.nn.Parameter(torch.ones(2))
    for case, (cls, kw, _, tkw) in CASES.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(pt.optimizer, cls)(parameters=[p], **{**kw, **tkw})
    with pytest.raises(TypeError, match="grad_clip"):
        pt.Momentum(0.1, parameters=[p], grad_clip=object(), device="cpu")
