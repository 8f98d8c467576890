"""PyTorch port vs JAX package: the numerics observability of the training
step (`debugging`, `amp.debugging`, `TrainStep(numerics=...)`).

A 2-layer GPT at hidden 64, f32, dropout 0, is built in the JAX package
and carried into the port through `convert.py`; both sides see the same
numpy token ids. Tolerances: stats counts (finite / nan / inf) exact;
absmax and l2 within 1e-4 relative; a mean within 1e-4 of the row's rms
(the means of LayerNorm outputs are roundoff around 0, so a relative
limit on them would compare noise); the grad norm within 1e-4 relative.

One-sided sublayers: the JAX GPT looks its position table up through the
`wpe` layer, so it records a `GPTForCausalLM/gpt/wpe` row; the port reads
`wpe.weight` with `F.embedding` and has none (`JAX_ONLY_ROWS`). Every
other path, grad rows included, is on both sides in the same order.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import debugging as jdbg
from paddle_tpu.amp import debugging as jamp_dbg
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch import debugging as tdbg
from paddle_tpu_torch.amp import debugging as tamp_dbg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=32, intermediate_size=128,
           hidden_dropout=0.0)
JAX_ONLY_ROWS = ("GPTForCausalLM/gpt/wpe",)
POISON = "gpt.h.1.mlp.up.weight"       # element [0, 0] on both layouts
POISON_ROW = "GPTForCausalLM/gpt/h/1/mlp/up"


def _pair(seed=0, **over):
    cfg = dict(CFG, **over)
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**{k: v for k, v in cfg.items()
                            if k not in ("use_recompute",)}))
    np_state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tcfg = pt.GPTConfig(**cfg)
    tm = pt.GPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(pt.state_dict_from_paddle(np_state, tcfg))
    return jm, tm


def _ids(seed, b=4, s=16):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (b, s)).astype(np.int64)


def _steps(jm, tm, n=2, accum=1, every=1, jcfg=None, tcfg=None):
    """n AdamW steps on both sides under numerics; returns the two
    TrainSteps and the last losses."""
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(
        jm, jopt, lambda a, b: jm.loss(a, b), grad_accum_steps=accum,
        numerics=jcfg or jdbg.NumericsConfig(every_n_steps=every))
    topt = pt.AdamW(1e-3, parameters=tm.named_parameters(), device="cpu")
    tstep = pt.TrainStep(
        tm, topt, lambda a, b: tm.loss(a, b), grad_accum_steps=accum,
        numerics=tcfg or tdbg.NumericsConfig(every_n_steps=every),
        device="cpu")
    for i in range(n):
        ids = _ids(10 + i)
        jl = jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
        tl = tstep(torch.from_numpy(ids), torch.from_numpy(ids))
    return jstep, tstep, float(jl), float(tl)


def _assert_rows_close(jtree, ttree, skip=JAX_ONLY_ROWS):
    jpaths = [p for p in jtree.paths if p not in skip]
    assert ttree.paths == jpaths
    for p in jpaths:
        a, b = jtree.row(p), ttree.row(p)
        for k in ("finite", "nan", "inf"):
            assert a[k] == b[k], (p, k, a, b)
        for k in ("absmax", "l2"):
            assert b[k] == pytest.approx(a[k], rel=1e-4, abs=1e-12), (p, k)
        rms = a["l2"] / math.sqrt(max(a["finite"], 1.0))
        assert abs(a["mean"] - b["mean"]) <= 1e-4 * max(abs(a["mean"]),
                                                        rms), p


@pytest.fixture(scope="module")
def clean_run():
    """Two clean steps on both sides, each fetch also landing in a
    StepMonitor. The trees, grad norms and reports are kept as they were
    after the clean steps; the steps themselves go on to the poisoned
    test."""
    jm, tm = _pair()
    jmon, tmon = paddle.profiler.StepMonitor(), pt.profiler.StepMonitor()
    jstep, tstep, jl, tl = _steps(
        jm, tm, jcfg=jdbg.NumericsConfig(every_n_steps=1, monitor=jmon),
        tcfg=tdbg.NumericsConfig(every_n_steps=1, monitor=tmon))
    return dict(jm=jm, tm=tm, jstep=jstep, tstep=tstep, jl=jl, tl=tl,
                jtree=jstep.numerics_stats(), ttree=tstep.numerics_stats(),
                jpaths=jstep.numerics_paths, tpaths=tstep.numerics_paths,
                jgn=float(np.asarray(jstep._last_aux["grad_norm"])),
                tgn=float(tstep._last_aux["grad_norm"]),
                groups=[k for k, _ in tstep._grad_groups],
                jreport=jmon.report(), treport=tmon.report())


def test_numerics_paths_and_activation_rows_match_jax(clean_run):
    r = clean_run
    assert r["tl"] == pytest.approx(r["jl"], rel=1e-5)
    assert r["tpaths"] == [p for p in r["jpaths"] if p not in JAX_ONLY_ROWS]
    # the rule chip_smoke.py holds the gpt3-1.3b tree to, at 2 layers
    assert r["tpaths"] == chip_smoke.numerics_paths(CFG["num_layers"])
    jt, tt = r["jtree"], r["ttree"]
    assert tt.step == jt.step == 2
    acts = [p for p in tt.paths if not p.startswith("grad:")]
    assert len(acts) == 21 and not tt.nonfinite_rows()
    _assert_rows_close(jt, tt)


def test_grad_rows_and_grad_norm_match_jax(clean_run):
    r = clean_run
    jt, tt = r["jtree"], r["ttree"]
    grads = [p for p in tt.paths if p.startswith("grad:")]
    assert grads == r["groups"] and len(grads) == 15
    for p in grads:
        a, b = jt.row(p), tt.row(p)
        assert a["finite"] == b["finite"]
        for k in ("absmax", "l2"):
            assert b[k] == pytest.approx(a[k], rel=1e-4), (p, k)
    assert r["tgn"] == pytest.approx(r["jgn"], rel=1e-4)


def test_monitor_receives_the_fetch(clean_run):
    """Each fetch lands one numerics row in the config's monitor, with the
    loss and grad norm as the JAX monitor records them."""
    jr, tr = clean_run["jreport"], clean_run["treport"]
    assert tr["numerics_events"] == jr["numerics_events"] == 0
    assert tr["loss"] == pytest.approx(jr["loss"], rel=1e-5)
    assert tr["grad_norm"] == pytest.approx(jr["grad_norm"], rel=1e-4)


def _poison_jax(jm):
    p = dict(jm.named_parameters())[POISON]
    a = np.array(p._data)
    a[0, 0] = np.inf
    p._data = paddle.to_tensor(a)._data


def _poison_port(tm):
    with torch.no_grad():
        dict(tm.named_parameters())[POISON][0, 0] = float("inf")


def _port_snapshot(tstep):
    params = {n: p.detach().clone() for n, p in tm_params(tstep)}
    opt = [{k: v.clone() for k, v in st.items()} for st in tstep._opt_state]
    return params, opt


def tm_params(tstep):
    return zip(tstep._param_names, tstep._params)


def test_poisoned_parameter_gives_the_same_event_and_skips(clean_run,
                                                          tmp_path):
    """One inf in a mid-stack weight: both sides name the same first
    non-finite row and fire the same first event kind there; the update
    is skipped bitwise on both (skip_nonfinite_updates), and the port's
    dump replays the event."""
    jm, tm = clean_run["jm"], clean_run["tm"]
    jstep, tstep = clean_run["jstep"], clean_run["tstep"]
    _poison_jax(jm)
    _poison_port(tm)
    jbefore = {n: np.array(p._data) for n, p in jm.named_parameters()}
    tparams, topt = _port_snapshot(tstep)
    jevents, tevents = [], []
    jstep._numerics.on_event = jevents.append
    tstep._numerics.on_event = tevents.append
    tstep._numerics.dump_dir = str(tmp_path)
    ids = _ids(20)
    jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    tstep(torch.from_numpy(ids), torch.from_numpy(ids))
    jt, tt = jstep.numerics_stats(), tstep.numerics_stats()
    assert jt.first_nonfinite()[0] == tt.first_nonfinite()[0] == POISON_ROW
    assert (jevents[0].kind, jevents[0].path) == \
        (tevents[0].kind, tevents[0].path) == ("inf", POISON_ROW)
    assert [(e.kind, e.path) for e in tevents if e.kind in ("nan", "inf")] \
        == [(e.kind, e.path) for e in jevents if e.kind in ("nan", "inf")
            and e.path not in JAX_ONLY_ROWS]
    for n, p in jm.named_parameters():
        np.testing.assert_array_equal(np.asarray(p._data), jbefore[n])
    for n, p in tm_params(tstep):
        assert torch.equal(p, tparams[n]), n
    for st, before in zip(tstep._opt_state, topt):
        assert all(torch.equal(st[k], before[k]) for k in st)
    # the dump holds the pre-step state and replays the event
    dumps = list(tmp_path.iterdir())
    assert [d.name for d in dumps] == ["step3_inf"]
    d = tdbg.load_dump(str(dumps[0]))
    assert d.meta["param_layout"] == tdbg.dump.PARAM_LAYOUT
    assert torch.equal(d.params[POISON], tparams[POISON])
    _, fresh = _pair(seed=1)
    res = tdbg.replay(d, fresh, lambda a, b: fresh.loss(a, b))
    assert (res.events[0].kind, res.events[0].path) == ("inf", POISON_ROW)
    assert res.matches is True
    assert res.stats.paths == tt.paths


def test_recompute_gives_the_same_rows_as_a_plain_model():
    """Under use_recompute the checkpoint regions run the forward again
    inside the backward; the collect scope is closed by then, so the
    rows (paths and values) equal a plain model's (within 1e-6)."""
    trees = []
    for remat in (False, True):
        _, tm = _pair(use_recompute=remat)
        tm.train()
        topt = pt.AdamW(1e-3, parameters=tm.named_parameters(), device="cpu")
        tstep = pt.TrainStep(tm, topt, lambda a, b: tm.loss(a, b),
                             numerics=True, device="cpu")
        ids = torch.from_numpy(_ids(30))
        tstep(ids, ids)
        trees.append(tstep.numerics_stats())
    plain, remat = trees
    assert remat.paths == plain.paths
    np.testing.assert_allclose(remat.values, plain.values, rtol=1e-6,
                               atol=1e-9)


def test_grad_accum_merges_rows_as_jax():
    jm, tm = _pair()
    jstep, tstep, jl, tl = _steps(jm, tm, n=1, accum=2)
    assert tl == pytest.approx(jl, rel=1e-5)
    _assert_rows_close(jstep.numerics_stats(), tstep.numerics_stats())


def _stream():
    """A scalar stream with a loss spike, a grad explosion, a non-finite
    loss, and trees with a NaN row and a dead layer."""
    losses = [2.0, 1.9, 1.95, 1.85, 1.9, 1.88, 9.0, 1.87, float("nan")]
    norms = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0, 1.02, 50.0, 1.0]
    return list(zip(losses, norms))


@pytest.mark.parametrize("with_tree", [False, True])
def test_anomaly_detectors_give_equal_events(with_tree):
    jdet, tdet = jdbg.AnomalyDetector(), tdbg.AnomalyDetector()
    paths = ["M/a", "M/b", "grad:M/a"]
    for step, (loss, gn) in enumerate(_stream(), 1):
        vals = np.array([[4, 0, 0, 1.0, 0.1, 2.0],
                         [4, 0, 0, 0.0 if step > 3 else 0.5, 0.0, 0.0],
                         [3, 1 if step == 5 else 0, 0, 1.0, 0.2, 1.0]],
                        np.float32)
        jt = jdbg.StatsTree(paths, vals, step) if with_tree else None
        tt = tdbg.StatsTree(paths, vals, step) if with_tree else None
        je = jdet.observe(step, tree=jt, loss=loss, grad_norm=gn)
        te = tdet.observe(step, tree=tt, loss=loss, grad_norm=gn)

        def strip(events):
            return [{k: v for k, v in e.to_dict().items() if k != "ts"}
                    for e in events]
        assert strip(te) == strip(je)
    kinds = {e.kind for e in tdet.events}
    assert {"loss_spike", "grad_explosion"} <= kinds
    if with_tree:
        assert {"nan", "dead_layer"} <= kinds


_CHECKS = {
    "clean": np.linspace(-1, 1, 12, dtype=np.float32),
    "nan": np.array([1.0, np.nan, 2.0, np.nan], np.float32),
    "inf": np.array([np.inf, -np.inf, 0.5], np.float32),
    "mixed": np.array([[np.nan, 1.0], [np.inf, 3.0]], np.float32),
    "int": np.arange(6, dtype=np.int32),
    "f64_big": np.array([1e300, -1e300, 1.0], np.float64),
}


@pytest.mark.parametrize("case", sorted(_CHECKS))
def test_check_numerics_agrees_with_jax(case):
    a = _CHECKS[case]
    outcomes = []
    for fn, t in ((jamp_dbg.check_numerics, paddle.to_tensor(a)
                   if a.dtype != np.float64 else a),
                  (tamp_dbg.check_numerics, torch.from_numpy(a))):
        try:
            fn(t, op_type="op", var_name="x")
            outcomes.append(None)
        except FloatingPointError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "mixed"])
def test_array_stats_match_jax(case):
    a = _CHECKS[case]
    j = np.asarray(jdbg.array_stats(paddle.to_tensor(a)._data))
    t = tdbg.array_stats(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(t[:3], j[:3])
    np.testing.assert_allclose(t[3:], j[3:], rtol=1e-6, atol=1e-7)


def test_tensor_checker_config_maps_onto_numerics_config():
    for mode, abort in ((None, True),
                        (tamp_dbg.DebugMode.CHECK_NAN_INF, False)):
        cfg = tamp_dbg.TensorCheckerConfig(debug_mode=mode,
                                           output_dir="d").to_numerics_config()
        jcfg = jamp_dbg.TensorCheckerConfig(
            debug_mode=mode, output_dir="d").to_numerics_config()
        assert (cfg.every_n_steps, cfg.dump_dir, cfg.raise_on_nonfinite) \
            == (jcfg.every_n_steps, jcfg.dump_dir, jcfg.raise_on_nonfinite) \
            == (1, "d", abort)
    assert tdbg.NumericsConfig.coerce(
        tamp_dbg.TensorCheckerConfig(enable=False)) is None
    assert tdbg.NumericsConfig.coerce(True).every_n_steps == 0
    tamp_dbg.enable_tensor_checker(tamp_dbg.TensorCheckerConfig())
    assert pt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    assert tamp_dbg.get_tensor_checker_config() is not None
    tamp_dbg.disable_tensor_checker()
    assert not pt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    assert tamp_dbg.get_tensor_checker_config() is None


def test_stats_stay_on_the_device_between_fetches():
    """With every_n_steps=0 nothing is fetched: the stats are a tensor on
    the step's aux until numerics_stats() reads them."""
    _, tm = _pair()
    topt = pt.AdamW(1e-3, parameters=tm.named_parameters(), device="cpu")
    seen = []
    cfg = tdbg.NumericsConfig(every_n_steps=0, on_event=seen.append)
    tstep = pt.TrainStep(tm, topt, lambda a, b: tm.loss(a, b),
                         numerics=cfg, device="cpu")
    ids = torch.from_numpy(_ids(40))
    tstep(ids, ids)
    assert torch.is_tensor(tstep._last_aux["stats"])
    assert tstep._last_aux["stats"].shape == (len(tstep.numerics_paths), 6)
    assert cfg.detector.events == [] and seen == []
    assert len(tstep.numerics_stats()) == len(tstep.numerics_paths)


def test_dump_round_trips_bf16_and_the_optimizer_state(tmp_path):
    """A dump stores bf16 tensors as their bit patterns and restores them
    exactly; the optimizer state and the generator state come back as
    written."""
    p = torch.randn(3, 4).to(torch.bfloat16)
    st = {"moment1": torch.randn(3, 4).to(torch.bfloat16),
          "moment2": torch.rand(3, 4)}
    gen = torch.Generator().manual_seed(7)
    ev = [tdbg.NumericsEvent("nan", 5, path="M/a")]
    path = tdbg.write_dump(
        str(tmp_path), step=5, events=ev,
        batch_leaves=[torch.arange(6).reshape(2, 3)],
        batch_spec=tdbg.tree_spec((0,)), param_names=["w"],
        param_arrays=[p], opt_state=[st], generator_state=gen.get_state())
    d = tdbg.load_dump(path)
    assert d.params["w"].dtype == torch.bfloat16
    assert torch.equal(d.params["w"], p)
    assert torch.equal(d.opt_state["w::moment1"], st["moment1"])
    assert torch.equal(d.opt_state["w::moment2"], st["moment2"])
    assert torch.equal(d.generator_state(), gen.get_state())
    assert torch.equal(d.batch()[0], torch.arange(6).reshape(2, 3))
    assert d.step == 5 and d.events[0]["path"] == "M/a"
    assert d.meta["bit_dtypes"] == {"param:w": "bfloat16",
                                    "opt:w::moment1": "bfloat16"}
