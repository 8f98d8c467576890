"""The ranks of the port's multi-process CPU tests (test_torch_collective,
test_torch_mpu, test_torch_gpt_tp, test_torch_sharded_serving).

This module imports torch, numpy and the port only: the spawned ranks
never import JAX or the tests' conftest. Each rank runs on one CPU
thread, joins a gloo group through a FileStore under the test's tmp_path
(so parallel test workers never share a TCP port), reads its inputs from
``inputs.npz`` in the run directory and writes ``rank{r}.npz`` there.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as D
from paddle_tpu_torch.distributed import mpu
from paddle_tpu_torch.ops import linear_ce as LC

WORLD = 4


def run(func, run_dir, nprocs=WORLD):
    """Start `nprocs` ranks of `func(run_dir)`; each meets the others in
    run_dir/store."""
    wait(start(func, run_dir, nprocs))


def start(func, run_dir, nprocs=WORLD):
    """`run` without waiting, so the caller's own work (the JAX
    reference) overlaps the ranks'; `wait` joins them."""
    return D.spawn(func, args=(str(run_dir),), nprocs=nprocs, join=False)


def wait(ctx):
    from paddle_tpu_torch.distributed.spawn import wait as join
    join(ctx, timeout=300)


def _join(run_dir):
    torch.set_num_threads(1)
    D.init_parallel_env(init_method="file://" + os.path.join(run_dir, "store"),
                        device="cpu")
    inputs = dict(np.load(os.path.join(run_dir, "inputs.npz")))
    return D.get_rank(), inputs


def _save(run_dir, rank, out):
    import sys
    out["foreign_modules"] = np.array(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")),
        dtype=str)
    np.savez(os.path.join(run_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    D.destroy_parallel_env()


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------- collectives
def collectives(run_dir):
    """Every collective over the world group, and all_reduce /
    all_gather / reduce_scatter / broadcast over the mp axis of a dp2 x
    mp2 mesh; rank r's input is row r of the stacked inputs."""
    r, inp = _join(run_dir)
    x = inp["x"][r]                     # [4, 6] per rank
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        t = _t(x)
        D.all_reduce(t, op=op)
        out[f"all_reduce_{op}"] = t
    out["all_gather"] = D.all_gather(_t(x))
    lst = []
    D.all_gather(lst, _t(x))
    out["all_gather_list"] = torch.stack(lst)
    t = _t(x)
    D.broadcast(t, src=2)
    out["broadcast"] = t
    for op in ("sum", "max"):
        t = _t(x)
        D.reduce(t, dst=1, op=op)
        out[f"reduce_{op}"] = t
    out["reduce_scatter"] = D.reduce_scatter(_t(x))
    t = torch.empty(6, dtype=torch.float32)
    D.reduce_scatter(t, [_t(row) for row in x])
    out["reduce_scatter_list"] = t
    out["alltoall"] = D.alltoall(_t(x))
    lst = []
    D.alltoall([_t(row) for row in x], lst)
    out["alltoall_list"] = torch.stack(lst)
    out["scatter"] = D.scatter(_t(inp["x"][r]), src=3)
    t = torch.empty(6, dtype=torch.float32)
    D.scatter(t, [_t(row) for row in x], src=0)
    out["scatter_list"] = t
    # a ring of point-to-point messages: r sends to r+1, receives r-1
    buf = torch.empty(6, dtype=torch.float32)
    if r % 2 == 0:
        D.send(_t(x[0]), dst=(r + 1) % WORLD)
        D.recv(buf, src=(r - 1) % WORLD)
    else:
        D.recv(buf, src=(r - 1) % WORLD)
        D.send(_t(x[0]), dst=(r + 1) % WORLD)
    out["p2p"] = buf
    D.barrier()
    mesh = D.build_mesh({"dp": 2, "mp": 2})
    g = mesh.group("mp")
    t = _t(x)
    D.all_reduce(t, group=g)
    out["mp_all_reduce"] = t
    out["mp_all_gather"] = D.all_gather(_t(x), group=g)
    out["mp_reduce_scatter"] = D.reduce_scatter(_t(x), group=g)
    t = _t(x)
    D.broadcast(t, src=g.ranks[1], group=g)
    out["mp_broadcast"] = t
    out["coords"] = np.array([mesh.axis_rank("dp"), mesh.axis_rank("mp")])
    out["dp_ranks"] = np.array(mesh.group("dp").ranks)
    out["mp_ranks"] = np.array(g.ranks)
    _save(run_dir, r, {k: v.numpy() if torch.is_tensor(v) else v
                       for k, v in out.items()})


# ------------------------------------------------------------------- mpu
def _grads(loss, tensors):
    return [g.detach() for g in torch.autograd.grad(loss, tensors)]


def mpu_layers(run_dir):
    """At mp 2 (a dp2 x mp2 mesh) and mp 4: the column -> relu -> row
    MLP, the vocab-parallel embedding, ParallelCrossEntropy and the
    vocab-parallel linear CE, forward and gradients, each rank's shards
    loaded from the full weights; the sharded gradients gathered."""
    r, inp = _join(run_dir)
    out = {}
    for mp in (2, 4):
        mesh = D.build_mesh({"dp": WORLD // mp, "mp": mp})
        D.set_mesh(mesh)
        g = mesh.group("mp")
        gather = (lambda t, dim: mpu.gather_shards(
            list(D.all_gather(t.contiguous(), group=g).unbind(0)), dim, 1))
        # column -> relu -> row
        fc1 = mpu.ColumnParallelLinear(8, 16, gather_output=False,
                                       device="cpu")
        fc2 = mpu.RowParallelLinear(16, 8, input_is_parallel=True,
                                    device="cpu")
        with torch.no_grad():
            fc1.weight.copy_(mpu.shard_of(_t(inp["w1"]).t(), 0, 1, g.rank,
                                          mp))
            fc1.bias.copy_(mpu.shard_of(_t(inp["b1"]), 0, 1, g.rank, mp))
            fc2.weight.copy_(mpu.shard_of(_t(inp["w2"]).t(), 1, 1, g.rank,
                                          mp))
            fc2.bias.copy_(_t(inp["b2"]))
        x = _t(inp["x"]).requires_grad_(True)
        y = fc2(torch.relu(fc1(x)))
        loss = (y * _t(inp["dy"])).sum()
        gx, gw1, gb1, gw2, gb2 = _grads(loss, [x, fc1.weight, fc1.bias,
                                               fc2.weight, fc2.bias])
        out.update({f"mp{mp}_mlp_y": y.detach(), f"mp{mp}_mlp_dx": gx,
                    f"mp{mp}_mlp_dw1": gather(gw1, 0).t(),
                    f"mp{mp}_mlp_db1": gather(gb1, 0),
                    f"mp{mp}_mlp_dw2": gather(gw2, 1).t(),
                    f"mp{mp}_mlp_db2": gb2})
        # embedding
        emb = mpu.VocabParallelEmbedding(32, 8, device="cpu")
        with torch.no_grad():
            emb.weight.copy_(mpu.shard_of(_t(inp["emb"]), 0, 1, g.rank, mp))
        e = emb(_t(inp["ids"]))
        (gw,) = _grads((e * _t(inp["de"])).sum(), [emb.weight])
        out.update({f"mp{mp}_emb": e.detach(),
                    f"mp{mp}_emb_dw": gather(gw, 0)})
        # ParallelCrossEntropy on this rank's vocabulary slice of logits
        lg_full = _t(inp["logits"])
        lg = mpu.shard_of(lg_full, 1, 1, g.rank, mp).requires_grad_(True)
        ce = mpu.ParallelCrossEntropy()(lg, _t(inp["labels"]))
        (glg,) = _grads(ce.sum(), [lg])
        out.update({f"mp{mp}_pce": ce.detach(),
                    f"mp{mp}_pce_dlogits": gather(glg, 1)})
        # the vocab-parallel linear cross-entropy (#11's route)
        for layout in ("vh", "hv"):
            w_full = _t(inp["head"])                   # [V, H]
            w_full = w_full if layout == "vh" else w_full.t().contiguous()
            w = mpu.shard_of(w_full, 0 if layout == "vh" else 1, 1, g.rank,
                             mp).requires_grad_(True)
            hx = _t(inp["hx"]).requires_grad_(True)
            loss = LC.vocab_parallel_linear_cross_entropy(
                hx, w, _t(inp["hlabels"]), g, w_layout=layout)
            gxx, gww = _grads((loss * _t(inp["hg"])).sum(), [hx, w])
            out.update({f"mp{mp}_lce_{layout}": loss.detach(),
                        f"mp{mp}_lce_{layout}_dx": gxx,
                        f"mp{mp}_lce_{layout}_dw":
                            gather(gww, 0 if layout == "vh" else 1)})
        # paddle.distributed.split builds the layer and returns its output
        x8 = _t(inp["x"])
        out[f"mp{mp}_split_shapes"] = np.array(json.dumps([
            list(mpu.split(x8, (8, 16), "linear", axis=1,
                           gather_out=gather).shape)
            for gather in (True, False)] + [
            list(mpu.split(x8, (8, 6), "linear", axis=0).shape),
            list(mpu.split(_t(inp["ids"]), (32, 8), "embedding").shape)]))
        D.set_mesh(None)
    _save(run_dir, r, out)


# -------------------------------------------------------------- GPT, TP
def _gpt_cfg(inp, **kw):
    cfg = {k[4:]: int(v) for k, v in inp.items() if k.startswith("cfg_")}
    cfg.update(kw)
    return pt.GPTConfig(**cfg)


def _np_state(inp):
    return {k[6:]: v for k, v in inp.items() if k.startswith("state:")}


def _adamw_step(model, clip, mesh):
    opt = pt.AdamW(1e-3, parameters=model.named_parameters(),
                   weight_decay=0.01,
                   grad_clip=pt.ClipGradByGlobalNorm(clip), device="cpu")
    return pt.TrainStep(model, opt,
                        lambda a, b, m: model.loss(a, b, loss_mask=m,
                                                   chunk_size=8),
                        mesh=mesh, device="cpu")


def gpt_tp(run_dir):
    """The tiny GPT at dp2 x mp2 for 3 AdamW steps from the full weights
    with the clip active and an uneven loss mask (losses, gathered final
    parameters, this rank's replicated parameters), the shard -> gather
    round trip, hidden-dropout masks, and the first loss with qkv split as
    a contiguous third of 3H (the control)."""
    r, inp = _join(run_dir)
    strategy = pt.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    pt.fleet.init(strategy=strategy, device="cpu")
    mesh = D.get_mesh()
    cfg = _gpt_cfg(inp)
    np_state = _np_state(inp)
    out = {"coords": np.array([mesh.axis_rank("dp"), mesh.axis_rank("mp")])}
    full = pt.state_dict_from_paddle(np_state, cfg)
    shards = pt.shard_state_from_paddle(np_state, cfg)
    back = pt.gather_state(shards)
    out["roundtrip_bitwise"] = np.array(all(
        torch.equal(back[k], full[k]) for k in full))
    model = pt.GPTForCausalLM(cfg, device="cpu")
    out["splits_match"] = np.array(all(
        getattr(p, "mp_split", None) == pt.convert.tp_split(n)
        for n, p in model.named_parameters()))
    model.load_state_dict(shards)
    with torch.no_grad():
        out["logits"] = model(_t(inp["ids"])[:2])   # gathered over mp
    step = _adamw_step(model, float(inp["clip"]), mesh)
    ids, mask = _t(inp["ids"]), _t(inp["mask"])
    out["losses"] = np.array([float(step(ids, ids, mask))
                              for _ in range(3)])
    final = pt.gather_state({n: p.detach()
                             for n, p in model.named_parameters()})
    for n, v in final.items():
        out["param:" + n] = v
    for n, p in model.named_parameters():
        if getattr(p, "mp_split", None) is None:
            out["local:" + n] = p.detach()
    # hidden dropout: the masks of two draws on this rank
    dm = pt.GPTForCausalLM(_gpt_cfg(inp, hidden_dropout=0.5), device="cpu",
                           seed=3)
    out["drop"] = torch.stack([dm.gpt._drop(torch.ones(4, 64)) != 0
                               for _ in range(2)])
    # the RNG tracker's streams: "global_seed" replicated over mp,
    # "local_seed" different on every rank
    mpu.model_parallel_random_seed(5)
    tracker = mpu.get_rng_state_tracker()
    before, draws = torch.get_rng_state(), {}
    for name in (mpu.GLOBAL_RNG, mpu.MODEL_PARALLEL_RNG):
        with tracker.rng_state(name):
            draws[name] = torch.rand(8)
    out["rng_global"] = draws[mpu.GLOBAL_RNG]
    out["rng_local"] = draws[mpu.MODEL_PARALLEL_RNG]
    out["rng_default_kept"] = np.array(torch.equal(before,
                                                   torch.get_rng_state()))
    # recompute under TP with hidden dropout: the recomputed regions rerun
    # the row-parallel all-reduces and replay the dropout masks, so loss
    # and gradients equal the run without recompute
    grads = []
    for remat in (False, True):
        rm = pt.GPTForCausalLM(_gpt_cfg(inp, hidden_dropout=0.1,
                                        use_recompute=remat), device="cpu")
        rm.load_state_dict(shards)
        rm.train()
        loss = rm.loss(step._dp_rows(ids), step._dp_rows(ids), chunk_size=8)
        grads.append([loss.detach()] + _grads(loss, list(rm.parameters())))
    out["recompute_max_diff"] = np.array(max(
        float((a - b).abs().max()) for a, b in zip(*grads)))
    # the GradScaler's found-inf flag is max-reduced over the world: a
    # replicated layer whose loss overflows on rank 0 only (no collective
    # in its forward or backward) skips the update on every rank
    flat = D.build_mesh({"dp": 1, "mp": 4})
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 4)
    w0 = lin.weight.detach().clone()
    scaler = pt.GradScaler(init_loss_scaling=1024.0)
    sopt = pt.AdamW(0.1, parameters=lin.named_parameters(), device="cpu")
    sstep = pt.TrainStep(lin, sopt, lambda x: lin(x).sum() * (
        float("inf") if r == 0 else 1.0), mesh=flat, scaler=scaler,
        device="cpu")
    sstep(torch.ones(2, 4))
    out["scaler_skipped"] = np.array(torch.equal(lin.weight, w0))
    out["scaler_scale"] = np.array(float(scaler.state_arrays()[0]))
    # the contiguous-3H control: rank r takes rows [r 3H/mp, (r+1) 3H/mp)
    bad = dict(shards)
    g = mesh.group("mp")
    for k in full:
        if k.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            bad[k] = mpu.shard_of(full[k], 0, 1, g.rank, g.nranks)
    ctrl = pt.GPTForCausalLM(cfg, device="cpu")
    ctrl.load_state_dict(bad)
    with torch.no_grad():
        from paddle_tpu_torch.distributed.mesh import data_parallel_loss
        with data_parallel_loss(mesh.group("dp")):
            rows = step._dp_rows
            lc = ctrl.loss(rows(ids), rows(ids), loss_mask=rows(mask),
                           chunk_size=8)
        lc = lc.clone()
        D.all_reduce(lc, group=mesh.group("dp"))
    out["control_loss"] = np.array(float(lc) / 2)
    _save(run_dir, r, out)


# ------------------------------------------------ sharded paged serving
SERVE_BASE = dict(max_batch=2, prompt_cap=8, max_new_tokens=6,
                  decode_chunk=2, paged=True, kv_block=4)
# (leg, engine options, traffic seed, prompt lengths, passes): the JAX
# sharded-serving suite's traffic, plus int8 KV, int8 weights and sampling
SERVE_LEGS = (
    ("plain", {}, 3, (8, 7, 3, 5), 1),
    ("prefix", dict(prefix_cache=True, kv_blocks=48), 7, (8, 8, 5), 2),
    ("chunked", dict(prefill_chunk=3), 11, (8, 7, 8), 1),
    ("spec", dict(prefix_cache=True, kv_blocks=64, spec_decode=True,
                  spec_k=3), 13, (8, 8), 2),
    ("int8_kv", dict(cache_dtype="int8"), 3, (8, 7, 3, 5), 1),
    ("int8_weights", dict(weight_dtype="int8"), 3, (8, 7, 3, 5), 1),
    ("sampled", dict(temperature=0.9, top_k=20, seed=5), 3, (8, 7, 3, 5),
     1),
)
# bf16 legs, held to the port's one-card engine: the row-parallel partial
# products are summed over the ranks in f32 and rounded once
BF16_LEGS = (
    ("bf16_plain", {}, 3, (8, 7, 3, 5), 1),
    ("bf16_int8_weights", dict(weight_dtype="int8"), 3, (8, 7, 3, 5), 1),
)


def serve_prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def serve_pass(eng, prompts):
    """Submit every prompt, drain; the chains in submission order."""
    reqs = [eng.submit(p) for p in prompts]
    eng.drain()
    return [[int(t) for t in r.tokens] for r in reqs]


def _watch(eng, group, rec):
    """Wrap the runner's ops on this rank: count forwards, the mp
    all-reduces each op made, and keep every token tensor an op returned
    (the leader's and a follower's must be bitwise equal)."""
    h = eng._runner.handlers
    forwards = {"prefill": lambda a: 1, "decode": lambda a: int(a[4]),
                "verify": lambda a: 1, "reference": lambda a: int(a[2])}

    def wrap(op, f):
        def run(*a, extra=None):
            before = group.all_reduces
            res = f(*a, extra=extra)
            made = group.all_reduces - before
            rec.setdefault("ops", []).append(
                [op, forwards.get(op, lambda a: 0)(a), made])
            if op in ("prefill", "decode", "verify"):
                t = res if torch.is_tensor(res) else res[0]
                rec.setdefault("tokens", []).append(t.tolist())
            return res
        return run
    for op in list(h):
        h[op] = wrap(op, h[op])


def _serve_model(cfg, np_state, mesh=None):
    m = pt.GPTForCausalLM(cfg, device="cpu")
    m.load_state_dict(pt.shard_state_from_paddle(np_state, cfg, mesh))
    return m


def _engine(model, n, **kw):
    return pt.ServingEngine(model, pt.ServingConfig(
        **dict(SERVE_BASE, shards=n, **kw)))


def _save_json(run_dir, rank, out):
    import sys
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu"))
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy_parallel_env()


def _raises(fn):
    try:
        fn()
    except Exception as exc:            # the kind and the words
        return [type(exc).__name__, str(exc)]
    return None


def _spill_legs(eng, prompt, out, tag):
    """On the leader: a cached block's full-width payload, written into a
    fresh block and read back; the payload is kept for the parent."""
    serve_pass(eng, [prompt])
    blk = int(eng._prefix.match(prompt)[0][0])
    payload = eng.read_block(blk)
    dst = eng._pool.take(1)[0]
    eng._spill_write(dst, payload)
    back = eng.read_block(dst)
    eng._pool.release([dst])
    out[f"spill_{tag}"] = {
        "shapes": [list(t.shape) for t in payload],
        "dtypes": [str(t.dtype) for t in payload],
        "payload": [t.float().tolist() for t in payload],
        "round_trip_bitwise": all(torch.equal(a, b)
                                  for a, b in zip(payload, back))}


def sharded_serving(run_dir):
    """The sharded engine on a mesh of mp = the world size, from the JAX
    weights: the validation errors, a follower's submit, then every leg
    of SERVE_LEGS (the leader serves, the followers follow), the spill
    legs, an evict -> spill -> rehydrate engine, the int8 payload's
    scales, the compile counters, the pools' shapes; on four ranks also
    two engines of a dp2 x mp2 mesh at once (leaders 0 and 2)."""
    r, inp = _join(run_dir)
    n = D.get_world_size()
    cfg = _gpt_cfg(inp)
    np_state = _np_state(inp)
    out = {"rank": r}
    # validation: no mesh, the model's degree, more shards than ranks,
    # heads that do not split, a mesh of another mp
    plain = _serve_model(cfg, np_state)
    mesh = D.build_mesh({"mp": n})
    D.set_mesh(mesh)
    g = mesh.group("mp")
    out["errors"] = {
        "model_degree": _raises(lambda: _engine(plain, n)),
        "more_than_ranks": _raises(lambda: _engine(plain, 2 * n)),
        "heads": _raises(lambda: _engine(plain, 3)),
    }
    model = _serve_model(cfg, np_state)
    if n == 4:
        out["errors"]["mesh_mp"] = _raises(lambda: _engine(model, 2))
    # an idle leader keeps its followers waiting, not timing out: the
    # keepalive sends NOOP headers while it sits idle
    from paddle_tpu_torch.inference import sharded
    keep = sharded.KEEPALIVE_S
    sharded.KEEPALIVE_S = 0.1
    eng = _engine(model, n)
    if eng.is_leader:
        time.sleep(0.5)
        serve_pass(eng, serve_prompts(cfg.vocab_size, (3,), 1))
        eng.close()
    else:
        eng.follow()
    out["noops"] = eng._runner.stats["noop"]["calls"]
    sharded.KEEPALIVE_S = keep
    # the legs
    vocab = cfg.vocab_size
    legs = {}
    bf16 = _serve_model(cfg, np_state).to(torch.bfloat16)
    for name, kw, seed, lens, passes in SERVE_LEGS + BF16_LEGS:
        rec = {}
        env = {"PADDLE_TPU_Q8_DECODE_MIN": "1"} \
            if kw.get("weight_dtype") else {}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        eng = _engine(bf16 if name.startswith("bf16") else model, n, **kw)
        _watch(eng, g, rec)
        rec["pool_shapes"] = [list(t.shape) for t in eng._pools[0]]
        if eng.is_leader:
            prompts = serve_prompts(vocab, lens, seed)
            rec["chains"] = [serve_pass(eng, prompts)
                             for _ in range(passes)]
            c = eng.metrics.counters
            rec["counters"] = {k: c[k] for k in ("spec_windows",
                                                 "prefix_hit")}
            if name == "prefix":
                # a full hit's copy-on-write: no collective
                rec["cow_ops"] = sum(1 for o in rec["ops"] if o[0] == "cow")
            if name == "plain":
                # the probes' goldens: the static generator on every rank
                ids = np.zeros((len(prompts), 8), np.int64)
                for i, p in enumerate(prompts):
                    ids[i, :len(p)] = p
                rec["reference"] = eng.generate_reference(
                    ids, [len(p) for p in prompts], 6)[:, 8:].tolist()
            eng.close()
        else:
            if name == "plain":
                out["follower_submit"] = _raises(
                    lambda: eng.submit(np.ones(3, np.int64)))
                out["follower_step"] = _raises(eng.step)
            eng.follow()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        legs[name] = rec
    out["legs"] = legs
    out["L"] = cfg.num_layers
    # the spill codec: full-width payloads, round trips, rehydrates
    prompt = serve_prompts(vocab, (8,), 29)[0]
    for cd in (None, "int8"):
        eng = _engine(model, n, prefix_cache=True, kv_blocks=48,
                      cache_dtype=cd)
        if eng.is_leader:
            _spill_legs(eng, prompt, out, str(cd))
            eng.close()
        else:
            eng.follow()
    # evict -> spill -> rehydrate: a 2-block device budget of this rank's
    # blocks, against an engine that never evicts
    ids = serve_prompts(vocab, (8, 8, 8), 3)
    for cd in (None, "int8"):
        bpb = pt.BlockPool.for_model(model, num_blocks=2, block_size=4,
                                     cache_dtype=cd).bytes_per_block
        for tag, kw in (("spill", dict(prefix_cache_bytes=2 * bpb,
                                       spill_host_bytes=(1 << 10) * bpb)),
                        ("never", {})):
            eng = _engine(model, n, prefix_cache=True, kv_blocks=40,
                          cache_dtype=cd, **kw)
            if eng.is_leader:
                chains = [serve_pass(eng, [p])[0] for p in ids]
                chains.append(serve_pass(eng, [ids[0]])[0])
                out[f"evict_{tag}_{cd}"] = {
                    "chains": chains,
                    "stats": None if eng._spill is None
                    else eng._spill.stats()}
                eng.close()
            else:
                eng.follow()
    # the int8 payload: codes and scales of every projection, gathered,
    # and the local-absmax control on attn.out
    os.environ["PADDLE_TPU_Q8_DECODE_MIN"] = "1"
    model.gather_serving_tables(g)
    qp = model.quantized_params()
    q8 = {}
    for name in ("gpt.h.0.attn.qkv.weight", "gpt.h.0.attn.out.weight",
                 "gpt.h.1.mlp.up.weight", "gpt.h.1.mlp.down.weight",
                 "gpt.wte.weight"):
        codes, scale = qp[name]
        p = dict(model.named_parameters())[name]
        split = None if name == "gpt.wte.weight" else p.mp_split
        if split is not None:
            codes = mpu.gather_shards(list(D.all_gather(
                codes, group=g).unbind(0)), split[0], split[1])
            if split[0] == 0:
                scale = mpu.gather_shards(list(D.all_gather(
                    scale, group=g).unbind(0)), 0, split[1])
        q8[name] = {"codes": codes.tolist(), "scale": scale.view(-1).tolist()}
    w = dict(model.named_parameters())["gpt.h.0.attn.out.weight"].float()
    s = (w.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    local = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    q8["control_local_absmax_codes"] = mpu.gather_shards(list(D.all_gather(
        local, group=g).unbind(0)), 1, 1).tolist()
    os.environ.pop("PADDLE_TPU_Q8_DECODE_MIN")
    out["q8"] = q8
    # compile counters on a fresh model: one pass of traffic warms every
    # executable, a second pass of the same length profile builds none
    fresh = _serve_model(cfg, np_state)
    eng = _engine(fresh, n, prefix_cache=True, kv_blocks=48)
    if eng.is_leader:
        serve_pass(eng, serve_prompts(vocab, (8, 7, 3), 19))
        c1 = (eng.monitor.compiles, eng.monitor.recompiles)
        serve_pass(eng, serve_prompts(vocab, (8, 7, 3), 23))
        out["compile"] = {"warm": list(c1),
                          "after": [eng.monitor.compiles,
                                    eng.monitor.recompiles],
                          "statusz": eng.statusz()["compile"]["compiles"]}
        led = eng.attach_memory_ledger(pt.obs.MemoryLedger(device="cpu"))
        out["memz"] = {"owners": sorted(led._owners),
                       "kv_meta": led._owners["kv_pool"].meta,
                       "tables": led._owners["serving_tables"].bytes}
        eng.close()
    else:
        eng.follow()
    if n == 4:
        # two sharded engines at once on a dp2 x mp2 mesh: leaders 0 and 2
        mesh2 = D.build_mesh({"dp": 2, "mp": 2})
        D.set_mesh(mesh2)
        m2 = _serve_model(cfg, np_state, mesh2)
        eng = _engine(m2, 2)
        if eng.is_leader:
            out["dp2_chains"] = serve_pass(eng, serve_prompts(
                vocab, (8, 7, 3, 5), 3))
            eng.close()
        else:
            eng.follow()
    D.set_mesh(None)
    _save_json(run_dir, r, out)


def sharded_leader_fails(run_dir, where):
    """Two ranks; the leader's decode op raises `where` its collectives
    ("after": the follower finishes the op and reads the abort header;
    "before": the follower waits in an all-reduce the leader never joins,
    until the leader's process is gone). Each rank records what it saw
    and exits non-zero."""
    import sys
    torch.set_num_threads(1)
    D.init_parallel_env(init_method="file://" + os.path.join(run_dir,
                                                             "store"),
                        device="cpu", timeout_s=30)
    r = D.get_rank()
    inputs = dict(np.load(os.path.join(run_dir, "inputs.npz")))
    cfg = _gpt_cfg(inputs)
    D.set_mesh(D.build_mesh({"mp": 2}))
    eng = _engine(_serve_model(cfg, _np_state(inputs)), 2)
    seen = None
    try:
        if eng.is_leader:
            f = eng._runner.handlers["decode"]

            def broken(*a, extra=None):
                if where == "after":
                    f(*a, extra=extra)
                raise RuntimeError("injected leader failure")
            eng._runner.handlers["decode"] = broken
            serve_pass(eng, serve_prompts(cfg.vocab_size, (5,), 3))
        else:
            eng.follow()
    except Exception as exc:
        seen = [type(exc).__name__, str(exc)[:300]]
    with open(os.path.join(run_dir, f"rank{r}.json"), "w") as fh:
        json.dump({"rank": r, "seen": seen}, fh)
    sys.stdout.flush()
    os._exit(3 if seen else 0)


# ------------------------------- data-parallel training: grad_comm, ZeRO
def _digest(tensors):
    """A digest of tensors' bytes (every rank's must agree)."""
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_train(inp, mesh, steps=3, level=None, remat=None, sd_at=None,
             load=None, fleet_opt=False, start=0, wire=None, **step_kw):
    """The tiny GPT from the JAX weights (this rank's mp shards under an
    mp mesh) trained `steps` AdamW steps (lr 1e-3, wd 0.01, the clip) on
    the global batch: ZeRO at `level`, recompute under policy `remat`,
    TrainStep options `step_kw`. Returns (losses, the whole parameters,
    the digest of every rank's whole parameters after each step, the
    step, the state_dict() taken after step `sd_at`, 0: before the
    first). `load` is a
    state_dict set before the first step, which takes batch `start`;
    `fleet_opt` marks the optimizer through
    fleet.distributed_optimizer. `wire` ({tag: Group}) collects each
    group's bytes by operation and dtype over the steps alone (not the
    state_dict() reads between them), under "tag:op/dtype"."""
    kw = dict(use_recompute=True, recompute_policy=remat) if remat else {}
    cfg = _gpt_cfg(inp, **kw)
    D.set_mesh(mesh)
    model = pt.GPTForCausalLM(cfg, device="cpu")
    model.load_state_dict(pt.shard_state_from_paddle(_np_state(inp), cfg,
                                                     mesh))
    model.train()
    opt = pt.AdamW(1e-3, parameters=model.named_parameters(),
                   weight_decay=0.01,
                   grad_clip=pt.ClipGradByGlobalNorm(float(inp["clip"])),
                   device="cpu")
    if level is not None:
        model, opt, _ = D.group_sharded_parallel(model, opt, level=level)
    if fleet_opt:
        opt = pt.fleet.distributed_optimizer(opt)
    step = pt.TrainStep(model, opt, lambda a, b: model.loss(
        a, b, chunk_size=8), mesh=mesh, device="cpu", **step_kw)
    if load is not None:
        step.set_state_dict(load)
    ids = _t(inp["ids"])
    losses, digests = [], []
    sd = step.state_dict() if sd_at == 0 else None
    watch = {t: g for t, g in (wire or {}).items() if ":" not in t}
    for i in range(steps):
        before = {t: dict(g.wire_bytes) for t, g in watch.items()}
        losses.append(float(step(ids[start + i], ids[start + i])))
        for t, g in watch.items():
            for (op, dt), b in g.wire_bytes.items():
                k = f"{t}:{op}/{dt}"
                b -= before[t].get((op, dt), 0)
                if b:
                    wire[k] = wire.get(k, 0) + b
        full = pt.gather_state(step.state_dict()["params"], mesh)
        digests.append(_digest(full.values()))
        if sd_at == i + 1:
            sd = step.state_dict()
    full = pt.gather_state(step.state_dict()["params"], mesh)
    D.set_mesh(None)
    return losses, full, digests, step, sd


def _put(out, tag, res):
    losses, full, digests, _, _ = res
    out[f"{tag}:losses"] = np.array(losses)
    out[f"{tag}:digests"] = np.array(digests)
    for n, v in full.items():
        out[f"{tag}:param:{n}"] = v


def quant_collectives(run_dir):
    """int8_psum (deterministic and stochastic), sync_grad_groups, and
    TrainStep(grad_comm=None | "f32" | "int8") on a dp mesh of the world,
    with the wire bytes by dtype and the precondition errors."""
    from paddle_tpu_torch.distributed import quant_collectives as QC
    r, inp = _join(run_dir)
    n = D.get_world_size()
    world = D.build_mesh({"dp": n})
    g = world.group("dp")
    out = {}
    out["int8_psum"] = QC.int8_psum(_t(inp["x"][r]), g, chunk=16)
    out["int8_psum_sum"] = QC.int8_psum(_t(inp["x"][r]), g, chunk=16,
                                        mean=False)
    draws = []
    for s in range(int(inp["draws"])):
        gen = torch.Generator().manual_seed(QC.group_seed(s, 0))
        draws.append(QC.int8_psum(_t(inp["x"][r]), g, chunk=16,
                                  stochastic=True, generator=gen))
    out["stochastic"] = torch.stack(draws)
    grads = [_t(inp["g0"][r]), _t(inp["g1"][r]), _t(inp["g2"][r])]
    plan = [("a", (0,), (1,)), ("b", (2,), ())]
    for k, v in enumerate(QC.sync_grad_groups(grads, plan, g, chunk=16)):
        out[f"sync{k}"] = v
    # the training step, every mode; wire bytes of the gradient sync
    D.set_mesh(world)
    for mode in (None, "f32", "int8"):
        tag = str(mode)
        watch = {"dp": g}
        if mode == "int8":
            watch["scale"] = world.twin("dp")
        res = dp_train(inp, world, grad_comm=mode, wire=watch)
        _put(out, tag, res)
        out[f"{tag}:wire"] = np.array(json.dumps(
            {k: v for k, v in watch.items() if ":" in k}))
        step = res[3]
        if mode is not None:
            shapes = [tuple(p.shape) for p in step._params]
            out[f"{tag}:stats"] = np.array(json.dumps(
                QC.comm_group_stats(step._comm_groups, shapes)))
            out[f"{tag}:groups"] = np.array(len(step._comm_groups))
    res = dp_train(inp, world, grad_comm="int8", grad_comm_stochastic=True)
    _put(out, "int8_sr", res)
    # the ranks compare their exchange units when a step is built: the
    # same units pass; rank 1's in another order fail on every rank
    from paddle_tpu_torch.jit.train_step import _Landing
    ps = [torch.zeros(4), torch.zeros(2, 3)]
    out["agree"] = np.array(json.dumps({
        "same": _raises(lambda: _Landing([[1], [0]], None, None).agree(
            g, ps, "cpu")),
        "differs": _raises(lambda: _Landing(
            [[0], [1]] if r == 1 else [[1], [0]], None, None).agree(
                g, ps, "cpu"))}))
    # the JAX step's preconditions
    cfg = _gpt_cfg(inp)
    m = pt.GPTForCausalLM(cfg, device="cpu")
    o = pt.AdamW(1e-3, parameters=m.named_parameters(), device="cpu")
    loss = (lambda a, b: m.loss(a, b))
    errs = {"no_mesh": _raises(lambda: pt.TrainStep(
                m, o, loss, grad_comm="int8", device="cpu")),
            "mode": _raises(lambda: pt.TrainStep(
                m, o, loss, mesh=world, grad_comm="int4", device="cpu")),
            "accum": _raises(lambda: pt.TrainStep(
                m, o, loss, mesh=world, grad_comm="int8",
                grad_accum_steps=2, device="cpu"))}
    zero2 = D.shard_optimizer_state(pt.AdamW(
        1e-3, parameters=m.named_parameters(), device="cpu"), 2, "dp")
    errs["zero"] = _raises(lambda: pt.TrainStep(
        m, zero2, loss, mesh=world, grad_comm="int8", device="cpu"))
    if n == 4:
        hybrid = D.build_mesh({"dp": 2, "sdp": 2})
        errs["pure"] = _raises(lambda: pt.TrainStep(
            m, o, loss, mesh=hybrid, grad_comm="int8", device="cpu"))
        errs["data_axes"] = _raises(lambda: pt.TrainStep(
            m, o, loss, mesh=hybrid, data_axes=("dp", "sdp"),
            device="cpu"))
    D.set_mesh(None)
    out["errors"] = np.array(json.dumps(errs))
    _save(run_dir, r, out)


def zero_levels(run_dir):
    """ZeRO on 4 ranks: plain dp4 and dp4 at os / os_g / p_g_os (and
    p_g_os with recompute save_qkv), {"sdp": 2, "mp": 2} at ZeRO-1
    through fleet.init(strategy.sharding), {"dp": 2, "sdp": 2} at
    p_g_os; the state_dict round trips between dp4 os_g and one process;
    the memory ledger's owners and the wire bytes of each level."""
    r, inp = _join(run_dir)
    world = D.build_mesh({"dp": WORLD})
    g = world.group("dp")
    out = {}
    for tag, level, remat in (("plain", None, None), ("os", "os", None),
                              ("os_g", "os_g", None),
                              ("p_g_os", "p_g_os", None),
                              ("p_g_os_remat", "p_g_os", "save_qkv")):
        watch = {"dp": g, "gather": world.twin("dp")}
        memz = pt.obs.MemoryLedger(device="cpu")
        res = dp_train(inp, world, level=level, remat=remat, memz=memz,
                       sd_at=2 if tag == "os_g" else None, wire=watch)
        _put(out, tag, res)
        step = res[3]
        out[f"{tag}:wire"] = np.array(json.dumps(
            {k: v for k, v in watch.items() if ":" in k}))
        rows = {row["owner"]: row["bytes"]
                for row in memz.census(reconcile=False)["owners"]}
        out[f"{tag}:memz"] = np.array(json.dumps(rows))
        z = step.zero
        if tag == "p_g_os":
            # the live parameters are this rank's share; gather_state
            # makes them whole from their owners
            gs = pt.gather_state(dict(zip(step._param_names, step._params)),
                                 world, zero=z)
            sd = step.state_dict()["params"]
            out["p_g_os:freed"] = np.array(sum(
                q.untyped_storage().nbytes() == 0 for q in step._params))
            out["p_g_os:gather_state_bitwise"] = np.array(all(
                torch.equal(gs[k], sd[k]) for k in sd))
        out[f"{tag}:owned"] = np.array([] if z is None else z.owned)
        out[f"{tag}:stage"] = np.array(0 if z is None else z.stage)
        if tag == "os_g":
            sd = res[4]
            # a one-process step from the dp4 os_g state after step 2
            one = dp_train(inp, None, steps=1, load=sd, start=2)
            out["os_g_to_one:loss"] = np.array(one[0])
            for k, v in one[1].items():
                out[f"os_g_to_one:param:{k}"] = v
    # the one-process state after 2 steps into a dp4 os_g step and back
    one = dp_train(inp, None, steps=2, sd_at=2)
    sd1 = one[4]
    back = dp_train(inp, world, steps=0, level="os_g", load=sd1)[3]
    back_sd = back.state_dict()
    out["one_to_os_g:bitwise"] = np.array(
        all(torch.equal(back_sd["params"][k], sd1["params"][k])
            for k in sd1["params"]) and
        all(torch.equal(back_sd["opt"][k][e], sd1["opt"][k][e])
            for k in sd1["opt"] for e in sd1["opt"][k]))
    # ... into every level: read back whole, then its step 3
    for level in ("os_g", "p_g_os"):
        res = dp_train(inp, world, steps=1, level=level, load=sd1, start=2,
                       sd_at=0)
        sd = res[4]
        out[f"one_to_{level}:read_back_bitwise"] = np.array(
            all(torch.equal(sd["params"][k], sd1["params"][k])
                for k in sd1["params"]) and
            all(torch.equal(sd["opt"][k][e], sd1["opt"][k][e])
                for k in sd1["opt"] for e in sd1["opt"][k]))
        _put(out, f"one_to_{level}", res)
    # ZeRO-1 over sdp beside mp, the shape of train_gpt_sharded.py minus
    # its dp: every rank sees the whole batch
    strategy = pt.fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 1}
    strategy.hybrid_configs = {"sharding_degree": 2, "mp_degree": 2}
    pt.fleet.init(strategy=strategy, device="cpu")
    mesh = D.get_mesh()
    out["sdp_mp:axes"] = np.array(json.dumps(mesh.shape))
    hcg = pt.fleet.get_hybrid_communicate_group()
    out["sdp_mp:hcg"] = np.array([hcg.get_sharding_parallel_world_size(),
                                  hcg.get_sharding_parallel_rank(),
                                  hcg.get_model_parallel_world_size()])
    res = dp_train(inp, mesh, fleet_opt=True)
    _put(out, "sdp_mp", res)
    out["sdp_mp:stage"] = np.array(res[3].zero.stage)
    # {"dp": 2, "sdp": 2} at p_g_os: the batch split over dp
    mesh = D.build_mesh({"dp": 2, "sdp": 2})
    D.set_mesh(mesh)
    res = dp_train(inp, mesh, level="p_g_os")
    _put(out, "dp_sdp", res)
    out["dp_sdp:axis"] = np.array(res[3].optimizer._sharding_axis)
    D.set_mesh(None)
    _save(run_dir, r, out)


def dgc_exchange(run_dir):
    """sparse_allreduce of every rank's tensor (with a residual), the
    dense all-reduce of the same top-k entries (the control), and 3 DGC
    steps of a linear model with the error feedback carried."""
    r, inp = _join(run_dir)
    g = D.get_group()
    x, res = _t(inp["x"][r]), _t(inp["res"][r])
    s, kept = D.sparse_allreduce(x, g, float(inp["sparsity"]), residual=res)
    flat = (x + res).reshape(-1)
    k = max(1, int(flat.numel() * (1 - float(inp["sparsity"]))))
    idx = torch.topk(flat.abs(), k).indices
    dense = torch.zeros_like(flat)
    dense[idx] = flat[idx]
    D.all_reduce(dense, group=g)
    out = {"sparse": s, "kept": kept, "dense_control": dense.view(x.shape)}
    w = [torch.zeros(4, 1)]
    resid = None

    def loss_fn(params, batch):
        xb, yb = batch
        return ((xb @ params[0] - yb) ** 2).mean()

    losses = []
    for i in range(3):
        loss, grads, resid = D.dgc_value_and_grad(
            loss_fn, [t.requires_grad_(True) for t in w],
            (_t(inp["bx"]), _t(inp["by"])), group=g,
            sparsity=float(inp["dgc_sparsity"]), residuals=resid)
        losses.append(float(loss))
        w = [(p - 0.1 * gr).detach() for p, gr in zip(w, grads)]
        out[f"dgc{i}:grad"] = grads[0]
        out[f"dgc{i}:residual"] = resid[0]
    out["dgc:losses"] = np.array(losses)
    _save(run_dir, r, out)


# ------------------------------------- sequence and expert parallelism
def _sp_slice(a, mesh):
    """This sp rank's positions of [B, S, ...] rows."""
    n, r = mesh.axis_size("sp"), mesh.axis_rank("sp")
    w = a.shape[1] // n
    return a[:, r * w:(r + 1) * w]


def _attend_leg(qkv, do, mesh, schedule, causal, out, tag):
    """One sp attention call on this rank's shards: its output and the
    gradients of sum(out * do) of q, k and v."""
    leaves = [_sp_slice(_t(a), mesh).requires_grad_() for a in qkv]
    o = D.sequence_parallel_attention(*leaves, is_causal=causal,
                                      schedule=schedule)
    (o * _sp_slice(_t(do), mesh)).sum().backward()
    out[tag + ":out"] = o.detach()
    for name, t in zip("qkv", leaves):
        out[f"{tag}:d{name}"] = t.grad


def ring_attention(run_dir):
    """Ring and Ulysses attention on an {"sp": world} mesh, causal and
    not: this rank's output and gradients; the Ulysses call at a head
    count that does not divide by sp (it takes the ring); the dense
    fallback on a mesh without sp; the payload each schedule put on the
    sp group; and a ring whose last forward rotation is dropped (the
    control)."""
    import paddle_tpu_torch.distributed.collective as C
    r, inp = _join(run_dir)
    n = D.get_world_size()
    mesh = D.build_mesh({"sp": n})
    D.set_mesh(mesh)
    qkv, do = [inp[k] for k in "qkv"], inp["do"]
    out = {}
    g = mesh.group("sp")
    for schedule in ("ring", "ulysses"):
        for causal in (False, True):
            g.wire_bytes.clear()
            _attend_leg(qkv, do, mesh, schedule, causal, out,
                        f"{schedule}:{int(causal)}")
            out[f"{schedule}:{int(causal)}:wire"] = np.array(
                sorted(f"{k[0]}/{k[1]}" for k in g.wire_bytes), dtype=str)
    g.wire_bytes.clear()
    _attend_leg([inp[k + "3"] for k in "qkv"], inp["do3"], mesh, "ulysses",
                True, out, "ulysses_h3")
    out["ulysses_h3:wire"] = np.array(
        sorted(f"{k[0]}/{k[1]}" for k in g.wire_bytes), dtype=str)
    # the control: the forward's last rotation leaves K/V where they are
    real, calls = C.rotate, [0]

    def dropped(tensors, group, shift=1):
        if len(tensors) == 2:
            calls[0] += 1
            if calls[0] == group.nranks - 1:
                return list(tensors)
        return real(tensors, group, shift)
    C.rotate = dropped
    try:
        with torch.no_grad():
            out["control:out"] = D.ring_attention(
                *[_sp_slice(_t(a), mesh) for a in qkv])
    finally:
        C.rotate = real
    D.set_mesh(D.build_mesh({"dp": n}))
    with torch.no_grad():
        out["dense:out"] = D.ring_attention(*[_t(a) for a in qkv],
                                            is_causal=True)
    D.set_mesh(None)
    _save(run_dir, r, out)


def _sp_leg(inp, axes, schedule, out, tag):
    """The tiny GPT on mesh `axes` for 3 AdamW steps from the JAX weights
    (the clip active, a loss mask uneven across the sp halves): losses,
    gathered final parameters and this rank's replicated parameters."""
    mesh = D.build_mesh(axes)
    D.set_mesh(mesh)
    cfg = _gpt_cfg(inp, sequence_parallel=schedule)
    model = pt.GPTForCausalLM(cfg, device="cpu")
    model.load_state_dict(pt.shard_state_from_paddle(_np_state(inp), cfg))
    step = _adamw_step(model, float(inp["clip"]), mesh)
    ids, mask = _t(inp["ids"]), _t(inp["mask"])
    out[tag + ":losses"] = np.array([float(step(ids, ids, mask))
                                     for _ in range(3)])
    final = pt.gather_state({n: p.detach()
                             for n, p in model.named_parameters()})
    for n, v in final.items():
        out[f"{tag}:param:{n}"] = v
    for n, p in model.named_parameters():
        if getattr(p, "mp_split", None) is None:
            out[f"{tag}:local:{n}"] = p.detach()
    out[tag + ":coords"] = np.array([mesh.axis_rank(a) for a in axes])
    D.set_mesh(None)


def gpt_sp(run_dir):
    """The tiny GPT trained on the sp meshes of this world size (2:
    {"sp": 2} ring and Ulysses; 4: {"dp": 2, "sp": 2} and {"sp": 2,
    "mp": 2}, ring)."""
    r, inp = _join(run_dir)
    out = {}
    if D.get_world_size() == 2:
        _sp_leg(inp, {"sp": 2}, "ring", out, "sp2_ring")
        _sp_leg(inp, {"sp": 2}, "ulysses", out, "sp2_ulysses")
    else:
        _sp_leg(inp, {"dp": 2, "sp": 2}, "ring", out, "dp2_sp2")
        _sp_leg(inp, {"sp": 2, "mp": 2}, "ring", out, "sp2_mp2")
    _save(run_dir, r, out)


def _moe_layer(inp, mesh=None):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    d, h, e = (int(inp[k]) for k in ("moe_d", "moe_h", "moe_e"))
    layer = MoELayer(d, h, e, gate="gshard",
                     capacity_factor=float(inp["moe_cf"]), device="cpu")
    ep = 1 if mesh is None else mesh.axis_size("ep")
    er = 0 if mesh is None else mesh.axis_rank("ep")
    with torch.no_grad():
        for n, p in layer.named_parameters():
            full = _t(inp["moe:" + n])
            p.copy_(mpu.shard_of(full, 0, 1, er, ep)
                    if getattr(p, "ep_split", None) else full)
    return layer


def _moe_leg(inp, mesh, routed, out, tag):
    """The MoE layer on this rank's rows of x (all rows on a mesh without
    dp); with `routed` the dp group routes them as one batch. The rank's
    loss is n sum(y dy) + aux over its rows (n the dp size), so the dp
    average of its gradients is the gradient of the global
    sum(y dy) + aux."""
    from paddle_tpu_torch.distributed.mesh import data_parallel_loss
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    layer = _moe_layer(inp, mesh)
    dp = mesh.group("dp") if "dp" in mesh.shape else None
    n, rk = (1, 0) if dp is None else (dp.nranks, dp.rank)
    b = inp["moe_x"].shape[0] // n
    x = _t(inp["moe_x"])[rk * b:(rk + 1) * b].requires_grad_()
    dy = _t(inp["moe_dy"])[rk * b:(rk + 1) * b]
    moe_layer.record_drop_rate(True)
    with data_parallel_loss(dp if routed else None):
        y = layer(x)
    out[tag + ":drop"] = np.array(moe_layer.measured_drop_rate())
    moe_layer.record_drop_rate(False)
    loss = n * (y * dy).sum() + layer.aux_loss
    loss.backward()
    out[tag + ":y"] = y.detach()
    out[tag + ":aux"] = layer.aux_loss.detach()
    out[tag + ":dx"] = x.grad / n
    for name, p in layer.named_parameters():
        gr = p.grad.clone()
        if dp is not None:
            D.all_reduce(gr, op="avg", group=dp)
        if getattr(p, "ep_split", None) and mesh.axis_size("ep") > 1:
            gr = D.all_gather(gr, group=mesh.group("ep")).flatten(0, 1)
        out[f"{tag}:grad:{name}"] = gr


def moe_ep(run_dir):
    """World 2: the MoE layer at dp2 routed as one batch (the repair; also
    on the one-hot route) and routed per rank (the control), and at ep2.
    World 4: the layer at dp2 x ep2; the tiny MoE GPT's TrainStep at dp2
    x ep2 (losses, gathered parameters, this rank's replicated
    parameters); the converter's ep round trip."""
    r, inp = _join(run_dir)
    out = {}
    if D.get_world_size() == 2:
        dp2 = D.build_mesh({"dp": 2})
        _moe_leg(inp, dp2, True, out, "dp2")
        _moe_leg(inp, dp2, False, out, "dp2_per_rank")
        # the one-hot route (PADDLE_TPU_MOE_GATHER other than "1")
        os.environ["PADDLE_TPU_MOE_GATHER"] = "0"
        try:
            _moe_leg(inp, dp2, True, out, "dp2_onehot")
        finally:
            del os.environ["PADDLE_TPU_MOE_GATHER"]
        ep2 = D.build_mesh({"ep": 2})
        D.set_mesh(ep2)
        _moe_leg(inp, ep2, True, out, "ep2")
        D.set_mesh(None)
        _save(run_dir, r, out)
        return
    mesh = D.build_mesh({"dp": 2, "ep": 2})
    D.set_mesh(mesh)
    _moe_leg(inp, mesh, True, out, "dp2_ep2")
    cfg = _gpt_cfg(inp, moe_num_experts=4, moe_every_n_layers=2)
    np_state = _np_state(inp)
    full = pt.state_dict_from_paddle(np_state, cfg)
    shards = pt.shard_state_from_paddle(np_state, cfg)
    back = pt.gather_state(shards)
    out["roundtrip_bitwise"] = np.array(all(
        torch.equal(back[k], full[k]) for k in full))
    out["expert_shard_rows"] = np.array(shards["gpt.h.1.mlp.w1"].shape[0])
    model = pt.GPTForCausalLM(cfg, device="cpu")
    out["splits_match"] = np.array(all(
        getattr(p, "ep_split", None) == pt.convert.ep_split(n)
        for n, p in model.named_parameters()))
    model.load_state_dict(shards)
    step = _adamw_step(model, float(inp["clip"]), mesh)
    ids, mask = _t(inp["ids"]), _t(inp["mask"])
    out["gpt:losses"] = np.array([float(step(ids, ids, mask))
                                  for _ in range(3)])
    final = pt.gather_state({n: p.detach()
                             for n, p in model.named_parameters()})
    for n, v in final.items():
        out["gpt:param:" + n] = v
    for n, p in model.named_parameters():
        if getattr(p, "ep_split", None) is None:
            out["gpt:local:" + n] = p.detach()
    out["coords"] = np.array([mesh.axis_rank("dp"), mesh.axis_rank("ep")])
    D.set_mesh(None)
    _save(run_dir, r, out)
