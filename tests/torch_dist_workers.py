"""The ranks of the port's multi-process CPU tests (test_torch_collective,
test_torch_mpu, test_torch_gpt_tp).

This module imports torch, numpy and the port only: the spawned ranks
never import JAX or the tests' conftest. Each rank runs on one CPU
thread, joins a gloo group through a FileStore under the test's tmp_path
(so parallel test workers never share a TCP port), reads its inputs from
``inputs.npz`` in the run directory and writes ``rank{r}.npz`` there.
"""
from __future__ import annotations

import json
import os

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
    D.spawn(func, args=(str(run_dir),), nprocs=nprocs, timeout=300)


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
