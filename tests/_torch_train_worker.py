"""The per-rank side of ``tests/test_torch_parallel_training.py``: what each
process of a ``repro_torch.launch.mesh.spawn`` world runs.  It imports
torch and the port only (a spawned process starts from nothing).

:func:`train_suite` runs every case in one world of four CPU processes
over gloo, as ``_torch_tp_worker.tp_suite`` does for serving: each case
builds its mesh (every rank takes part in making the groups; ranks
outside a smaller mesh skip the case), and a case that raises returns
its traceback instead of its result.  What is compared with world 1
travels back as numpy; world 1 itself (``pctx=None``) runs in the test
process, but for the cases that must be bit for bit, which run it beside
the mesh on rank 0.
"""
import dataclasses
import os
import traceback

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.checkpoint import CheckpointManager, reshard_restore
from repro_torch.configs import get
from repro_torch.data import DataConfig, token_stream
from repro_torch.launch.mesh import make_ctx, make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (adamw_init, compress_state_init,
                               compressed_psum)
from repro_torch.parallel import NamedSharding, comm, param_sharding
from repro_torch.parallel.rules import bind
from repro_torch.runtime import ElasticController, FailureInjector
from repro_torch.training import TrainConfig, Trainer, make_train_step
from repro_torch.training.trainer import (_loss_and_grads, _MeshStep,
                                          make_compressed_dp_step,
                                          opt_sharding)

# the reference training tests' dense model (tests/test_training.py:15)
CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=96, vocab=64)
# the reference's compressed-step test model (tests/test_training.py:97)
CFG_C = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                    n_heads=2, n_kv_heads=1, d_ff=64, vocab=64)
STEPS = 3
SEQ, BATCH = 32, 8
TP_ARCHS = ("gemma_7b", "chameleon_34b")
TP_MESHES = ((1, 2), (1, 4), (2, 2))
DP_MESHES = ((2, 1), (4, 1))
CKPT_MESHES = ((1, 2), (2, 1), (2, 2))
MOE_CF = 8.0            # C = 2·Tc ≥ Tc for 8 experts top-2: nothing dropped


def tcfg(**kw):
    base = dict(n_microbatches=2, remat=True, total_steps=10, warmup=1)
    base.update(kw)
    return TrainConfig(**base)


def dcfg(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=1)


def model_cfg(name, impl=None):
    """CFG, or a smoke config; the MoE one at :data:`MOE_CF` under a2a."""
    if name == "dense":
        return CFG
    cfg = get(name, smoke=True)
    if impl == "a2a":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CF))
    return cfg


def stream(cfg, pctx, start=0):
    """The rank's rows of the token stream (with the encoder-decoder
    family's frames)."""
    h, n = (0, 1) if pctx is None else (pctx.dp_rank, pctx.dp_world)
    fr = (cfg.encdec.n_frames, cfg.d_model) if cfg.encdec else None
    return token_stream(dcfg(cfg), 0, start_step=start, host_id=h,
                        n_hosts=n, device="cpu", frames=fr)


def npy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def whole(tree, shardings):
    """Every leaf gathered whole (every rank calls it), numpy, leaf order."""
    return [npy(sh.gather(t)) for t, sh in zip(tree_leaves(tree),
                                               tree_leaves(shardings))]


def param_shardings(like, pctx):
    """``NamedSharding`` per leaf of a global parameter tree."""
    return tree_map(lambda t, p: NamedSharding(pctx, p), like,
                    param_sharding(like, pctx))


def trainer(cfg, pctx, **kw):
    return Trainer(cfg, tcfg(**kw), stream(cfg, pctx), pctx=pctx,
                   device="cpu")


def first_grads(tr, f32=False):
    """Step 1's gradients of a fresh Trainer, reduced as its step reduces
    them, whole (numpy, leaf order), and the step's loss; with ``f32`` on
    f32 compute parameters (no bf16 rounding)."""
    batch = next(stream(tr.cfg, tr.pctx))
    lfn = lambda p, b: lm.loss_fn(tr.cfg, p, b, pctx=tr.pctx,  # noqa: E731
                                  remat=True)[0]
    dts = tree_map(lambda d: torch.float32 if f32 else d, tr._dtypes)
    if tr.oshard is None:
        params = tree_map(lambda m, d: m.to(d, copy=True).requires_grad_(),
                          tr.opt_state["master"], dts)
        loss, g = _loss_and_grads(lfn, params, batch, 2)
        return float(loss), [npy(x) for x in g]
    plan = _MeshStep(tr.pctx, tr.oshard["master"])
    params = tree_map(plan.compute, tr.opt_state["master"], dts,
                      tr.oshard["master"])
    loss, g = _loss_and_grads(lfn, params, batch, 2)
    g = plan.reduce(g)
    return float(loss), [npy(sh.gather(x))
                         for x, sh in zip(g, tree_leaves(tr.oshard["master"]))]


def train_record(tr, steps=STEPS):
    """Losses, grad norms and the whole masters after ``steps`` steps."""
    log = tr.run(steps)
    masters = (whole(tr.opt_state["master"], tr.oshard["master"])
               if tr.oshard is not None
               else [npy(t) for t in tree_leaves(tr.opt_state["master"])])
    return dict(loss=[m["loss"] for m in log],
                grad_norm=[m["grad_norm"] for m in log], master=masters)


def world1(name, steps=STEPS, grads=False, impl=None):
    """World 1 (``pctx=None``) of a case: its record (and step 1's
    gradients)."""
    cfg = model_cfg(name, impl)
    out = train_record(trainer(cfg, None), steps)
    if grads:
        tr = trainer(cfg, None)
        out["loss1"], out["grads"] = first_grads(tr)
        out["grads32"] = first_grads(tr, f32=True)[1]
    return out


def opt_elements(tr):
    return sum(t.numel() for k in ("master", "m", "v")
               for t in tree_leaves(tr.opt_state[k]))


def predicted_elements(tr):
    """What :func:`opt_sharding` predicts for this rank: each global leaf
    divided by the ranks of each axis its spec names."""
    params0 = lm.init_params(tr.cfg, torch.Generator().manual_seed(0),
                             "cpu")
    n = 0
    for p, sh in zip(tree_leaves(params0), tree_leaves(tr.oshard["master"])):
        k = p.numel()
        for _ in sh.dims("model"):
            k //= tr.pctx.world
        for _ in sh.dims("data"):
            k //= tr.pctx.dp_world
        n += k
    return 3 * n


# --------------------------------------------------------------- the cases

def mesh_layout(pctx):
    return dict(dp_rank=pctx.dp_rank, rank=pctx.rank,
                dp_world=pctx.dp_world, world=pctx.world,
                global_rank=int(os.environ["RANK"]))


def identity(pctx):
    """(1,1) against pctx=None, 3 steps, on this rank: bit for bit."""
    a = train_record(trainer(CFG, None))
    b = train_record(trainer(CFG, pctx))
    return dict(loss=a["loss"] == b["loss"],
                grad_norm=a["grad_norm"] == b["grad_norm"],
                master=all(np.array_equal(x, y)
                           for x, y in zip(a["master"], b["master"])))


def data_parallel(pctx, name="dense", impl=None):
    cfg = model_cfg(name, impl)
    tr = trainer(cfg, pctx)
    out = dict(elements=opt_elements(tr), predicted=predicted_elements(tr))
    out["loss1"], out["grads"] = first_grads(tr)
    out.update(train_record(tr))
    return out


def tensor_parallel(pctx, name):
    cfg = model_cfg(name)
    out = train_record(trainer(cfg, pctx))
    out["loss1"], out["grads32"] = first_grads(trainer(cfg, pctx), f32=True)
    return out


def no_block_entry(pctx):
    """Step 1's gradients at (1,2) with the block entry's backward made the
    identity (so each rank keeps its partial cotangent)."""
    saved = comm._Enter.backward
    comm._Enter.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        return dict(zip(("loss1", "grads"), first_grads(
            trainer(model_cfg("gemma_7b"), pctx), f32=True)))
    finally:
        comm._Enter.backward = saved


def reference_ckpt(pctx, ckpt_dir, ref_opt):
    """The reference's checkpoint of ``ref_opt`` (numpy by checkpoint key)
    restored through ``reshard_restore`` onto this mesh
    with ZeRO-1: every slice bit for bit the slice of the reference's
    array, and the slices gathered bit for bit the whole."""
    cfg = get("gemma_7b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = adamw_init(params)
    bp = bind(pctx, cfg)
    sh = opt_sharding(like, param_sharding(params, bp), bp, True)
    out = reshard_restore(CheckpointManager(ckpt_dir), 5, {"opt": like},
                          {"opt": sh})["opt"]
    local = gathered = True
    for (path, t), s in zip(tree_leaves_with_path({"opt": out}),
                            tree_leaves({"opt": sh})):
        ref = torch.from_numpy(ref_opt["/".join(map(str, path))]).to(t.dtype)
        local &= torch.equal(t, s.local(ref))
        gathered &= torch.equal(s.gather(t), ref)
    return dict(local=local, gathered=gathered,
                split=sum(bool(s.dims("model") or s.dims("data"))
                          for s in tree_leaves(sh)))


def port_ckpt(pctx, ckpt_dir):
    """A (2,2) ZeRO-1 Trainer's checkpoints at steps 0 and 1 (written whole
    by rank 0), and the whole state at step 1."""
    tr = trainer(get("gemma_7b", smoke=True), pctx, checkpoint_dir=ckpt_dir)
    tr.ckpt.save(0, {"opt": tr.opt_state}, shardings=tr._shardings())
    tr.run(1)
    tr.ckpt.save(1, {"opt": tr.opt_state}, shardings=tr._shardings())
    return dict(state=whole(tr.opt_state, tr.oshard))


def elastic(pctx21, pctx12, ckpt_dir):
    """Train at (2,1) with ZeRO-1; at step 4 save the parameters and the
    optimizer state; crash at step 6; ``ElasticController.rescale`` step 4
    onto (1,2); run to step 8 there."""
    tr = trainer(CFG, pctx21)
    mgr = CheckpointManager(ckpt_dir)
    tr.failure_hook = FailureInjector({6})
    tr.run(4)
    like = lm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    saved = {"params": tr.params, "opt": tr.opt_state}
    shard = {"params": param_shardings(like, tr.pctx), "opt": tr.oshard}
    mgr.save(4, saved, shardings=shard)
    saved = [sh.gather(t).clone() for t, sh in zip(tree_leaves(saved),
                                                   tree_leaves(shard))]
    crashed = False
    try:
        tr.run(4)
    except FailureInjector.Crash:
        crashed = tr.step == 6
    new = bind(pctx12, CFG)
    params, opt = ElasticController.rescale(
        mgr, 4, like, adamw_init(like), new,
        lambda o, p, c: opt_sharding(o, p, c, True))
    tr2 = Trainer(CFG, tcfg(), stream(CFG, new, start=4), pctx=new,
                  device="cpu")
    tsh = {"params": param_shardings(like, new), "opt": tr2.oshard}
    exact = all(torch.equal(t, sh.local(w)) for t, sh, w in zip(
        tree_leaves({"params": params, "opt": opt}), tree_leaves(tsh),
        saved))
    tr2.opt_state, tr2.step = opt, 4
    rec = train_record(tr2, 4)
    return dict(crashed=crashed, exact=exact, steps=[m["step"] for m in
                                                     tr2.metrics_log], **rec)


def psum_case(pctx, grads, errs):
    """``compressed_psum`` of this rank's f32 gradients and error buffers
    (numpy trees indexed by data rank)."""
    r = pctx.dp_rank
    g = {k: torch.from_numpy(np.array(v[r])) for k, v in grads.items()}
    e = {k: torch.from_numpy(np.array(v[r])) for k, v in errs.items()}
    deq, err = compressed_psum(g, pctx, e)
    return dict(deq={k: v.numpy() for k, v in deq.items()},
                err={k: v.numpy() for k, v in err.items()})


def compressed(pctx, batches):
    """``make_compressed_dp_step`` at this mesh for len(batches) steps on
    the rank's rows, and (rank 0) the uncompressed step at world 1 on the
    whole batches."""
    tc = TrainConfig(n_microbatches=1, remat=False, total_steps=100,
                     warmup=1)
    params = lm.init_params(CFG_C, torch.Generator().manual_seed(0), "cpu")
    opt_c, err = adamw_init(params), compress_state_init(params)
    step = make_compressed_dp_step(CFG_C, tc, pctx)
    b = BATCH // pctx.dp_world
    p, losses = params, []
    for toks in batches:
        mine = torch.from_numpy(toks[pctx.dp_rank * b:(pctx.dp_rank + 1) * b])
        p, opt_c, err, m = step(p, opt_c, err, {"tokens": mine})
        losses.append(float(m["loss"]))
    out = dict(loss=losses, master=[npy(t) for t in
                                    tree_leaves(opt_c["master"])])
    if pctx.dp_rank == 0:
        opt_u = adamw_init(params)
        unc = make_train_step(CFG_C, tc, param_dtypes=tree_map(
            lambda t: t.dtype, params))
        for toks in batches:
            opt_u, _ = unc(opt_u, {"tokens": torch.from_numpy(toks)})
        out["uncompressed"] = [npy(t) for t in tree_leaves(opt_u["master"])]
    return out


def _run(fn, *args):
    try:
        return fn(*args)
    except Exception:                        # noqa: BLE001 — reported back
        return {"error": traceback.format_exc()}


def _ctx(data, model, **kw):
    return make_ctx(make_mesh(data, model, device="cpu"), **kw)


def train_suite(ckpt_dirs, ref_opt, psum_in, batches_c):
    """Every case (see the module docstring): {case: result} per rank.
    ``ckpt_dirs``: {'reference': the reference's checkpoint (step 5),
    'port': where (2,2) writes, 'elastic': where (2,1) writes};
    ``ref_opt``: that checkpoint's arrays by key; ``psum_in``: (grads,
    errs) for ``compressed_psum`` at world 4; ``batches_c``: the
    compressed step's global batches.  Each mesh is made once."""
    mesh = {dm: _ctx(*dm) for dm in ((2, 2), (1, 1), (2, 1), (4, 1),
                                     (1, 2), (1, 4))}
    mine = {dm: p for dm, p in mesh.items() if p.rank >= 0}
    res = {"layout": mesh_layout(mesh[2, 2])}
    if (1, 1) in mine:
        res["identity"] = _run(identity, mine[1, 1])
    for dm in DP_MESHES:
        if dm in mine:
            res["dp-dense-%d%d" % dm] = _run(data_parallel, mine[dm])
    for dm in TP_MESHES:
        if dm in mine:
            for name in TP_ARCHS:
                res[f"tp-{name}-%d%d" % dm] = _run(tensor_parallel, mine[dm],
                                                   name)
    if (1, 2) in mine:
        res["no-entry"] = _run(no_block_entry, mine[1, 2])
    if (2, 1) in mine:
        for impl in ("dense", "a2a"):
            res[f"moe-{impl}"] = _run(
                data_parallel, dataclasses.replace(mine[2, 1],
                                                   moe_impl=impl),
                "deepseek_v2_lite_16b", impl)
    if (1, 1) in mine:
        res["moe-a2a-world1"] = _run(
            data_parallel, dataclasses.replace(mine[1, 1], moe_impl="a2a"),
            "deepseek_v2_lite_16b", "a2a")
    for dm in CKPT_MESHES:
        if dm in mine:
            res["ckpt-ref-%d%d" % dm] = _run(reference_ckpt, mine[dm],
                                             ckpt_dirs["reference"], ref_opt)
    res["ckpt-port"] = _run(port_ckpt, mesh[2, 2], ckpt_dirs["port"])
    if (2, 1) in mine:
        res["elastic"] = _run(elastic, mine[2, 1], mine[1, 2],
                              ckpt_dirs["elastic"])
    res["psum"] = _run(psum_case, mesh[4, 1], *psum_in)
    res["compressed"] = _run(compressed, mesh[4, 1], batches_c)
    return res
