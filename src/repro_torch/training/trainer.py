"""Training substrate — the microbatched train step, ZeRO-1 sharding, the
int8-compressed data-parallel step and the Trainer loop
(``repro.training.trainer``).

``make_train_step`` builds the step (opt_state, batch) → (opt_state,
metrics):

* compute parameters are cast from the f32 masters at step start (bf16 by
  default), so the optimizer state is the only state;
* gradients of ``n_microbatches`` equal slices of the batch are
  accumulated in f32 and divided by n (the loss too);
* per-layer remat (``models/stack.py``) with ``remat``;
* the cosine LR of the step, then AdamW (``optim/adamw.py``), in place.

Under a ``pctx`` with a (data, model) mesh each rank holds its model
slices of the parameters (``parallel/rules.py:shard_params``) and, with
``zero1``, its data slice of every optimizer leaf that
:func:`opt_sharding` splits (ZeRO-1; the reference's rule).  The step
then, in order: casts its master slices and all-gathers them over the
data axis (cast first: the same bits, half the bytes); runs forward and
backward on the rank's rows through the differentiable collectives
(``parallel/comm.py``; ``lm.loss_fn(pctx=)`` gives the global batch's
loss); sums over the model axis the gradients of the leaves the layout
keeps whole inside a split block while each rank reads them for its own
share (``parallel/rules.py:partial_grad``: a qk-norm's gammas, SSD's B, C
and dt projections, the MoE router), then sums every gradient over the
data axis in f32, reduce-scattered onto the ZeRO slice (the 1/D is in the
global loss); takes the global norm with each element counted once over
the mesh; and runs AdamW on the rank's slices.  Every family trains on
any (data, model) mesh whose layout ``rules.bind`` decides: each
replicated tensor that a split block reads for its own share enters the
block through ``comm.enter`` (``models/layers.py``).

``make_compressed_dp_step`` is the reference's data-parallel variant:
replicated parameters, the int8 error-feedback sum of
``optim/compress.py``.  ``TrainConfig.grad_compress`` is read nowhere,
in the reference as here: the compressed step is built by that function.

The :class:`Trainer` adds the loop: checkpoint/restart (under a mesh the
checkpoint is written whole, the reference's layout), the straggler
deadline, failure injection for the FT tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_psum, cosine_schedule)
from repro_torch.optim.adamw import adamw_step_
from repro_torch.parallel import ParallelCtx, comm
from repro_torch.parallel.rules import (P, NamedSharding, bind,
                                        param_sharding, partial_grad)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    remat: bool = True
    zero1: bool = True
    grad_compress: bool = False      # int8 + error feedback (read nowhere)
    opt: AdamWConfig = AdamWConfig()
    warmup: int = 100
    total_steps: int = 1000
    step_deadline_s: float = 0.0     # >0 → straggler deadline (Trainer loop)
    checkpoint_every: int = 100
    checkpoint_dir: str = ""
    keep: int = 3


def _microbatches(batch, n: int):
    """The batch's leading dim cut into n equal slices."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def opt_sharding(opt_state, pshard, pctx: ParallelCtx, zero1: bool):
    """Shardings of the optimizer state: each leaf like its parameter
    (``pshard``, :func:`~repro_torch.parallel.param_sharding`'s specs),
    and with ``zero1`` split over the data axes on its first dimension the
    parameter's spec leaves free and the data ranks divide (ZeRO-1; a
    layer-stacked leaf's layer axis first).  Read on the global shapes of
    ``opt_state``'s 'master', 'm' and 'v'; a tree of
    :class:`~repro_torch.parallel.NamedSharding`."""
    dp = pctx.dp_world

    def per(leaf, ps):
        spec = list(ps) + [None] * (leaf.dim() - len(ps))
        if zero1:
            for i in range(leaf.dim()):
                if spec[i] is None and leaf.shape[i] % dp == 0 \
                        and leaf.shape[i] >= dp:
                    spec[i] = pctx.dp
                    break
        return NamedSharding(pctx, P(*spec))

    return {"step": NamedSharding(pctx, P()),
            **{k: tree_map(per, opt_state[k], pshard)
               for k in ("master", "m", "v")}}


def _loss_and_grads(lfn, params, batch, nmb: int):
    """(loss, gradients in ``params``' leaf order): f32 sums over the
    microbatches divided by their count, or the one batch's own."""
    leaves = tree_leaves(params)
    if nmb > 1:
        grads, loss = None, 0.0
        for mb in _microbatches(batch, nmb):
            lv = lfn(params, mb)
            g = torch.autograd.grad(lv, leaves)
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for a, b in zip(grads, g):
                    a.add_(b)
            loss = loss + lv.detach()
            del g, lv
        for a in grads:
            a.div_(nmb)
        return loss / nmb, grads
    loss = lfn(params, batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def _counted_here(sh: NamedSharding, pctx) -> bool:
    """Whether this rank adds the leaf's Σg² to the global norm: its own
    slice of a split axis, or a replicated axis's copy on rank 0 only."""
    return (bool(sh.dims("model")) or pctx.rank == 0) \
        and (bool(sh.dims("data")) or pctx.dp_rank == 0)


class _MeshStep:
    """The per-leaf plan of the mesh's step, from the masters' shardings
    (leaf order): each leaf's ZeRO dim and whether its gradient is partial
    over the model axis."""

    def __init__(self, pctx, master_shardings):
        self.pctx = pctx
        self.shard = []
        self.partial = []
        for path, sh in tree_leaves_with_path(master_shardings):
            self.shard.append(sh)
            self.partial.append(partial_grad(
                ".".join(str(p) for p in path), sh.spec, pctx))

    def compute(self, master, dt, sh, grad: bool = True):
        """The rank's compute parameter: its slice cast, then gathered over
        the data axis (a leaf that requires grad, with ``grad``)."""
        p = master.to(dt, copy=True)
        for i in sh.dims("data"):
            p = comm.all_gather(p, self.pctx, dim=i, axis="data")
        return p.requires_grad_(grad)

    def reduce(self, grads) -> list:
        """Partial gradients summed over the model axis, then every one over
        the data axis in f32 (reduce-scattered onto a ZeRO slice); each
        whole gradient leaves ``grads`` as its reduction is made."""
        out = []
        for i, (sh, part) in enumerate(zip(self.shard, self.partial)):
            g, grads[i] = grads[i], None
            if part:
                g = comm.all_reduce(g.float(), self.pctx)
            if self.pctx.dp_world > 1:
                zd = sh.dims("data")
                g = (comm.reduce_scatter(g.float(), self.pctx, dim=zd[0])
                     if zd else comm.all_reduce(g.float(), self.pctx,
                                                axis="data"))
            out.append(g)
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt(Σ g²) of the whole gradient, each element counted once: a
        split leaf's slices summed over its axis, a replicated copy taken
        from rank 0 of that axis."""
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
              for g, sh in zip(grads, self.shard)
              if _counted_here(sh, self.pctx)]
        s = torch.stack(sq).sum() if sq else torch.zeros(
            (), dtype=torch.float32, device=grads[0].device)
        s = comm.all_reduce(s, self.pctx)
        return comm.all_reduce(s, self.pctx, axis="data").sqrt()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    pctx: Optional[ParallelCtx] = None,
                    loss_fn: Optional[Callable] = None, param_dtypes=None,
                    opt_shardings=None):
    """The train step: (opt_state, batch) → (opt_state, metrics {'loss',
    'grad_norm' (0-d tensors), 'lr' (float)}).  ``opt_state`` is updated
    in place.  ``param_dtypes`` (a tree of dtypes, default bf16 for every
    leaf) are the compute parameters' dtypes; ``loss_fn(params, batch)``
    (default ``lm.loss_fn`` under ``pctx`` with the config's remat)
    returns the scalar loss.  Under a mesh ``opt_state`` holds the rank's
    slices as ``opt_shardings`` (:func:`opt_sharding`'s tree) places them,
    and ``batch`` the rank's rows (see the module docstring)."""
    mesh = pctx is not None and pctx.mesh is not None
    if mesh:
        pctx = bind(pctx, cfg)
        if opt_shardings is None:
            raise ValueError("make_train_step under a mesh needs "
                             "opt_shardings (opt_sharding's tree)")
        plan = _MeshStep(pctx, opt_shardings["master"])
    lfn = loss_fn or (lambda p, b: lm.loss_fn(cfg, p, b, pctx=pctx,
                                              remat=tcfg.remat)[0])

    def step_fn(opt_state, batch):
        dts = param_dtypes or tree_map(lambda _: torch.bfloat16,
                                       opt_state["master"])
        if mesh:
            params = tree_map(plan.compute, opt_state["master"], dts,
                              opt_shardings["master"])
        else:
            params = tree_map(
                lambda m, dt: m.to(dt, copy=True).requires_grad_(),
                opt_state["master"], dts)
        loss, grads = _loss_and_grads(lfn, params, batch,
                                      tcfg.n_microbatches)
        del params                           # free the compute copy first
        gn = None
        if mesh:
            grads = plan.reduce(grads)
            gn = plan.global_norm(grads)
        lr = cosine_schedule(int(opt_state["step"]), tcfg.warmup,
                             tcfg.total_steps, tcfg.opt.lr)
        om = adamw_step_(grads, opt_state, tcfg.opt, lr_t=lr, gn=gn)
        return opt_state, {"loss": loss, **om}

    return step_fn


def make_compressed_dp_step(cfg: ModelConfig, tcfg: TrainConfig,
                            pctx: ParallelCtx):
    """The data-parallel step with the int8 error-feedback sum of the
    gradients: (params, opt_state, err, batch) → (params, opt_state, err,
    metrics).  Parameters and optimizer state are replicated (whole on
    every rank), ``err`` (``compress_state_init``) is the rank's own and
    ``batch`` its rows; the loss of the rank's rows (no model axis) is
    differentiated, the gradients go through ``compressed_psum`` over the
    data axis and are divided by its ranks, AdamW updates ``opt_state`` in
    place and returns the new parameters in ``params``' dtypes, and the
    loss is the mean of the ranks'."""
    n = pctx.dp_world

    def step_fn(params, opt_state, err, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, grads = _loss_and_grads(
            lambda q, b: lm.loss_fn(cfg, q, b, remat=tcfg.remat)[0], p,
            batch, 1)
        del p
        it = iter(grads)
        grads, err = compressed_psum(tree_map(lambda _: next(it), params),
                                     pctx, err)
        grads = tree_map(lambda g: g / n, grads)
        lr = cosine_schedule(int(opt_state["step"]), tcfg.warmup,
                             tcfg.total_steps, tcfg.opt.lr)
        params, opt_state, om = adamw_update(grads, opt_state, tcfg.opt,
                                             params=params, lr_t=lr)
        loss = comm.all_reduce(loss, pctx, axis="data") / n
        return params, opt_state, err, {"loss": loss, **om}

    return step_fn


class Trainer:
    """The training loop: init, checkpoint/restart, the straggler
    deadline, failure injection for FT tests.  Runs on the card unless
    ``device="cpu"``; ``generator`` seeds the init (default seed 0 on the
    device).  Under ``pctx`` (a mesh) it runs on the mesh's device, every
    rank draws the whole tree from the same seed and keeps its slices
    (:func:`opt_sharding` with ``tcfg.zero1``), and ``data_iter`` yields
    the rank's rows (``token_stream(host_id=pctx.dp_rank,
    n_hosts=pctx.dp_world)``)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data_iter,
                 pctx: Optional[ParallelCtx] = None, device="cuda",
                 generator: torch.Generator | None = None):
        from repro_torch.checkpoint import CheckpointManager
        self.cfg, self.tcfg = cfg, tcfg
        self.oshard = None
        if pctx is not None and pctx.mesh is not None:
            pctx = bind(pctx, cfg)
            device = pctx.mesh.device
        self.pctx = pctx
        self.device = resolve_device(device)
        self.data = data_iter
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params0 = lm.init_params(cfg, generator, self.device)
        self._dtypes = tree_map(lambda p: p.dtype, params0)
        if self.pctx is None:
            self.opt_state = adamw_init(params0)
        else:
            self.oshard = opt_sharding(
                {k: params0 for k in ("master", "m", "v")},
                param_sharding(params0, self.pctx), self.pctx, tcfg.zero1)
            master = tree_map(lambda p, sh: sh.local(p).to(
                torch.float32, copy=True), params0, self.oshard["master"])
            self.opt_state = {"step": torch.zeros((), dtype=torch.int32),
                              "master": master,
                              "m": tree_map(torch.zeros_like, master),
                              "v": tree_map(torch.zeros_like, master)}
        del params0
        self.step_fn = make_train_step(cfg, tcfg, self.pctx,
                                       param_dtypes=self._dtypes,
                                       opt_shardings=self.oshard)
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
                     if tcfg.checkpoint_dir else None)
        self.step = 0
        self.metrics_log: list = []
        self.failure_hook: Optional[Callable[[int], None]] = None  # FT tests
        self.skipped_steps: list = []

    @property
    def params(self):
        """Compute params (bf16 weights, f32 norms) from the f32 masters;
        under a mesh the rank's model slices (every rank calls it: the
        ZeRO slices are gathered over the data axis)."""
        if self.oshard is None:
            return tree_map(lambda m, dt: m.to(dt, copy=True),
                            self.opt_state["master"], self._dtypes)
        plan = _MeshStep(self.pctx, self.oshard["master"])
        return tree_map(lambda m, dt, sh: plan.compute(m, dt, sh, False),
                        self.opt_state["master"], self._dtypes,
                        self.oshard["master"])

    def _shardings(self):
        """The checkpoint tree's shardings ({'opt': ...}), None without a
        mesh."""
        return None if self.oshard is None else {"opt": self.oshard}

    def restore_if_available(self) -> bool:
        from repro_torch.checkpoint import reshard_restore
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        like = {"opt": self.opt_state}
        state = (self.ckpt.restore(latest, like) if self.oshard is None
                 else reshard_restore(self.ckpt, latest, like,
                                      self._shardings()))
        self.opt_state = state["opt"]
        self.step = latest
        return True

    def _next_batch(self):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in next(self.data).items()}

    def run(self, n_steps: int):
        """``n_steps`` steps; the next batch is drawn while the card runs
        the step (the step reads nothing back before its metrics)."""
        deadline = self.tcfg.step_deadline_s
        end = self.step + n_steps
        batch = self._next_batch() if n_steps > 0 else None
        while self.step < end:
            if self.failure_hook is not None:
                self.failure_hook(self.step)   # may raise: a simulated crash
            t0 = time.monotonic()
            self.opt_state, m = self.step_fn(self.opt_state, batch)
            batch = self._next_batch() if self.step + 1 < end else None
            m = {k: float(v) for k, v in m.items()}
            dt = time.monotonic() - t0
            if deadline > 0 and dt > deadline:
                # straggler: log and go on (the state is consistent after
                # the step; a fleet would reissue it on a backup)
                self.skipped_steps.append((self.step, dt))
            self.metrics_log.append({"step": self.step, "time_s": dt, **m})
            self.step += 1
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(self.step, {"opt": self.opt_state},
                               shardings=self._shardings())
        return self.metrics_log
