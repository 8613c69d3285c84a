"""Training substrate — the microbatched train step and the Trainer loop
(``repro.training.trainer``), on one device.

``make_train_step`` builds the step (opt_state, batch) → (opt_state,
metrics):

* compute parameters are cast from the f32 masters at step start (bf16 by
  default), so the optimizer state is the only state;
* gradients of ``n_microbatches`` equal slices of the batch are
  accumulated in f32 and divided by n (the loss too);
* per-layer remat (``models/stack.py``) with ``remat``;
* the cosine LR of the step, then AdamW (``optim/adamw.py``), in place.

The :class:`Trainer` adds the loop: checkpoint/restart, the straggler
deadline, failure injection for the FT tests.

ZeRO-1 (the reference's ``opt_sharding``), the int8-compressed DP step
(``make_compressed_dp_step``) and elastic re-meshing need a process group
and wait for tensor parallelism (ROADMAP A10 (d)); without one, ``zero1=True``
does nothing, as in the reference without a mesh, and ``grad_compress`` is
not read.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.optim.adamw import adamw_step_


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    remat: bool = True
    zero1: bool = True
    grad_compress: bool = False      # int8 + error feedback (needs A10 (d))
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None, param_dtypes=None):
    """The train step: (opt_state, batch) → (opt_state, metrics {'loss',
    'grad_norm' (0-d tensors), 'lr' (float)}).  ``opt_state`` is updated
    in place.  ``param_dtypes`` (a tree of dtypes, default bf16 for every
    leaf) are the compute parameters' dtypes; ``loss_fn(params, batch)``
    (default ``lm.loss_fn`` with the config's remat) returns the scalar
    loss."""
    lfn = loss_fn or (lambda p, b: lm.loss_fn(cfg, p, b,
                                              remat=tcfg.remat)[0])
    nmb = tcfg.n_microbatches

    def step_fn(opt_state, batch):
        dts = param_dtypes or tree_map(lambda _: torch.bfloat16,
                                       opt_state["master"])
        params = tree_map(lambda m, dt: m.to(dt, copy=True).requires_grad_(),
                          opt_state["master"], dts)
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
            loss = loss / nmb
        else:
            loss = lfn(params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        del params, leaves                   # free the compute copy first
        lr = cosine_schedule(int(opt_state["step"]), tcfg.warmup,
                             tcfg.total_steps, tcfg.opt.lr)
        om = adamw_step_(grads, opt_state, tcfg.opt, lr_t=lr)
        return opt_state, {"loss": loss, **om}

    return step_fn


class Trainer:
    """The training loop on one device: init, checkpoint/restart, the
    straggler deadline, failure injection for FT tests.  Runs on the card
    unless ``device="cpu"``; ``generator`` seeds the init (default seed
    0 on the device)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data_iter,
                 device="cuda", generator: torch.Generator | None = None):
        from repro_torch.checkpoint import CheckpointManager
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.data = data_iter
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params0 = lm.init_params(cfg, generator, self.device)
        self._dtypes = tree_map(lambda p: p.dtype, params0)
        self.opt_state = adamw_init(params0)
        del params0
        self.step_fn = make_train_step(cfg, tcfg, param_dtypes=self._dtypes)
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
                     if tcfg.checkpoint_dir else None)
        self.step = 0
        self.metrics_log: list = []
        self.failure_hook: Optional[Callable[[int], None]] = None  # FT tests
        self.skipped_steps: list = []

    @property
    def params(self):
        """Compute params (bf16 weights, f32 norms) from the f32 masters."""
        return tree_map(lambda m, dt: m.to(dt, copy=True),
                        self.opt_state["master"], self._dtypes)

    def restore_if_available(self) -> bool:
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = self.ckpt.restore(latest, {"opt": self.opt_state})
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
                self.ckpt.save(self.step, {"opt": self.opt_state})
        return self.metrics_log
