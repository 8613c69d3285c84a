"""AdamW with f32 master weights and moments (``repro.optim.adamw``).

The state is {'step' () int32, 'master', 'm', 'v'}: the masters, first and
second moments f32 trees of the parameters' nesting on the parameters'
device, the step counter on the host (the lr and the bias corrections are
host scalars of it, so a step never waits for the card to read it).  Compute parameters
are derived from the masters (``training/trainer.py``).  The update runs in
place, leaf by leaf, so that at full width it needs no second copy of the
state; its values are the reference's: global-norm clip, bias-corrected
moments, weight decay decoupled onto the master.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """f32 masters (copies) and zero moments for ``params``."""
    f32 = lambda p: p.detach().to(torch.float32, copy=True)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "master": tree_map(f32, params),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32 (a 0-d tensor on the device)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in tree_leaves(grads)]
    return torch.stack(sq).sum().sqrt()


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads as f32 scaled to a global norm ≤ ``max_norm``, the global
    norm before the clip)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_step_(grads, opt_state, cfg: AdamWConfig, lr_t=None,
                gn=None) -> dict:
    """One AdamW step on ``opt_state``, in place; returns the metrics
    {'grad_norm' (0-d tensor), 'lr' (float)}.  The bias corrections and the
    lr are f32 host scalars of the step.  ``gn``: the global norm of the
    whole gradient where ``grads`` are one rank's slices of it (default:
    theirs, :func:`global_norm`)."""
    step = int(opt_state["step"]) + 1
    lr = cfg.lr if lr_t is None else lr_t
    f = np.float32
    b1c = float(f(1) - f(cfg.b1) ** f(step))
    b2c = float(f(1) - f(cfg.b2) ** f(step))
    if gn is None:
        gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    for g, mst, m, v in zip(*(tree_leaves(t) for t in (
            grads, opt_state["master"], opt_state["m"], opt_state["v"]))):
        g = g.float() * scale            # at most two leaf-sized temporaries
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        g = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        upd = torch.div(m, b1c).div_(g)
        del g
        mst.sub_(upd.add_(mst, alpha=cfg.weight_decay), alpha=lr)
    opt_state["step"].add_(1)
    return {"grad_norm": gn, "lr": lr}


def adamw_update(grads, opt_state, cfg: AdamWConfig, params=None, lr_t=None):
    """The reference's signature: (new params [the masters cast to the
    dtypes of ``params``, or f32 copies], state, metrics).  The state is
    ``opt_state``, updated in place."""
    om = adamw_step_(grads, opt_state, cfg, lr_t)
    ref = params if params is not None else opt_state["master"]
    new_params = tree_map(lambda mst, p: mst.to(p.dtype, copy=True),
                          opt_state["master"], ref)
    return new_params, opt_state, om
