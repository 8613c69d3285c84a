"""The per-rank side of ``tests/test_torch_parallel_training_families.py``:
what each process of a ``repro_torch.launch.mesh.spawn`` world runs.  It
imports torch and the port only (a spawned process starts from nothing).

:func:`families_suite` runs every case in one world of four CPU processes
over gloo.  From the (2,2) mesh's model groups each half of the world
(ranks 0–1 and 2–3) makes a (1,2) mesh of its own, and from the (4,1)
mesh's each rank a (1,1) one, so the cases of one mesh shape run on the
halves, or on the ranks, side by side.  World 1 (``pctx=None``) runs in
the same world, one case per rank.  Only rank 0 of a mesh's model axis
keeps a case's result (what is compared travels back as numpy), and a
case that raises returns its traceback instead.
"""
import contextlib
import dataclasses
import sys

from _torch_train_worker import (_ctx, _run, first_grads, model_cfg,
                                 train_record, trainer)
from repro_torch.models import layers as L
from repro_torch.models import lm
import repro_torch.training.trainer as T

# (arch, moe_impl or None, the blocks its layout must split)
CASES = [("recurrentgemma_9b", None, ("rec",)),
         ("mamba2_1p3b", None, ("ssd",)),
         ("whisper_medium", None, ("attn",)),
         ("deepseek_v2_lite_16b", "dense", ("mla", "experts")),
         ("deepseek_v2_lite_16b", "a2a", ("mla", "experts")),
         ("llama4_scout_17b_a16e", "a2a", ("experts",))]
MESHES = ((1, 2), (1, 4), (2, 2))
# the negative controls: (name, arch, moe_impl)
CONTROLS = [("ssd", "mamba2_1p3b", None),
            ("router", "deepseek_v2_lite_16b", "dense"),
            ("rope", "deepseek_v2_lite_16b", "dense"),
            ("xkv", "whisper_medium", None),
            ("doubled", "deepseek_v2_lite_16b", "dense")]


def case_key(name, impl):
    return name if impl is None else f"{name}-{impl}"


@contextlib.contextmanager
def f32_encoder():
    """The encoder in f32 compute: its input is the frames in bf16 plus
    bf16 positions (the reference's), so it runs in bf16 whatever the
    parameters' dtype; f32 positions promote the sum to f32.  Held on both
    sides of a comparison of f32 gradients."""
    real = lm.sinusoidal_pos
    lm.sinusoidal_pos = lambda *a, **k: real(*a, **k).float()
    try:
        yield
    finally:
        lm.sinusoidal_pos = real


def grads32(tr):
    """Step 1's f32 gradients of a fresh Trainer, whole (leaf order)."""
    with f32_encoder():
        return first_grads(tr, f32=True)[1]


def world1(name, impl, pctx=None):
    """A case's reference: its 3-step record and step 1's f32 gradients,
    under ``pctx=None`` or, for the all-to-all MoE, the (1,1) context."""
    cfg = model_cfg(name, impl)
    out = train_record(trainer(cfg, pctx))
    out["grads32"] = grads32(trainer(cfg, pctx))
    return out


def split_case(pctx, name, impl):
    """A case on a mesh: the layout it binds, its record, step 1's f32
    gradients."""
    cfg = model_cfg(name, impl)
    tr = trainer(cfg, pctx)
    out = dict(layout=dataclasses.asdict(tr.pctx.layout))
    out.update(train_record(tr))
    out["grads32"] = grads32(trainer(cfg, pctx))
    return out


# ---------------------------------------------------- the negative controls

def _identity_entry(x, pctx):
    """An entry whose backward is the identity: ``x`` marked entered (so
    no row linear enters it again), its cotangent left partial."""
    if pctx is None or pctx.mesh is None or not x.requires_grad:
        return x
    y = x.view_as(x)
    y._entered_on = pctx
    return y


@contextlib.contextmanager
def entries_removed(where, only=None):
    """``models/layers.py``'s block entries made in the functions named in
    ``where`` (and, with ``only``, on that local variable's tensor alone)
    keep their cotangents partial."""
    real = L.enter

    def enter(x, pctx):
        f = sys._getframe(1)
        if f.f_code.co_name in where and (
                only is None or x is f.f_locals.get(only)):
            return _identity_entry(x, pctx)
        return real(x, pctx)
    L.enter = enter
    try:
        yield
    finally:
        L.enter = real


@contextlib.contextmanager
def router_sum_removed():
    real = T.partial_grad
    T.partial_grad = lambda ps, spec, pctx: (
        False if ps.endswith(".router") else real(ps, spec, pctx))
    try:
        yield
    finally:
        T.partial_grad = real


@contextlib.contextmanager
def latent_entered():
    """An extra entry on ``wkv_a``'s whole output, before the latent and
    the rope key are cut from it."""
    real = L._mla_kv
    L._mla_kv = lambda cfg, p, a, pctx=None: real(cfg, p, L.enter(a, pctx),
                                                  pctx)
    try:
        yield
    finally:
        L._mla_kv = real


CONTROL_PATCH = {
    "ssd": lambda: entries_removed({"_ssd_split", "_ssd_gate"}),
    "router": router_sum_removed,
    "rope": lambda: entries_removed({"_mla_kv"}),
    "xkv": lambda: entries_removed({"_qkv"}, only="xkv"),
    "doubled": latent_entered,
}


def control(pctx, which, name, impl):
    """Step 1's f32 gradients at (1,2) with one rule removed (or, for
    ``doubled``, an entry added)."""
    with CONTROL_PATCH[which]():
        return dict(grads32=grads32(trainer(model_cfg(name, impl), pctx)))


# ------------------------------------------------------------------ suite

def families_suite():
    """Every case: {key: result} from this rank (see the module
    docstring).  Keys: ('w1', case) world 1, ('tp', case, d, m) a mesh,
    ('ctl', control) a negative control."""
    m22, m41, m14 = _ctx(2, 2), _ctx(4, 1), _ctx(1, 4)
    rank = m22.dp_rank * 2 + m22.rank
    half = dataclasses.replace(m22, mesh=dataclasses.replace(
        m22.mesh, shape={"data": 1, "model": 2}, dp_group=None, dp_rank=0))
    solo = dataclasses.replace(m41, mesh=dataclasses.replace(
        m41.mesh, shape={"data": 1, "model": 1}, dp_group=None, dp_rank=0))
    res = {}
    keys = [case_key(n, i) for n, i, _ in CASES]
    # world 1: pctx=None for the dense forms, the (1,1) a2a context for
    # the a2a ones; one case per rank in turn
    for j, (name, impl, _) in enumerate(CASES):
        if j % 4 == rank:
            res["w1", keys[j]] = _run(
                world1, name, impl,
                dataclasses.replace(solo, moe_impl="a2a") if impl == "a2a"
                else None)
    jobs = [(("tp", k, 1, 2), split_case, (n, i)) for k, (n, i, _) in
            zip(keys, CASES)]
    jobs += [(("ctl", c), control, (c, n, i)) for c, n, i in CONTROLS]
    for j, (key, fn, args) in enumerate(jobs):      # (1,2) on each half
        if j % 2 == m22.dp_rank:
            ctx = half if args[-1] is None else dataclasses.replace(
                half, moe_impl=args[-1])
            out = _run(fn, ctx, *args)
            if half.rank == 0:
                res[key] = out
    for d, m in ((1, 4), (2, 2)):
        base = m14 if (d, m) == (1, 4) else m22
        for k, (name, impl, _) in zip(keys, CASES):
            ctx = base if impl is None else dataclasses.replace(
                base, moe_impl=impl)
            out = _run(split_case, ctx, name, impl)
            if rank == 0:
                res["tp", k, d, m] = out
    return res


def merged(results) -> dict:
    """The ranks' results in one dict."""
    out = {}
    for r in results:
        out.update(r)
    return out
