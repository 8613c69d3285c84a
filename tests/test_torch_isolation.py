"""The port stands alone: no file of ``src/repro_torch/`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
refuse to drop to the CPU when a card is asked for and missing."""
import ast
import pathlib

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            yield (arg.value if isinstance(arg, ast.Constant)
                   else "".join(v.value for v in arg.values
                                if isinstance(v, ast.Constant)))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusals cannot show")


def test_entry_points_refuse_missing_card(no_card):
    from repro_torch.configs import get
    from repro_torch.core import ttq_policy
    from repro_torch.models import lm
    from repro_torch.serving import EngineConfig, TTQEngine
    cfg = get("gemma_7b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(cfg)                          # device defaults to cuda
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TTQEngine(cfg, params, ttq_policy(rank=0), EngineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_decode_state(cfg, 2, 16)
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.training import TrainConfig, Trainer
    with pytest.raises(RuntimeError, match="cuda"):
        next(token_stream(DataConfig(), 0))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainConfig(), iter(()))


def test_kernel_wrappers_never_compute_off_card(no_card):
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never computed by the plain version."""
    from repro_torch.kernels import build, ops
    m = dict(device="meta")
    x = torch.empty((4, 256), dtype=torch.bfloat16, **m)
    pk = torch.empty((64, 32), dtype=torch.int32, **m)
    sz = torch.empty((64, 8), dtype=torch.float32, **m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ttq_gemm(x, pk, sz, sz, bits=4, group_size=32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ttq_quantize(torch.empty((64, 256), **m),
                         torch.empty((256,), **m), bits=4, group_size=32)
    q = torch.empty((1, 2, 1, 32), **m)
    kq = torch.empty((1, 2, 8, 32), dtype=torch.int8, **m)
    ks = torch.empty((1, 2, 8, 1), **m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kv_decode_attention(q, kq, ks, kq, ks,
                                torch.empty((1,), dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kv_paged_decode_attention(
            q, kq, ks, kq, ks, torch.empty((1, 1), dtype=torch.int32, **m),
            torch.empty((1,), dtype=torch.int32, **m))
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError):
        build.lib()                                  # no nvcc / no card here
    assert build.LAUNCHES == before


def test_engine_options_of_later_slices_raise():
    """No ``EngineConfig`` field raises any more: the reference's default
    engine (guards on) and a chunked one construct, and every field takes a
    non-default value."""
    import dataclasses as dc
    from repro_torch.configs import get
    from repro_torch.core import ttq_policy
    from repro_torch.models import lm
    from repro_torch.quant import GuardConfig
    from repro_torch.serving import EngineConfig, TTQEngine
    cfg = get("gemma_7b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    dflt = TTQEngine(cfg, params, ttq_policy(rank=0), EngineConfig(),
                     device="cpu")
    assert dflt.ecfg.guards and dflt.runner.detect_faults
    assert dflt.qmodel.health_gate == GuardConfig()
    chunked = TTQEngine(cfg, params, ttq_policy(rank=0),
                        EngineConfig(prefill_chunk=16, prefill_budget=32,
                                     max_queue=4, deadline_s=5.0,
                                     guard_cfg=GuardConfig(max_retries=0)),
                        device="cpu")
    assert chunked.scheduler.max_prompt_len == chunked.ecfg.max_len
    off = {"guards": False, "guard_cfg": GuardConfig(max_retries=3),
           "deadline_s": 1.0, "prefill_chunk": 16, "prefill_budget": 16,
           "max_queue": 2, "speculate_k": 2, "double_buffer": True,
           "requant_threshold": 0.1}
    for f in dc.fields(EngineConfig):
        if f.name in off:
            TTQEngine(cfg, params, ttq_policy(rank=0),
                      EngineConfig(**{f.name: off[f.name]}), device="cpu")
    # speculation: it constructs, with the policy's draft variant
    eng = TTQEngine(cfg, params, ttq_policy(rank=0),
                    EngineConfig(speculate_k=2), device="cpu")
    assert eng.ecfg.speculate_k == 2 and eng.draft_policy.qcfg.bits == 4


@pytest.mark.parametrize("ecfg", [dict(requant_threshold=0.1),
                                  dict(double_buffer=True),
                                  dict(requant_threshold=0.1,
                                       double_buffer=True)],
                         ids=["threshold", "double buffer", "both"])
def test_engine_serves_the_reference_default_policy(ecfg):
    """``ttq_policy()`` (its default rank 16) with the delta gate and the
    double buffer: the options that refused before this slice construct and
    serve; the factors are computed once and ride in every quantized leaf."""
    from repro_torch.configs import get
    from repro_torch.core import ttq_policy
    from repro_torch.models import lm
    from repro_torch.serving import EngineConfig, TTQEngine
    cfg = get("gemma_7b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = TTQEngine(cfg, params, ttq_policy(),
                    EngineConfig(max_slots=2, max_len=64,
                                 decode_chunk=2, **ecfg), device="cpu")
    rids = [eng.submit([5 + i, 9, 17, 3], max_new=4) for i in range(3)]
    out = eng.run_all()
    assert all(len(out[r]) == 4 and not out[r].unfinished for r in rids)
    assert eng.n_requants >= 2 and eng.lowrank_tree is not None
    wg = eng.decode_params["stack"][0]["u0"]["mlp"]["wg"]
    lr = eng.lowrank_tree["stack"][0]["u0"]["mlp"]["wg"]
    assert wg.B is lr["B"] and wg.A is lr["A"] and wg.B.shape[-1] == 16
    assert eng.layers_requantized + eng.layers_skipped == 7 * eng.n_requants
