"""Tensor-parallel training of the five families beyond plain attention
(RG-LRU, SSD, encoder-decoder with cross-attention, MLA with MoE, MoE)
over ``torch.distributed`` (gloo, on the CPU), held to the port's own
world 1, which ``tests/test_torch_training.py`` holds to ``jax.grad``.

Each of recurrentgemma-9b, mamba2-1.3b, whisper-medium, deepseek-v2-lite
and llama4-scout (smoke configs) trains 3 steps in 2 microbatches at
(1,2), (1,4) and (2,2); deepseek under ``moe_impl="dense"`` against
``pctx=None``, and both MoE configs under ``"a2a"`` at capacity factor
8 (nothing dropped) against the (1,1) ``"a2a"`` context:

* the layout the case binds splits the family's block (``rec``, ``ssd``,
  ``attn`` for whisper's cross-attention, ``mla`` and ``experts``), so no
  case passes on a replicated block;
* losses and masters by the DP rule, step 1's bf16 grad norm within
  GN_RTOL, and every leaf's f32 step-1 gradient within GRAD_F32 of world
  1's (``tests/test_torch_parallel_training.py``'s tolerances; measured:
  masters at most 0.56 of the DP tolerance, grad norms 4.2e-4, gradients
  2.2e-6, llama4's 4.8e-5 on its top-1 router, whose gradient is zero up
  to rounding and meets the floor);
* one negative control per backward rule at (1,2): with the SSD block's
  entries removed, with the router's partial sum removed, with MLA's
  rope-key entry removed, with the cross-attention's entry of the encoder
  output removed, and with an extra entry on ``wkv_a``'s whole output
  (which sums the latent's already whole cotangent twice), the named
  leaf's f32 gradient is off by more than NO_ENTRY (measured 0.27–1.7).

whisper's encoder runs in bf16 whatever the parameters' dtype (its
input is bf16 frames plus bf16 positions, the reference's), so the f32
gradients are taken with f32 positions on both sides
(``_torch_train_families_worker.f32_encoder``).

Every case runs in one spawn of four processes under a timeout
(``tests/_torch_train_families_worker.py:families_suite``)."""
import numpy as np
import pytest
import torch

import _torch_train_families_worker as W
from repro_torch._tree import tree_leaves_with_path
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUITE_TIMEOUT = 300
LOSS_RTOL = MASTER_RTOL = 2e-2
MASTER_ATOL = 2e-3
GRAD_F32 = 1e-4
NO_ENTRY = 0.1
GN_RTOL = 1e-3
# the leaf each negative control must put wrong
CONTROL_LEAF = {"ssd": "stack/0/u0/mix/w_B",
                "router": "stack/0/u0/mlp/router",
                "rope": "stack/0/u0/mix/wkv_a",
                "xkv": "enc_stack/0/u0/mix/wq",
                "doubled": "stack/0/u0/mix/wkv_a"}


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), floor, 1e-30)


def _paths(name, impl):
    params = lm.init_params(W.model_cfg(name, impl),
                            torch.Generator().manual_seed(0), "cpu")
    return ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(params)]


@pytest.fixture(scope="module")
def suite():
    """Every case's result, by key (one spawn per module)."""
    return W.merged(spawn(W.families_suite, 4, device="cpu",
                          timeout=SUITE_TIMEOUT))


def _get(suite, key):
    res = suite[key]
    assert "error" not in res, res["error"]
    return res


CASES = [pytest.param(n, i, blocks, d, m,
                      id=f"{W.case_key(n, i)}-{d}{m}")
         for n, i, blocks in W.CASES for d, m in W.MESHES]


@pytest.mark.parametrize("name,impl,blocks,d,m", CASES)
def test_layout_splits_the_block(suite, name, impl, blocks, d, m):
    lay = _get(suite, ("tp", W.case_key(name, impl), d, m))["layout"]
    assert all(lay[b] for b in blocks), lay


@pytest.mark.parametrize("name,impl,blocks,d,m", CASES)
def test_training_holds_world1(suite, name, impl, blocks, d, m):
    """3 steps: losses and masters by the DP rule; step 1's bf16 grad norm
    within GN_RTOL."""
    key = W.case_key(name, impl)
    res, w1 = _get(suite, ("tp", key, d, m)), _get(suite, ("w1", key))
    np.testing.assert_allclose(res["loss"], w1["loss"], rtol=LOSS_RTOL)
    for a, b in zip(w1["master"], res["master"]):
        np.testing.assert_allclose(b, a, rtol=MASTER_RTOL, atol=MASTER_ATOL)
    np.testing.assert_allclose(res["grad_norm"][0], w1["grad_norm"][0],
                               rtol=GN_RTOL)


@pytest.mark.parametrize("name,impl,blocks,d,m", CASES)
def test_step1_gradients_hold_world1(suite, name, impl, blocks, d, m):
    """Step 1's gradients in f32 compute, gathered whole: every leaf within
    GRAD_F32 of world 1's (floored at GRAD_F32 of the whole gradient's
    norm)."""
    key = W.case_key(name, impl)
    res, w1 = _get(suite, ("tp", key, d, m)), _get(suite, ("w1", key))
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in w1["grads32"]))
    for path, a, b in zip(_paths(name, impl), w1["grads32"],
                          res["grads32"]):
        assert _rel(a, b, GRAD_F32 * norm) < GRAD_F32, path


@pytest.mark.parametrize("which,name,impl", W.CONTROLS,
                         ids=[c for c, _, _ in W.CONTROLS])
def test_each_backward_rule_is_needed(suite, which, name, impl):
    """At (1,2) with the rule removed (or the latent entered twice), the
    named leaf's f32 step-1 gradient is off world 1's by more than
    NO_ENTRY (10× the 1e-2 step 1's gradients must meet)."""
    w1 = _get(suite, ("w1", W.case_key(name, impl)))
    res = _get(suite, ("ctl", which))
    got = dict(zip(_paths(name, impl), res["grads32"]))
    want = dict(zip(_paths(name, impl), w1["grads32"]))
    leaf = CONTROL_LEAF[which]
    assert _rel(want[leaf], got[leaf]) > NO_ENTRY, leaf

