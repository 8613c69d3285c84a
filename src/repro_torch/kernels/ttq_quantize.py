"""Wrapper of the ``ttq_quantize`` CUDA kernel (``csrc/ttq_quantize.cu``).

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
ttq_quantize_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from . import build, ref
from ._checks import aligned, dtype_in, on_cuda, sm_count

NAME = "ttq_quantize"
# The kernel's geometry.  Each launch passes WARPS, BLOCKS_PER_SM and the
# strip count, and the C entry refuses a launch whose geometry differs from
# its own (csrc/ttq_quantize.cu: kWarps, kMinBlocksPerSm, kVecs).
WARPS = 8               # warps per block
BLOCKS_PER_SM = 2       # blocks per SM, all resident
VECS = 4                # adjacent 16-byte vectors per lane and row
MIN_ROWS = 8            # fewest rows a warp walks


def strip_count(d: int, wbytes: int) -> int:
    """Column strips of a row: a warp's 32 lanes × VECS vectors of 16 bytes
    (2 KB of W per row), the last one ragged where d is not a multiple."""
    return -(-d // (32 * VECS * (16 // wbytes)))


@functools.lru_cache(maxsize=None)      # called per requant family
def quant_blocks(n: int, dp: int, d: int, wbytes: int, n_sm: int) -> int:
    """The kernel's grid: how many blocks of WARPS warps walk the stack.

    The work is n × strips × d′ rows of one strip (``strip_count``), in
    (layer, strip, row) order, split evenly over the grid's warps, each
    warp a contiguous run down the rows.  Taken: BLOCKS_PER_SM × n_sm blocks
    (as many as the card holds at once, so no block waits for a second
    wave), or fewer where that would leave a warp under MIN_ROWS rows.  At
    gemma-7b's four bf16 families and 132 SMs every family takes 264 blocks:
    162.9 (wq/wk/wv, wo) and 977.5 (wg/wu, wd) rows per warp."""
    rows = n * strip_count(d, wbytes) * dp
    return max(1, min(BLOCKS_PER_SM * n_sm, rows // (WARPS * MIN_ROWS)))


def _outputs(out, n, dp, d, per, g, device):
    """The kernel's outputs: new tensors, or the caller's ``out`` (packed,
    S, Z) with leading dim n, checked, for a result that must land in
    storage a captured decode graph reads.  A mismatch raises: copying
    instead would leave that storage stale."""
    want = (((n, dp, d // per), torch.int32), ((n, dp, d // g), torch.float32),
            ((n, dp, d // g), torch.float32))
    if out is None:
        return tuple(torch.empty(s, dtype=t, device=device) for s, t in want)
    for o, (s, t) in zip(out, want):
        if (tuple(o.shape) != s or o.dtype != t or o.device != device
                or not o.is_contiguous() or o.data_ptr() % 16):
            raise ValueError(f"{NAME}: out {tuple(o.shape)} {o.dtype} on "
                             f"{o.device} is not a contiguous, 16-byte "
                             f"aligned {s} {t} on {device}")
    return tuple(out)


def ttq_quantize(W: torch.Tensor, D: torch.Tensor, *, bits: int = 4,
                 group_size: int = 32, out=None):
    """W (n, d', d) or (d', d), bf16 or f32; D (n, d) or (d,) f32 →
    (packed int32 (..., d', d·bits/32), S, Z f32 (..., d', d/g)).  A g that
    is not a power of two in [32/bits, 512] runs the kernel's generic
    walk (``csrc/ttq_quantize.cu``, "Other group sizes").  With
    ``out`` = (packed, S, Z) of those shapes the results are written there
    and ``out`` is returned."""
    if W.device.type == "cpu":
        res = ref.ttq_quantize_ref(W, D, bits=bits, group_size=group_size)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    on_cuda(NAME, W, D)
    dtype_in(NAME, "W", W, (torch.bfloat16, torch.float32))
    dtype_in(NAME, "D", D, (torch.float32,))
    squeeze = W.dim() == 2
    if squeeze:
        W, D = W[None], D[None]
        out = None if out is None else tuple(o[None] for o in out)
    if W.dim() != 3 or D.shape != (W.shape[0], W.shape[2]):
        raise ValueError(f"{NAME}: W {tuple(W.shape)} / D {tuple(D.shape)} "
                         f"must be (n, d', d) / (n, d)")
    n, dp, d = W.shape
    g = group_size
    if bits not in (2, 4, 8):
        raise ValueError(f"{NAME}: bits={bits} not in (2, 4, 8)")
    per = 32 // bits
    if g <= 0 or d % g or d % per:
        raise ValueError(f"{NAME}: d={d} must divide by group_size={g} and "
                         f"by {per} (codes per word)")
    if W.dtype == torch.bfloat16 and d % 8:
        W = W.float()   # bf16 rows of 16-byte multiples only (bits 8, g 4)
    W, D = aligned(W), aligned(D)
    packed, S, Z = _outputs(out, n, dp, d, per, g, W.device)
    wbytes = W.element_size()
    err = build.lib().ttq_quantize_launch(
        W.data_ptr(), int(W.dtype == torch.bfloat16), D.data_ptr(),
        packed.data_ptr(), S.data_ptr(), Z.data_ptr(), n, dp, d, bits, g,
        quant_blocks(n, dp, d, wbytes, sm_count(W.device)), WARPS,
        BLOCKS_PER_SM, strip_count(d, wbytes),
        torch.cuda.current_stream(W.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    if squeeze:
        return packed[0], S[0], Z[0]
    return packed, S, Z
