"""Groupwise quantization-dequantization (QDQ) — paper §2 / Appendix B & D.

Two group layouts, as in the reference:

* ``flat`` — groups of g consecutive elements in row-major order;
* ``row``  — groups along the contraction dim d, scale/zero stored as
  (d', d//g): the kernel layout (packed codes feed ``ttq_gemm``).

Asymmetric format S=(Wmax-Wmin)/(2^q-1), Z=Wmin (default); symmetric
S=2|W|max/(2^q-1), Z=-|W|max.  ``torch.round`` rounds half to even, like
``jnp.round``.
"""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 4
    group_size: int = 32
    symmetric: bool = False
    nu: float = 1.0          # expansion factor (Appendix D); 1.0 = standard
    layout: str = "flat"     # 'flat' (paper) | 'row' (kernel)

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1


def _group(W: torch.Tensor, g: int, layout: str) -> torch.Tensor:
    if layout == "flat":
        if W.numel() % g:
            raise ValueError(f"W.size={W.numel()} not divisible by group_size={g}")
        return W.reshape(-1, g)
    if layout == "row":
        dp, d = W.shape
        if d % g:
            raise ValueError(f"d={d} not divisible by group_size={g}")
        return W.reshape(dp * (d // g), g)
    raise ValueError(f"unknown layout {layout!r}")


def _scale_zero(Wg: torch.Tensor, cfg: QuantConfig):
    if cfg.symmetric:
        amax = Wg.abs().amax(dim=1, keepdim=True)
        S = 2.0 * amax / cfg.qmax
        Z = -amax
    else:
        wmax = Wg.amax(dim=1, keepdim=True)
        wmin = Wg.amin(dim=1, keepdim=True)
        if cfg.nu != 1.0:
            c, h = (wmax + wmin) / 2.0, (wmax - wmin) / 2.0
            wmax, wmin = c + cfg.nu * h, c - cfg.nu * h
        S = (wmax - wmin) / cfg.qmax
        Z = wmin
    S = torch.where(S <= 0, torch.full_like(S, _EPS), S)
    return S, Z


def quantize(W: torch.Tensor, cfg: QuantConfig):
    """G[W] → (W_int uint8, S, Z); S, Z are (n_groups,) ('flat') or
    (d', d//g) ('row')."""
    if cfg.bits > 8:
        raise ValueError(f"bits={cfg.bits} > 8 is not supported")
    Wg = _group(W.float(), cfg.group_size, cfg.layout)
    S, Z = _scale_zero(Wg, cfg)
    Wint = torch.clamp(torch.round((Wg - Z) / S), 0, cfg.qmax).to(torch.uint8)
    if cfg.layout == "row":
        dp, d = W.shape
        g = cfg.group_size
        return (Wint.reshape(dp, d), S.reshape(dp, d // g),
                Z.reshape(dp, d // g))
    return Wint.reshape(W.shape), S[:, 0], Z[:, 0]


def dequantize(Wint: torch.Tensor, S: torch.Tensor, Z: torch.Tensor,
               cfg: QuantConfig) -> torch.Tensor:
    """G⁻[W_int] = W_int ∘ S + Z in f32, undoing :func:`quantize`'s layout."""
    g = cfg.group_size
    if cfg.layout == "row":
        dp, d = Wint.shape
        Wg = Wint.reshape(dp, d // g, g).float()
        return (Wg * S[..., None] + Z[..., None]).reshape(dp, d)
    Wg = Wint.reshape(-1, g).float()
    return (Wg * S[:, None] + Z[:, None]).reshape(Wint.shape)


def qdq(W: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Q[W] = G⁻[G[W]], the groupwise round-to-nearest fake-quant, in W's
    dtype."""
    return dequantize(*quantize(W, cfg), cfg).to(W.dtype)


def pack_bits(Wint: torch.Tensor, bits: int) -> torch.Tensor:
    """k = 32//bits codes per int32 along the last axis, low bits first.

    The words hold the bit pattern of the unsigned sum: at bits=8 a code
    ≥ 128 in the top byte wraps into the sign bit, exactly like the
    reference's int32 sum.  (torch sums int32 in int64, so the wrap is
    made explicit.)"""
    per = 32 // bits
    if Wint.shape[-1] % per:
        raise ValueError(f"last dim must be divisible by {per}")
    w = Wint.to(torch.int64).reshape(*Wint.shape[:-1], -1, per)
    shifts = torch.arange(per, dtype=torch.int64, device=Wint.device) * bits
    words = (w << shifts).sum(dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(packed: torch.Tensor, d: int, bits: int) -> torch.Tensor:
    """(..., d·bits/32) int32 → (..., d) int32 codes in [0, 2^bits)."""
    per = 32 // bits
    mask = (1 << bits) - 1
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * bits
    w = (packed.unsqueeze(-1) >> shifts) & mask
    return w.reshape(*packed.shape[:-1], d)


def rtn(W: torch.Tensor, bits: int, group_size: int, **kw) -> torch.Tensor:
    """The paper's ``rtn(W, q, g)``: :func:`qdq` at ``bits`` and
    ``group_size`` (other :class:`QuantConfig` fields through ``kw``)."""
    return qdq(W, QuantConfig(bits=bits, group_size=group_size, **kw))


def pack_int4(Wint: torch.Tensor) -> torch.Tensor:
    """(..., d) codes in [0, 15] → (..., d//8) int32, low nibble first."""
    if Wint.shape[-1] % 8:
        raise ValueError("last dim must be divisible by 8 to pack int4")
    return pack_bits(Wint, 4)


def unpack_int4(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d//8) int32 → (..., d) int32 codes in [0, 15]."""
    return unpack_bits(packed, d, 4)
