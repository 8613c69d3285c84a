"""int8/int4 KV-cache quantization: symmetric per-(head, token, group) codes
with f32 scales, written at prefill and at each decode append, dequantized
inside the attention read (``kernels/csrc/ttq_attn.cu``).
"""
from __future__ import annotations

import dataclasses

import torch

from .qdq import pack_bits, unpack_bits

_KV_BITS = {"bf16": 16, "int8": 8, "int4": 4}


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """dtype 'bf16' | 'int8' | 'int4' (packed 8 per int32); ``group_size`` 0
    → one scale per (head, token) row; ``use_pallas`` routes the quantized
    read through the fused attention kernel (False → plain PyTorch, the
    reference's escape hatch; the field keeps the reference's name).
    ``paged``: one (num_blocks, Hkv, block_size, ·) pool per attention
    layer plus per-slot block tables instead of the dense (max_slots, Hkv,
    max_len, ·) slab; physical block 0 is the write sink for done and empty
    lanes and is never allocated.  ``block_size`` (paged only) must divide
    max_len, which is checked where the state is built."""

    dtype: str = "bf16"
    group_size: int = 0
    use_pallas: bool = True
    paged: bool = False
    block_size: int = 16

    def __post_init__(self):
        if self.dtype not in _KV_BITS:
            raise ValueError(f"kv dtype {self.dtype!r} not in {sorted(_KV_BITS)}")
        if self.paged and self.block_size <= 0:
            raise ValueError("paged cache needs block_size > 0")

    @property
    def bits(self) -> int:
        return _KV_BITS[self.dtype]

    @property
    def quantized(self) -> bool:
        return self.dtype != "bf16"

    def groups(self, head_dim: int) -> int:
        g = self.group_size or head_dim
        if head_dim % g:
            raise ValueError(f"head_dim={head_dim} not divisible by group_size={g}")
        return head_dim // g

    def code_shape(self, head_dim: int) -> int:
        if self.dtype == "int4":
            if head_dim % 8:
                raise ValueError(f"head_dim={head_dim} must divide by 8 for int4")
            return head_dim // 8
        return head_dim

    @property
    def code_dtype(self):
        return {"bf16": torch.bfloat16, "int8": torch.int8,
                "int4": torch.int32}[self.dtype]

    def bytes_per_token_head(self, head_dim: int) -> float:
        """Cache bytes per (head, token) row — the decode-traffic unit."""
        if not self.quantized:
            return 2.0 * head_dim
        code = head_dim if self.dtype == "int8" else head_dim / 2
        return code + 4.0 * self.groups(head_dim)


BF16_KV = KVCacheConfig()


def quantize_kv(kv: torch.Tensor, *, bits: int = 8, group_size: int = 0):
    """(..., S, Dh) → (codes, f32 scales (..., S, Dh//g)).  int8 codes in
    [-127, 127]; int4 codes biased to [1, 15] and packed 8 per int32."""
    Dh = kv.shape[-1]
    g = group_size or Dh
    f = kv.float().reshape(*kv.shape[:-1], Dh // g, g)
    qmax = 127.0 if bits == 8 else 7.0
    s = torch.clamp(f.abs().amax(dim=-1), min=1e-8) / qmax
    q = torch.clamp(torch.round(f / s[..., None]), -qmax, qmax)
    if bits == 8:
        return q.reshape(kv.shape).to(torch.int8), s
    codes = (q.reshape(kv.shape) + 8.0).to(torch.int32)
    return pack_bits(codes, 4), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16, *,
                  bits: int = 8, group_size: int = 0) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the plain path)."""
    if bits == 8:
        codes = q.float()
    else:
        codes = unpack_bits(q, q.shape[-1] * 8, 4).float() - 8.0
    Dh = codes.shape[-1]
    g = group_size or Dh
    grouped = codes.reshape(*codes.shape[:-1], Dh // g, g)
    return (grouped * s[..., None]).reshape(codes.shape).to(dtype)


def decode_attention_q8(q, kq, ks, vq, vs, cur_pos, *, scale=None,
                        soft_cap: float = 0.0):
    """Single-token attention over an int8-quantized cache with per-token
    scales, the seed's read (the reference's ``decode_attention_q8``):
    q (B,H,1,Dh); kq/vq (B,Hkv,S,Dh) int8; ks/vs (B,Hkv,S,1) f32.  The
    k-dot contracts the int8 codes and folds the scale into the score; the
    v-scale folds into the probabilities.  The serving path's read is
    ``kernels.ops.kv_decode_attention``, which also takes int4 and grouped
    scales."""
    B, H, _, Dh = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    G = H // Hkv
    sc = scale if scale is not None else Dh ** -0.5
    qg = (q[:, :, 0].float() * sc).reshape(B, Hkv, G, Dh)
    s_ = torch.einsum("bhgd,bhkd->bhgk", qg, kq.float()) \
        * ks[:, :, None, :, 0]
    if soft_cap > 0:
        s_ = soft_cap * torch.tanh(s_ / soft_cap)
    mask = torch.arange(S, device=q.device)[None, :] <= cur_pos[:, None]
    s_ = torch.where(mask[:, None, None, :], s_,
                     torch.full_like(s_, -1e30))
    p = torch.softmax(s_, dim=-1) * vs[:, :, None, :, 0]
    o = torch.einsum("bhgk,bhkd->bhgd", p, vq.float())
    return o.reshape(B, H, 1, Dh).to(q.dtype)
