"""Model configuration — one dataclass covering the model families (a copy of
the reference package's config, kept here so the port imports nothing of it)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert hidden
    n_shared: int = 0             # shared experts (deepseek-style), d_ff_expert each
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """RecurrentGemma: repeating block pattern, e.g. ('rec','rec','attn')."""
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048            # local attention window
    d_rnn: int = 0                # RG-LRU width (defaults to d_model)
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """Mamba2 SSD."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int = 24
    n_frames: int = 1500          # whisper-medium encoder positions (stub frontend)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    act: str = "silu"
    mlp: str = "glu"              # glu | plain
    norm: str = "rms"             # rms | layer
    pos: str = "rope"             # rope | learned | sinusoidal
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_soft_cap: float = 0.0
    tie_embeddings: bool = True
    max_seq: int = 8192           # learned-pos table size
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    hybrid: Optional[HybridCfg] = None
    ssm: Optional[SSMCfg] = None
    encdec: Optional[EncDecCfg] = None
    dtype: str = "bfloat16"
    # notes for DESIGN/EXPERIMENTS bookkeeping
    subquadratic: bool = False    # supports long_500k
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * D
            nh = di // s.head_dim
            conv_ch = di + 2 * s.n_groups * s.d_state
            per_layer = (D * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                         + conv_ch * s.conv_width + nh * 2               # conv, A, D
                         + di * D)                                        # out_proj
            return emb + L * (per_layer + D)
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
        if self.mla is not None:
            m = self.mla
            qd = m.qk_nope_dim + m.qk_rope_dim
            attn = (D * H * qd                                    # q proj
                    + D * (m.kv_lora_rank + m.qk_rope_dim)        # kv down
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # kv up
                    + H * m.v_head_dim * D)                       # out
        mlp = 3 * D * F if self.mlp == "glu" else 2 * D * F
        if self.moe is not None:
            e = self.moe
            expert = (3 * D * e.d_ff_expert if self.mlp == "glu" else 2 * D * e.d_ff_expert)
            mlp = e.n_experts * expert + e.n_shared * expert + D * e.n_experts
        if self.family == "hybrid":
            h = self.hybrid
            dr = h.d_rnn or D
            rec = 2 * D * dr + dr * D + dr * h.conv_width + 3 * dr  # in×2, out, conv, gates+Λ
            n_rec = sum(1 for _ in range(L) if self._block_kind(_) == "rec")
            n_att = L - n_rec
            return emb + n_att * (attn + mlp + 2 * D) + n_rec * (rec + mlp + 2 * D)
        if self.family == "encdec":
            enc_l = self.encdec.n_enc_layers
            cross = attn
            return emb + L * (attn + cross + mlp + 3 * D) + enc_l * (attn + mlp + 2 * D)
        return emb + L * (attn + mlp + 2 * D)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        expert = 3 * self.d_model * e.d_ff_expert
        dense_like = dataclasses.replace(
            self, moe=None, d_ff=0)
        base = dense_like.param_count()  # attn + norms + embed (d_ff=0 → mlp=0)
        return base + self.n_layers * (e.top_k + e.n_shared) * expert

    def _block_kind(self, i: int) -> str:
        if self.family != "hybrid":
            return "attn"
        pat = self.hybrid.pattern
        return pat[i % len(pat)]
