"""Analytic (napkin-math) roofline terms per cell, on the H100
(``repro.launch.napkin``).

The reference computes the TPU-ideal lower bound of each (arch, shape)
cell of ``configs.cells()`` from first principles, as the cross-check of
its HLO walker; the port has no HLO and keeps the napkin alone.  Each
term's counts per device are the reference's, term for term:

decode (per step, per device):
    weights: active-param bytes at the quantized width (+ scales/zeros/dinv
             [+ low-rank]) / model_shards, read once
    cache:   KV/state bytes / shards, read once + token-write
    acts:    negligible (B tokens)
prefill: weights once + activations O(B·S·D·L) + cache write + score traffic
train:   fwd+bwd weight reads (×2) + grad write/read + ZeRO-1 opt update +
         remat boundary activations (×3 traversals of layer I/O)

compute: 2·N_active·tokens (decode/prefill; ×3 for train) + attention
         2·2·S_kv·H·hd per query token per layer (×3 train).

Only the divisors differ: the H100 SXM's dense bf16 peak, its HBM3 rate
and NVLink 4's rate per direction in place of the reference's TPU v5e
figures (``repro/launch/analysis.py``).
"""
from __future__ import annotations

from repro_torch.configs import SHAPES
from repro_torch.models.config import ModelConfig

# NVIDIA H100 Tensor Core GPU datasheet, the H100 SXM column:
H100_SXM_PEAK_FLOPS = 989e12    # BF16 Tensor Core, dense (1,979 with sparsity)
H100_SXM_HBM_BW = 3.35e12       # GPU memory bandwidth, HBM3: 3.35 TB/s
H100_SXM_NVLINK_BW = 450e9      # NVLink 4: 900 GB/s per GPU, both directions


def _cache_bytes_per_layer(cfg: ModelConfig, S: int, B: int) -> float:
    """Decode-state bytes per layer (bf16 KV / f32 recurrent states)."""
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        nh = di // s.head_dim
        return B * (nh * s.head_dim * s.d_state * 4            # h (f32)
                    + (s.conv_width - 1) * (di + 2 * s.n_groups * s.d_state)
                    * 2)
    if cfg.mla is not None:
        return B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
    kv = 2 * B * cfg.n_kv_heads * cfg.hd * 2                    # k+v bf16/tok
    if cfg.family == "hybrid":
        # pattern-average: attn layers window-capped, rec layers O(d_rnn)
        pat = cfg.hybrid.pattern
        n_attn = sum(1 for k in pat if k == "attn")
        n_rec = len(pat) - n_attn
        w = min(S, cfg.hybrid.window)
        dr = cfg.hybrid.d_rnn or cfg.d_model
        per_attn = kv * w
        per_rec = B * (dr * 4 + (cfg.hybrid.conv_width - 1) * dr * 2)
        return (n_attn * per_attn + n_rec * per_rec) / len(pat)
    return kv * S


def _attn_flops_per_qtok(cfg: ModelConfig, S_kv: int) -> float:
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        return 2 * 2 * di * s.d_state                           # h update + Ch
    H, hd = max(cfg.n_heads, 1), cfg.hd
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        frac_attn = sum(1 for k in pat if k == "attn") / len(pat)
        return frac_attn * 2 * 2 * min(S_kv, cfg.hybrid.window) * H * hd
    return 2 * 2 * S_kv * H * hd


def analytic_terms(cfg: ModelConfig, shape: str, n_chips: int,
                   bits: int = 4, group: int = 32, model_shards: int = 16,
                   data_shards: int = 16) -> dict:
    """The cell's per-device FLOPs, HBM bytes and collective bytes (the
    reference's counts) and each over the H100 SXM's rate: compute over
    the dense bf16 peak, memory over HBM, collectives over one NVLink
    direction."""
    S, B, kind = SHAPES[shape]
    N = cfg.param_count()
    Na = cfg.active_param_count()
    L = cfg.n_layers
    D = cfg.d_model

    if kind == "decode":
        toks = B
        wbytes = Na * (bits / 8 + 2 * 4 / group + 0.002)        # int + S/Z
        emb = cfg.vocab * D * 2 * (1 if cfg.tie_embeddings else 2)
        wbytes += emb                                            # fp head/embed
        mem = wbytes / model_shards + \
            L * _cache_bytes_per_layer(cfg, S, B) / min(B, data_shards) / \
            (model_shards if cfg.n_kv_heads and
             cfg.n_kv_heads % model_shards == 0 else 1)
        flops = (2 * Na * toks
                 + toks * L * _attn_flops_per_qtok(cfg, S)) / n_chips
        coll = toks * D * 2 * 2 * L / model_shards               # TP allreduce
    elif kind == "prefill":
        toks = B * S
        wbytes = N * 2 / model_shards
        acts = toks * D * 2 * 8 * L / n_chips                    # ~8 tensors/layer
        cache = L * _cache_bytes_per_layer(cfg, S, B) / n_chips
        mem = wbytes + acts + cache / n_chips
        flops = (2 * Na * toks
                 + toks * L * _attn_flops_per_qtok(cfg, S) / 2) / n_chips
        coll = toks * D * 2 * 2 * L / n_chips
    else:  # train
        toks = B * S
        weight_traffic = 3 * N * 2 / model_shards                # fwd+bwd+remat
        grads = N * 2 / model_shards * 2                         # write + read
        opt = 3 * N * 4 / (model_shards * data_shards) * 2       # m,v,master r/w
        acts = toks * D * 2 * 10 * L / n_chips
        mem = weight_traffic + grads + opt + acts
        flops = (6 * Na * toks
                 + 3 * toks * L * _attn_flops_per_qtok(cfg, S) / 2) / n_chips
        # collectives: Megatron TP activation ARs dominate —
        # fwd (2/layer) + bwd (2/layer), ~2× size on the wire, per local token
        toks_local = toks / data_shards
        act_ar = 2 * 2 * 2 * toks_local * D * 2 * L
        coll = (act_ar
                + 2 * N * 2 / model_shards                       # grad AR (bf16)
                + N * 2 / model_shards)                          # param AG (bf16)
    return {
        "t_compute_s": flops / H100_SXM_PEAK_FLOPS,
        "t_memory_s": mem / H100_SXM_HBM_BW,
        "t_collective_s": coll / H100_SXM_NVLINK_BW,
        "flops_per_device": flops,
        "bytes_per_device": mem,
        "collective_bytes_per_device": coll,
    }
