"""llama4-scout-17b-16e [moe] — 16 experts top-1 + shared expert, early
fusion (text backbone per spec).

48L d_model=5120 40H (GQA kv=8) d_ff_expert=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.models.config import ModelConfig, MoECfg


def config():
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        act="silu", mlp="glu", norm="rms", pos="rope",
        moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1,
                   capacity_factor=1.25),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke():
    return ModelConfig(
        name="llama4-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab=512,
        act="silu", mlp="glu", norm="rms", pos="rope",
        moe=MoECfg(n_experts=4, top_k=1, d_ff_expert=64, n_shared=1,
                   capacity_factor=2.0),
    )
