"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6
with 2 shared experts.

27L d_model=2048 16H d_ff_expert=1408 vocab=102400
[arXiv:2405.04434; hf]
"""
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg


def config():
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
        act="silu", mlp="glu", norm="rms", pos="rope",
        mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                   v_head_dim=128),
        moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                   capacity_factor=1.25),
        source="arXiv:2405.04434",
    )


def smoke():
    return ModelConfig(
        name="deepseek-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32, vocab=512,
        act="silu", mlp="glu", norm="rms", pos="rope",
        mla=MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                   v_head_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                   capacity_factor=2.0),
    )
