"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (GQA kv=1/MQA) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]
"""
from repro_torch.models.config import HybridCfg, ModelConfig


def config():
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
        n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab=256000,
        act="gelu", mlp="glu", norm="rms", pos="rope",
        hybrid=HybridCfg(pattern=("rec", "rec", "attn"), window=2048,
                         d_rnn=4096, conv_width=4),
        subquadratic=True, source="arXiv:2402.19427",
    )


def smoke():
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
        act="gelu", mlp="glu", norm="rms", pos="rope",
        hybrid=HybridCfg(pattern=("rec", "rec", "attn"), window=16, d_rnn=64,
                         conv_width=4),
        subquadratic=True,
    )
