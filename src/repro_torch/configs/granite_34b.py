"""granite-34b [dense] — code model, 88 layers, MQA (plain GELU MLP — a gated MLP at these dims gives 47B; the published 34B matches 2·D·F, gpt_bigcode lineage).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="granite-34b", family="dense", n_layers=88, d_model=6144,
        n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab=49152,
        act="gelu", mlp="plain", norm="layer", pos="rope",
        source="arXiv:2405.04324",
    )


def smoke():
    return ModelConfig(
        name="granite-smoke", family="dense", n_layers=4, d_model=96,
        n_heads=6, n_kv_heads=1, head_dim=16, d_ff=256, vocab=512,
        act="silu", mlp="glu", norm="rms", pos="rope",
    )
