"""starcoder2-15b [dense] — GQA kv=4, RoPE, plain GELU MLP.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152
[arXiv:2402.19173; hf]
"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, head_dim=128, d_ff=24576, vocab=49152,
        act="gelu", mlp="plain", norm="layer", pos="rope",
        source="arXiv:2402.19173",
    )


def smoke():
    return ModelConfig(
        name="starcoder2-smoke", family="dense", n_layers=3, d_model=96,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
        act="gelu", mlp="plain", norm="layer", pos="rope",
    )
