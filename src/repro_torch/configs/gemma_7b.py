"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (kv=16).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf]
"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="gemma-7b", family="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
        act="gelu", mlp="glu", norm="rms", pos="rope",
        source="arXiv:2403.08295",
    )


def smoke():
    return ModelConfig(
        name="gemma-smoke", family="dense", n_layers=3, d_model=96,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        act="gelu", mlp="glu", norm="rms", pos="rope",
    )
