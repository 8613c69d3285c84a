"""chameleon-34b [vlm] — early-fusion; VQ image tokens share the vocab, so
the backbone consumes plain token ids (qk-norm stabilized).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]
"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab=65536,
        act="silu", mlp="glu", norm="rms", pos="rope", qk_norm=True,
        source="arXiv:2405.09818",
    )


def smoke():
    return ModelConfig(
        name="chameleon-smoke", family="vlm", n_layers=3, d_model=96,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        act="silu", mlp="glu", norm="rms", pos="rope", qk_norm=True,
    )
