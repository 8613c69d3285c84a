"""minitron-4b [dense] — pruned nemotron (relu MLP, GQA kv=8).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679; hf]
"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="minitron-4b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
        act="relu", mlp="plain", norm="layer", pos="rope",
        source="arXiv:2407.14679",
    )


def smoke():
    return ModelConfig(
        name="minitron-smoke", family="dense", n_layers=3, d_model=96,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        act="relu", mlp="plain", norm="layer", pos="rope",
    )
