"""whisper-medium [audio] — enc-dec; conv frontend is a stub (the spec'd
``input_specs`` provides precomputed (B, 1500, d_model) frame embeddings).

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import EncDecCfg, ModelConfig


def config():
    return ModelConfig(
        name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51865,
        act="gelu", mlp="plain", norm="layer", pos="learned",
        tie_embeddings=True, max_seq=32768,
        encdec=EncDecCfg(n_enc_layers=24, n_frames=1500),
        source="arXiv:2212.04356",
    )


def smoke():
    return ModelConfig(
        name="whisper-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        act="gelu", mlp="plain", norm="layer", pos="learned", max_seq=128,
        encdec=EncDecCfg(n_enc_layers=2, n_frames=12),
    )
