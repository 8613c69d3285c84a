"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 ssm_state=128 vocab=50280
[arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ModelConfig, SSMCfg


def config():
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        norm="rms", pos="rope",
        ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=256,
                   conv_width=4, n_groups=1),
        subquadratic=True, source="arXiv:2405.21060",
    )


def smoke():
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, norm="rms",
        ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=8,
                   conv_width=4, n_groups=1),
        subquadratic=True,
    )
