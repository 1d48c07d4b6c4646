"""mamba2-130m [ssm]: attention-free SSD (state-space duality).

24L d_model=768 (attn-free) vocab=50280 ssm_state=128.
[arXiv:2405.21060; unverified]

O(1)-state decode -> runs the `long_500k` shape.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    rope_style="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,     # d_inner 1536 -> 24 SSM heads
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
    subquadratic=True,
    sharding_profile="small_dp",
)
