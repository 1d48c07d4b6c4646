"""zamba2-7b [hybrid]: Mamba-2 backbone + shared attention block.

81L d_model=3584 32H (kv=32 -> full MHA in the shared block) d_ff=14336
vocab=32000 ssm_state=64.  [arXiv:2411.15242; unverified]

Zamba2 applies ONE shared transformer block (attention + MLP) repeatedly —
here after every 6 Mamba-2 blocks (13 invocations + 3 tail Mamba layers),
with per-invocation KV caches during serving.  Sub-quadratic decode: the
Mamba state is O(1) and only the 13 shared-block invocations touch the long
KV cache, so `long_500k` runs for this arch.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    attn_type="gqa",
    rope_style="standard",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,     # d_inner 7168 -> 112 SSM heads
    ssm_conv_width=4,
    ssm_chunk=128,
    shared_attn_every=6,
    subquadratic=True,
    # >=6B params: stored in bf16, as the reference stores them
    param_dtype="bfloat16",
)
