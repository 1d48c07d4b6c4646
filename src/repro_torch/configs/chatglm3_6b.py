"""chatglm3-6b [dense]: GQA kv=2, 2d (partial) RoPE, qkv bias.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
[arXiv:2406.12793; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    attn_type="gqa",
    rope_style="2d",
    qkv_bias=True,
    # >=6B params: stored in bf16, as the reference stores them
    param_dtype="bfloat16",
)
