"""qwen2.5-32b [dense]: GQA kv=8 with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
[hf:Qwen/Qwen2.5-0.5B family; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attn_type="gqa",
    rope_style="standard",
    qkv_bias=True,
    rope_theta=1000000.0,
    # >=6B params: stored in bf16, as the reference stores them
    param_dtype="bfloat16",
)
