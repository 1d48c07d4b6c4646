"""qwen2-vl-7b [vlm]: M-RoPE backbone, dynamic-resolution vision stub.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
[arXiv:2409.12191; hf]

Only the transformer BACKBONE per the assignment: the ViT frontend is a
STUB — ``input_specs`` provides precomputed 1176-d patch embeddings plus
(3, B, S) M-RoPE position ids (temporal/height/width components); the
model projects patches to d_model and splices them ahead of the text
embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attn_type="gqa",
    rope_style="mrope",
    qkv_bias=True,
    rope_theta=1000000.0,
    frontend_dim=1176,
    # >=6B params: stored in bf16, as the reference stores them
    param_dtype="bfloat16",
)
