"""hubert-xlarge [audio]: encoder-only transformer backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
[arXiv:2106.07447; unverified]

The 7-layer strided conv frontend is a STUB per the assignment:
``input_specs`` provides precomputed 512-d frame embeddings; the model
projects them to d_model.  Bidirectional attention; no decode shapes.
Deviations from HuBERT (the reference's): RoPE replaces HuBERT's conv positional
embedding, gated-SiLU MLP replaces plain GELU.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    attn_type="gqa",
    rope_style="standard",
    causal=False,
    is_encoder=True,
    frontend_dim=512,
)
