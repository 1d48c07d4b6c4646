"""deepseek-v2-lite-16b [moe]: MLA attention + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MoE 64 routed experts
top-6 + 2 shared; MLA kv_lora=512 (no q-lora on the lite model);
first layer dense (d_ff=10944).  [arXiv:2405.04434; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,          # qk_nope + qk_rope
    d_ff=10944,            # dense first layer
    vocab_size=102400,
    attn_type="mla",
    rope_style="standard",
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    # >=6B params: stored in bf16, as the reference stores them
    param_dtype="bfloat16",
)
