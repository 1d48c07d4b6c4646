"""deepseek-v3-671b [moe]: MLA + 256-expert MoE + multi-token prediction.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; 1 shared + 256 routed
top-8; MLA kv_lora=512 q_lora=1536; first 3 layers dense (d_ff=18432);
MTP depth 1.  [arXiv:2412.19437; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,          # qk_nope + qk_rope
    d_ff=18432,            # dense first layers
    vocab_size=129280,
    attn_type="mla",
    rope_style="standard",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp_depth=1,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    opt_dtype="bfloat16",
    sp_activations=True,
    # the reference q-chunks attention already at its training length
    attn_q_chunk_threshold=2048,
)
