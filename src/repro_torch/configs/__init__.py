"""Architecture registry (port of ``repro.configs``): the ten configurations.

The modules are copies of the reference's data, built on the port's
:class:`~repro_torch.models.config.ModelConfig`.  ``get_config(name)``
returns the full published configuration of every name, each of which
``repro_torch.models.model.Model`` builds and serves (an encoder has no
decode step).  ``reduced(cfg)``
shrinks a configuration to a CPU-testable size *of the same family* (same
attention type and routing, only widths, depth and vocab shrink).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = (
    "zamba2_7b",
    "chatglm3_6b",
    "minitron_4b",
    "qwen2_5_32b",
    "stablelm_3b",
    "mamba2_130m",
    "deepseek_v2_lite_16b",
    "deepseek_v3_671b",
    "hubert_xlarge",
    "qwen2_vl_7b",
)

# assignment ids -> module names
ALIASES = {
    "zamba2-7b": "zamba2_7b",
    "chatglm3-6b": "chatglm3_6b",
    "minitron-4b": "minitron_4b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-3b": "stablelm_3b",
    "mamba2-130m": "mamba2_130m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-7b": "qwen2_vl_7b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family shrink for CPU smoke tests."""
    kw = dict(
        n_layers=4,
        d_model=64,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
                  head_dim=16)
        if cfg.n_kv_heads == cfg.n_heads:
            kw["n_kv_heads"] = 4
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.attn_type == "mla":
        kw.update(q_lora_rank=32 if cfg.q_lora_rank else 0, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.n_experts:
        # capacity_factor = E/k makes the reduced config dropless, so
        # decode-vs-prefill consistency tests are exact (capacity dropping
        # is load-dependent by design)
        kw.update(n_experts=8, top_k=2, moe_d_ff=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  capacity_factor=4.0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(n_layers=5, shared_attn_every=2)   # 2 groups + 1 tail
    if cfg.frontend_dim:
        kw.update(frontend_dim=32)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    return cfg.with_overrides(**kw)
