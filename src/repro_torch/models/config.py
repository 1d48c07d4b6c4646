"""Model configuration and parameter declarations (port of
``repro.models.config``).

One :class:`ModelConfig` describes every architecture of the pool, and
the port serves every family.  Parameters are declared
as trees (nested dicts) of :class:`PSpec`; :func:`init_params` turns one
into tensors, :func:`count_params` counts it without allocating.

Initialisation follows the reference's rule (normal with standard
deviation ``scale``, or 1/sqrt(fan-in) with fan-in ``shape[-2]``; zeros;
ones) but draws from a ``torch.Generator``, so its values are not the
``jax.random`` values of the same seed.  A stacked leaf (leading
``layers`` axis) is drawn one layer at a time, so the f32 transient of the
largest stage leaf is one layer's.  Tests that compare the two
packages carry the reference's weights across
(:func:`repro_torch.models.convert.params_from_reference`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # attention
    attn_type: str = "gqa"         # gqa | mla | none
    rope_theta: float = 10000.0
    rope_style: str = "standard"   # standard | 2d | mrope | none
    qkv_bias: bool = False
    causal: bool = True
    # MLA (DeepSeek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2-style: shared attention block every k SSM blocks)
    shared_attn_every: int = 0
    # encoder / multimodal stubs
    is_encoder: bool = False
    frontend_dim: int = 0          # stub modality frontend embedding width
    mtp_depth: int = 0             # DeepSeek-V3 multi-token prediction
    # numerics / memory (sharding_profile picks the rule table of
    # repro_torch.distributed.sharding; sp_activations splits the carry
    # that remat saves between a non-hybrid stage's layers along the
    # sequence over 'model', Megatron-SP: repro_torch.models.model.forward)
    sp_activations: bool = False
    sharding_profile: str = "default"
    attn_q_chunk_threshold: int = 8192  # q-chunk attention above this seq len
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    remat: str = "full"
    scan_layers: bool = True
    tie_embeddings: bool = False
    subquadratic: bool = False

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(self.n_kv_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 (the reference's sharding rule); logits
        over the padding columns are masked to -1e30 in ``lm_head``."""
        return -(-self.vocab_size // 256) * 256

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def dtype(self, which: str) -> torch.dtype:
        """``torch`` dtype of ``param``, ``compute`` or ``opt``."""
        return getattr(torch, getattr(self, which + "_dtype"))


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declares one parameter leaf: shape, logical axes, initialiser."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical names, len == len(shape)
    init: str = "normal"           # normal | zeros | ones
    scale: float | None = None     # normal stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of nested dicts (``jax.tree.map``'s
    place here: the parameter and cache trees are dicts all the way)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves of a tree of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"dotted.path": leaf}`` of a tree of nested dicts, in insertion
    order (the names ``nn.Module.state_dict`` gives the same tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a ('layers', n) axis to every PSpec (the reference's scanned
    stacks; the port counts with it and splits the reference's stacked
    leaves along it)."""
    return tree_map(lambda p: PSpec(shape=(n,) + p.shape, axes=("layers",) + p.axes,
                                    init=p.init, scale=p.scale), defs)


def _init_leaf(p: PSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "normal":
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if p.axes[:1] == ("layers",):
            # a stacked leaf layer by layer: its f32 draw is one layer's
            out = torch.empty(p.shape, dtype=dtype, device=device)
            for i in range(p.shape[0]):
                out[i] = torch.randn(p.shape[1:], generator=gen, dtype=torch.float32,
                                     device=device).mul_(std)
            return out
        draw = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=device)
        return draw.mul_(std).to(dtype)
    raise ValueError(f"unknown init {p.init!r}")


def init_params(defs: Any, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Materialise a PSpec tree into tensors on ``device``, drawing the
    normal leaves in tree order from ``gen`` (a generator on ``device``)."""
    return tree_map(lambda p: _init_leaf(p, gen, dtype, device), defs)


def abstract_params(defs: Any, dtype: torch.dtype) -> Any:
    """The tree's leaves as ``meta`` tensors (shape and dtype, no storage):
    what the dry run reasons about."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), defs)


def logical_specs(defs: Any) -> Any:
    """Tree of logical-axis tuples, mirroring the params tree."""
    return tree_map(lambda p: p.axes, defs)


def count_params(defs: Any) -> int:
    return int(sum(math.prod(p.shape) for p in tree_leaves(defs)))
