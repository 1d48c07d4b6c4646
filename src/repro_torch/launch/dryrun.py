"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x shape
x mesh) cell derived on the production meshes with no ranks.

For each runnable cell (``cell_status``) on 16 x 16 ``(data, model)`` and
2 x 16 x 16 ``(pod, data, model)`` it writes one record holding

  1. the per-device argument and output bytes of the train, prefill or
     decode step, from each leaf's block under the reference's specs
     (:mod:`repro_torch.distributed.sharding` on an ``AbstractMesh``);
  2. ``model_flops_estimate``, the reference's;
  3. the collectives of one step by kind (count, bytes: the result's bytes,
     HLO's convention), derived from the port's own schedule: each leaf's
     gather over the axes of its spec but the ``model`` axis of a
     tensor-parallel leaf (:func:`repro_torch.distributed.fsdp.leaf_role`),
     at every plan entry's forward (again in the backward's recompute under
     remat) and around the top-level leaves, the gradient's reduce-scatter,
     tensor parallelism's all-reduces (g forward, f backward, both again in
     the recompute), the q-group case's head relayouts, the q-sequence
     case's row gathers or head-to-row relayouts (context parallelism),
     ``sp_activations``' per-entry gathers of the sequence block and the
     gathers of its cut's gradient, the vocab-parallel
     cross-entropy's reductions, the expert-parallel all-to-alls and token
     gathers, the metrics' and the clip's scalar gathers, and the
     optimizer's whole-leaf gathers where it is Adafactor.  A serving step
     gathers its leaves at their use too, and adds the prefill's K/V
     reshard, the decode step's head gathers and flash-decoding merges, and
     the greedy pick over the vocab shards.

The paper's workload rides along as the pseudo-arch ``zmc_multifunctions``
(10k integrands x 1M samples, functions over ``model``).  A record carries
no temp bytes: nothing is compiled, so there is no buffer assignment to
read (``"temp_bytes": null``).  ``parse_collectives`` / ``_shape_bytes``
stay as text functions over HLO text.

Usage:
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --multi-pod
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback
from types import SimpleNamespace

import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_status
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.launch.specs import batch_logical_axes, input_specs
from repro_torch.launch.train import (TrainHParams, abstract_train_state,
                                      default_hparams_for, train_state_specs)
from repro_torch.models import decode as dec
from repro_torch.models import layers, moe
from repro_torch.models.config import count_params
from repro_torch.models.model import Model, _stages_for, param_defs, sp_entries

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}

PRODUCTION_MESHES = {
    "pod16x16": sh.AbstractMesh(("data", "model"), (16, 16)),
    "pod2x16x16": sh.AbstractMesh(("pod", "data", "model"), (2, 16, 16)),
}


def _shape_bytes(type_str: str) -> int:
    """bytes of one HLO result type like 'bf16[8,4096,7168]' or a tuple."""
    total = 0
    for m in re.finditer(r"(\w+)\[([0-9,]*)\]", type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Sum result bytes per collective kind from optimized HLO."""
    out = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        if line.startswith("ROOT "):
            line = line[5:]
        m = re.match(r"%?\S+\s*=\s*(\([^)]*\)|\S+)\s+([a-z0-9-]+)", line)
        if not m:
            continue
        op = m.group(2)
        for kind in _COLLECTIVES:
            if op == kind or op == kind + "-start":
                out[kind]["count"] += 1
                out[kind]["bytes"] += _shape_bytes(m.group(1))
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return out


def model_flops_estimate(cfg, shape) -> dict:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    defs = param_defs(cfg)
    n_total = count_params(defs)
    n_active = n_total
    if cfg.n_experts and cfg.top_k:
        # routed experts: only top_k of n_experts are active per token
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        routed = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * n_moe_layers
        n_active = n_total - routed + routed * cfg.top_k / cfg.n_experts
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        tokens = shape.global_batch
    flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    return {"n_params": float(n_total), "n_active": float(n_active),
            "tokens": float(tokens), "model_flops": float(flops)}


# ---------------------------------------------------------------------------
# Per-device bytes from the specs
# ---------------------------------------------------------------------------

def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tree_bytes(abstract, spec_tree, mesh, rules) -> int:
    """Per-device bytes of an abstract tree's blocks under its specs."""
    shardings = sh.tree_shardings(abstract, spec_tree, mesh, rules)
    total = 0

    def walk(a, s):
        nonlocal total
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
            return
        total += math.prod(s.shard_shape(tuple(a.shape))) * _itemsize(a.dtype)
    walk(abstract, shardings)
    return total


def _structs(specs: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in specs.items()}


def cell_bytes(cfg, shape: ShapeSpec, mesh, hp: TrainHParams | None = None) -> dict:
    """Per-device argument and output bytes of the cell's step."""
    rules = sh.rules_for(cfg)
    batch = _structs(input_specs(cfg, shape))
    b_axes = batch_logical_axes(cfg, shape)
    if shape.kind == "train":
        model = Model(cfg, device="meta")
        hp = hp or default_hparams_for(cfg)
        state = tree_bytes(abstract_train_state(model, hp), train_state_specs(model, hp),
                           mesh, rules)
        n_metrics = 3 if cfg.mtp_depth else 2
        args = state + tree_bytes(batch, b_axes, mesh, rules)
        out = state + 4 * (n_metrics + 1)
        return {"argument_bytes": args, "output_bytes": out, "state_bytes": state}
    model = Model(cfg, device="meta")
    params = tree_bytes(model.abstract(), model.specs(), mesh, rules)
    cache = tree_bytes(model.abstract_cache(shape.global_batch, shape.seq_len),
                       model.cache_specs(shape.global_batch, shape.seq_len), mesh, rules)
    cd = _itemsize(cfg.dtype("compute"))
    rows = shape.global_batch // _n_batch(mesh, rules, shape.global_batch, 1)
    logits = rows * cfg.vocab_padded * cd
    if shape.kind == "prefill":
        args = params + tree_bytes(batch, b_axes, mesh, rules)
    else:
        args = params + cache + tree_bytes({"tokens": batch["tokens"]},
                                           {"tokens": b_axes["tokens"]}, mesh, rules) + 4
    return {"argument_bytes": args, "output_bytes": logits + cache, "params_bytes": params,
            "cache_bytes": cache}


def _n_batch(mesh, rules, rows, seq) -> int:
    sizes = sh.mesh_axes(mesh)
    return math.prod(sizes[a] for a in fsdp.batch_axes(mesh, rules, rows, seq))


# ---------------------------------------------------------------------------
# Collectives of one step, from the port's schedule
# ---------------------------------------------------------------------------

def _empty() -> dict:
    return {k: {"count": 0, "bytes": 0} for k in
            ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")}


def _add(out: dict, kind: str, nbytes: int, times: int = 1) -> None:
    out[kind]["count"] += times
    out[kind]["bytes"] += nbytes * times


def _add_all(out: dict, parts, times: int = 1) -> None:
    for kind, nbytes in parts:
        _add(out, kind, nbytes, times)


def _tp(mesh, rules, logical: str, dim: int) -> bool:
    return sh.tp_ways(mesh, rules, logical, dim) > 1


def _attn_mode(cfg, mesh, rules) -> str | None:
    kv = cfg.n_heads if cfg.attn_type == "mla" else cfg.n_kv_heads
    return layers.attn_mode(mesh, rules, cfg.n_heads, kv)


def _qseq_parts(cfg, mesh, mode: str, rows: int, seq: int) -> tuple[list, list]:
    """(forward, backward) collectives of attention's q-sequence case over
    ``rows`` local rows of ``seq`` positions: the rows' output gathered
    before a whole ``wo`` (heads whole), or q relaid out from head blocks to
    row blocks and the output back (heads split), each gather's gradient
    relaid out back in backward; f's all-reduce of x's gradient (and g's
    forward, with the heads split) are :func:`entry_parts`'."""
    m = sh.mesh_axes(mesh)["model"]
    c = _itemsize(cfg.dtype("compute"))
    chunks = layers.cp_chunks(seq, m, min(layers.Q_CHUNK_THRESHOLD, cfg.attn_q_chunk_threshold))
    s_pad = sum(n for _, n in chunks)
    mla = cfg.attn_type == "mla"
    dq = cfg.qk_nope_dim + cfg.qk_rope_dim if mla else cfg.head_dim
    dv = cfg.v_head_dim if mla else cfg.head_dim
    o = ("all-gather", rows * s_pad * cfg.n_heads * dv * c)
    if mode == "qseq":
        return [o], []
    q = ("all-gather", rows * s_pad * cfg.n_heads * dq * c)
    return [q, o], [o, q]


def entry_parts(cfg, mesh, kind: str, rows: int, seq: int,
                decode: bool = False) -> tuple[list, list]:
    """(forward, backward) collectives of tensor parallelism in one plan
    entry of ``kind`` (dense, moe, ssm, hybrid; the MoE island apart) over
    ``rows`` local rows of ``seq`` positions: (kind, bytes) pairs.  A
    ``decode`` step's attention has no head relayouts or row gathers
    (:func:`decode_attn_parts`)."""
    rules = sh.rules_for(cfg)
    c = _itemsize(cfg.dtype("compute"))
    tokens = rows * seq
    x = tokens * cfg.d_model * c
    fwd, bwd = [], []
    if kind in ("ssm", "hybrid"):
        if _tp(mesh, rules, "mlp", cfg.ssm_d_inner) and _tp(mesh, rules, "ssm_heads",
                                                              cfg.ssm_heads):
            fwd += [("all-reduce", tokens * 4), ("all-reduce", x)]
            bwd += [("all-reduce", x), ("all-reduce", tokens * 4)]
        return fwd, bwd
    mode = _attn_mode(cfg, mesh, rules)
    if mode in ("kv", "qgroup", "qseq_heads"):
        fwd.append(("all-reduce", x))
        bwd.append(("all-reduce", x))
    elif mode == "qseq":
        bwd.append(("all-reduce", x))
    if mode == "qgroup" and not decode:
        q = tokens * cfg.n_heads * cfg.head_dim * c
        fwd += [("all-gather", q)] * 2
        bwd += [("all-gather", q)] * 2
    if mode in ("qseq", "qseq_heads") and not decode:
        f, b = _qseq_parts(cfg, mesh, mode, rows, seq)
        fwd += f
        bwd += b
    if kind == "moe":
        width, logical = cfg.n_shared_experts * cfg.moe_d_ff, "shared_mlp"
    else:
        width, logical = cfg.d_ff, "mlp"
    if width and _tp(mesh, rules, logical, width):
        fwd.append(("all-reduce", x))
        bwd.append(("all-reduce", x))
    return fwd, bwd


def sp_parts(cfg, mesh, stages, rows: int, seq: int, remat: bool) -> list:
    """The collectives of ``sp_activations`` in one microbatch's forward and
    backward over ``rows`` local rows: each plan entry whose carry it
    splits (:func:`repro_torch.models.model.sp_entries`) gathers its
    sequence block (again in the recompute under remat) and its output's
    cut gathers the gradient; a run of such entries is cut at its start
    (the gradient gathered) and gathered at its end.  None where the carry
    stays whole."""
    rules = sh.rules_for(cfg)
    if not cfg.sp_activations or not _tp(mesh, rules, "attn_q_seq", seq):
        return []
    x = ("all-gather", rows * seq * cfg.d_model * _itemsize(cfg.dtype("compute")))
    out, blocked = [], False
    for on in sp_entries(stages):
        if on != blocked:
            out.append(x)               # the run's cut (backward) or gather
            blocked = on
        if on:
            out += [x] * (3 if remat else 2)
    return out + [x] if blocked else out


def ce_parts(cfg, mesh, rows: int, t: int) -> tuple[list, list]:
    """(forward, backward) collectives of the vocab-parallel cross-entropy
    over ``rows`` x ``t`` predicted positions in chunks of ``CE_CHUNK``:
    the row maximum's gather and two sums forward, f's all-reduce of the
    hidden states backward."""
    from repro_torch.models.model import CE_CHUNK
    rules = sh.rules_for(cfg)
    if not _tp(mesh, rules, "vocab", cfg.vocab_padded):
        return [], []
    m = sh.mesh_axes(mesh)["model"]
    c = _itemsize(cfg.dtype("compute"))
    chunk = min(CE_CHUNK, t)
    fwd, bwd = [], []
    for lo in range(0, t, chunk):
        n = rows * min(chunk, t - lo)
        fwd += [("all-gather", n * 4 * m), ("all-reduce", n * 4), ("all-reduce", n * 4)]
        bwd.append(("all-reduce", n * cfg.d_model * c))
    return fwd, bwd


def embed_parts(cfg, mesh, tokens: int) -> list:
    """The vocab-split embedding's g over ``tokens`` local tokens (none for
    an audio frontend, which embeds no tokens)."""
    if (cfg.is_encoder and cfg.frontend_dim) or not _tp(mesh, sh.rules_for(cfg), "vocab",
                                                        cfg.vocab_padded):
        return []
    return [("all-reduce", tokens * cfg.d_model * _itemsize(cfg.dtype("compute")))]


def _entries(stages) -> list[tuple[str, str]]:
    """(parameter prefix, kind) of every plan entry in run order."""
    out, first = [], 0
    for s in stages:
        for i in range(s.n_layers):
            out.append((f"blocks.{first + i}.", s.kind))
            if s.kind == "hybrid" and (i + 1) % s.group == 0:
                out.append(("shared_attn.", "dense"))
        first += s.n_layers
    return out


def leaf_axes(cfg, mesh, rules, layout, name, b_axes) -> tuple[list, list]:
    """(gather axes, sum axes) of one parameter leaf (of more than one rank)."""
    sizes = sh.mesh_axes(mesh)
    shape, spec = layout[name]
    gather = [a for a in sh.sharded_axes(spec) if sizes[a] > 1]
    sums = list(b_axes)
    role = fsdp.leaf_role(cfg, mesh, rules, name)
    if role == "local":
        gather = [a for a in gather if a != "model"]
    elif role == "partial" and sizes.get("model", 1) > 1:
        sums = sums + ["model"]
    return gather, sums


def moe_layer_collectives(cfg, mesh, tokens: int) -> dict:
    """One forward of the expert-parallel island over ``tokens`` local
    tokens: the two all-to-alls of every dispatch chunk and the token
    gather over ``model``; nothing without expert parallelism."""
    out = _empty()
    ep = moe.expert_parallel_degree(cfg, mesh)
    if ep == 1:
        return out
    cd = _itemsize(cfg.dtype("compute"))
    t_pad = -(-tokens // ep) * ep
    t_m = t_pad // ep
    chunks = [t_m] if t_m <= moe.MOE_CHUNK else [moe.MOE_CHUNK] * -(-t_m // moe.MOE_CHUNK)
    for t in chunks:
        _add(out, "all-to-all", cfg.n_experts * moe.capacity(t, cfg) * cfg.d_model * cd, 2)
    _add(out, "all-gather", t_pad * cfg.d_model * cd)
    return out


def _merge(a: dict, b: dict, times: int = 1) -> None:
    for k, v in b.items():
        a[k]["count"] += v["count"] * times
        a[k]["bytes"] += v["bytes"] * times


def train_collectives(cfg, hp: TrainHParams, mesh, rows: int, seq: int) -> dict:
    """The collectives of one train step on a global batch of ``rows`` x
    ``seq`` (see the module docstring), with the totals."""
    rules = sh.rules_for(cfg)
    sizes = sh.mesh_axes(mesh)
    world = math.prod(sizes.values())
    stages = _stages_for(cfg)
    layout = fsdp.param_layout(SimpleNamespace(cfg=cfg, stages=stages), mesh, rules)
    isz = _itemsize(cfg.dtype("param"))
    mb = rows // hp.grad_accum
    b_axes = tuple(a for a in fsdp.batch_axes(mesh, rules, mb, seq) if sizes[a] > 1)
    n_b = math.prod(sizes[a] for a in b_axes)

    remat = cfg.remat == "full"
    out = _empty()

    def use(name, regather: bool):
        shape, spec = layout[name]
        gather, sums = leaf_axes(cfg, mesh, rules, layout, name, b_axes)
        shard = math.prod(shape) * isz // math.prod(
            sizes[a] for a in sh.sharded_axes(spec) if sizes[a] > 1)
        if gather:
            _add(out, "all-gather", shard * math.prod(sizes[a] for a in gather),
                 2 if regather else 1)
        if sums:
            _add(out, "reduce-scatter", shard)

    top = [n for n in layout if not n.startswith(("blocks.", "shared_attn."))]
    b = mb // n_b
    tokens = b * seq
    island = moe_layer_collectives(cfg, mesh, tokens)
    shift = 0 if cfg.is_encoder else 1
    for _ in range(hp.grad_accum):
        for n in top:
            use(n, False)
        _add_all(out, embed_parts(cfg, mesh, tokens))
        _add_all(out, sp_parts(cfg, mesh, stages, b, seq, remat))
        for prefix, kind in _entries(stages):
            for n in layout:
                if n.startswith(prefix):
                    use(n, remat)
            fwd, bwd = entry_parts(cfg, mesh, kind, b, seq)
            _add_all(out, fwd, 2 if remat else 1)
            _add_all(out, bwd)
            if kind == "moe":
                # forward, recompute under remat, backward (the reverse
                # all-to-alls and the token slice's gather)
                _merge(out, island, 3 if remat else 2)
        # the loss's chunks, each recomputed in backward
        fwd, bwd = ce_parts(cfg, mesh, b, seq - shift)
        _add_all(out, fwd, 2)
        _add_all(out, bwd)
        if cfg.mtp_depth and cfg.family != "encoder":
            _add_all(out, embed_parts(cfg, mesh, b * (seq - 1)))
            fwd, bwd = entry_parts(cfg, mesh, "dense", b, seq - 1)
            _add_all(out, fwd)
            _add_all(out, bwd)
            fwd, bwd = ce_parts(cfg, mesh, b, seq - 2)
            _add_all(out, fwd, 2)
            _add_all(out, bwd)
    if n_b > 1:
        _add(out, "all-gather", 4 * (3 if cfg.mtp_depth else 2) * n_b)
    if world > 1:
        _add(out, "all-gather", 4 * len(layout) * world)
    opt_spec_leaves = []
    if hp.optimizer != "adamw" or hp.grad_compression:
        model = Model(cfg, device="meta")
        abstract = abstract_train_state(model, hp)
        shard = sh.tree_shardings(abstract, train_state_specs(model, hp), mesh, rules)
        opt_spec_leaves = list(zip(_flat(abstract["opt"]), _flat(shard["opt"])))
        p_leaves = list(zip(_flat(abstract["params"]), _flat(shard["params"])))
    if hp.grad_compression:
        for a, s in p_leaves:
            axes = [x for x in sh.sharded_axes(s.spec) if sizes[x] > 1]
            if axes:
                _add(out, "all-gather", 4 * math.prod(sizes[x] for x in axes))
    if hp.optimizer != "adamw":
        # the whole-leaf update: each layer's gradient and parameter, then
        # the state leaves, gathered whole
        for n in layout:
            if [x for x in sh.sharded_axes(layout[n][1]) if sizes[x] > 1]:
                _add(out, "all-gather", math.prod(layout[n][0]) * isz, 2)
        for a, s in opt_spec_leaves:
            if [x for x in sh.sharded_axes(s.spec) if sizes[x] > 1]:
                _add(out, "all-gather", math.prod(a.shape) * _itemsize(a.dtype))
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return out


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def decode_attn_parts(cfg, mesh, rows: int, total: int, seq_cap: int) -> list:
    """One decode step's attention collectives over ``rows`` local rows of a
    global batch of ``total`` (g apart): the head gathers and the
    flash-decoding merge."""
    rules = sh.rules_for(cfg)
    mode = _attn_mode(cfg, mesh, rules)
    c = _itemsize(cfg.dtype("compute"))
    h = cfg.n_heads
    if cfg.attn_type == "mla":
        split = _seq_split(mesh, rules, total, seq_cap, (cfg.kv_lora_rank,),
                           ("batch", "cache_seq", "kv_lora"))
        per_head, width = cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank
    else:
        split = _seq_split(mesh, rules, total, seq_cap, (cfg.n_kv_heads, cfg.head_dim),
                           dec.CACHE_AXES)
        per_head, width = cfg.head_dim, cfg.head_dim
    out = []
    if mode == "kv" and split and cfg.attn_type != "mla":
        out.append(("all-gather", rows * (h + 2 * cfg.n_kv_heads) * cfg.head_dim * c))
    elif (mode == "kv" and split) or mode in ("qgroup", "qseq_heads"):
        out.append(("all-gather", rows * h * per_head * c))
    if split:
        m = sh.mesh_axes(mesh)["model"]
        out.append(("all-gather", rows * h * (width + 2) * 4 * m))
    return out


def _seq_split(mesh, rules, total, seq_cap, rest, axes) -> bool:
    """Whether a cache of a global batch of ``total`` rests split along its
    sequence over ``model``."""
    spec = sh.logical_to_spec((total, seq_cap) + tuple(rest), axes, mesh, rules)
    return len(spec) > 1 and "model" in sh.spec_axes(spec[1])


def serve_collectives(cfg, mesh, rows: int, seq: int, seq_cap: int | None = None) -> dict:
    """One prefill (``seq`` > 1) or decode step (``seq`` == 1) of the
    server on a global batch of ``rows`` with caches of ``seq_cap``
    positions (``seq`` by default), and its greedy pick: every leaf's gather
    at its use, tensor parallelism's all-reduces, the prefill's K/V
    reshard or the decode step's head gathers and merges, the MoE island
    of every MoE layer, and the argmax over the vocab shards."""
    rules = sh.rules_for(cfg)
    sizes = sh.mesh_axes(mesh)
    seq_cap = seq if seq_cap is None else seq_cap
    n_b = _n_batch(mesh, rules, rows, seq)
    b = rows // n_b
    tokens = b * seq
    c = _itemsize(cfg.dtype("compute"))
    stages = _stages_for(cfg)
    layout = fsdp.param_layout(SimpleNamespace(cfg=cfg, stages=stages), mesh, rules)
    out = _empty()
    for name, (shape, spec) in layout.items():
        if name.startswith("mtp."):
            continue
        gather, _ = leaf_axes(cfg, mesh, rules, layout, name, ())
        if gather:
            kept = [a for a in sh.sharded_axes(spec) if sizes[a] > 1 and a not in gather]
            gathered = math.prod(shape) * c // math.prod(sizes[a] for a in kept)
            times = sum(1 for p, _ in _entries(stages) if name.startswith(p)) or 1
            _add(out, "all-gather", gathered, times)
    _add_all(out, embed_parts(cfg, mesh, tokens))
    mode = _attn_mode(cfg, mesh, rules)
    for _, kind in _entries(stages):
        _add_all(out, entry_parts(cfg, mesh, kind, b, seq, decode=seq == 1)[0])
        if kind in ("ssm", "hybrid"):
            continue
        if seq == 1:
            _add_all(out, decode_attn_parts(cfg, mesh, b, rows, seq_cap))
        elif mode == "kv" and cfg.attn_type != "mla":
            if _seq_split(mesh, rules, rows, seq_cap, (cfg.n_kv_heads, cfg.head_dim),
                          dec.CACHE_AXES):
                kv_l = cfg.n_kv_heads // sizes["model"]
                _add(out, "all-to-all", 2 * b * seq_cap * kv_l * cfg.head_dim * c)
    n_moe = sum(s.n_layers for s in stages if s.kind == "moe")
    _merge(out, moe_layer_collectives(cfg, mesh, tokens), n_moe)
    if _tp(mesh, rules, "vocab", cfg.vocab_padded):
        _add(out, "all-gather", b * 2 * 4 * sizes["model"])
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return out


def zmc_record(mesh, n_fn: int = 10000, n_samples: int = 1 << 20) -> dict:
    """The paper's workload: functions over ``model``, samples over the
    other axes; the partial sums' one gather over every rank."""
    from repro_torch.core import harmonic_family
    sizes = sh.mesh_axes(mesh)
    world = math.prod(sizes.values())
    fam = harmonic_family(n_fn, 4, device="cpu")
    m = sizes["model"]
    leaves = [t for t in _tensors(fam.params)] + [fam.domains]
    args = sum(math.prod(t.shape) // m * t.element_size() for t in leaves)
    per_fn = n_fn // m
    out = _empty()
    _add(out, "all-gather", per_fn * 2 * 4 * world)
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return {"bytes": {"argument_bytes": args, "output_bytes": n_fn * 2 * 4},
            "collectives": out, "n_samples": n_samples, "n_fn": n_fn}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    key = f"{arch}__{shape_name}__{mesh_name}".replace(".", "_")
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    mesh = PRODUCTION_MESHES[mesh_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "n_chips": mesh.size, "status": "ok", "temp_bytes": None,
              "temp_note": "not derived: nothing is compiled"}
    t0 = time.perf_counter()
    try:
        if arch == "zmc_multifunctions":
            z = zmc_record(mesh)
            record["memory"] = z["bytes"]
            record["collectives"] = z["collectives"]
        else:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            record["memory"] = cell_bytes(cfg, shape, mesh)
            if shape.kind == "train":
                hp = default_hparams_for(cfg)
                record["hparams"] = {"optimizer": hp.optimizer, "grad_accum": hp.grad_accum}
                record["collectives"] = train_collectives(cfg, hp, mesh, shape.global_batch,
                                                          shape.seq_len)
            else:
                seq = shape.seq_len if shape.kind == "prefill" else 1
                record["collectives"] = serve_collectives(cfg, mesh, shape.global_batch, seq,
                                                          shape.seq_len)
            record["model"] = model_flops_estimate(cfg, shape)
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["derive_s"] = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-zmc", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for alias in ALIASES:
            cfg = get_config(alias)
            for sname, shp in SHAPES.items():
                ok, reason = cell_status(cfg, shp)
                if ok:
                    cells.append((alias, sname))
                else:
                    print(f"SKIP {alias} x {sname}: {reason}")
        cells.append(("zmc_multifunctions", "mc_10k_fns"))
    else:
        if args.arch is None:
            ap.error("--arch required unless --all")
        cells.append((args.arch, args.shape or "train_4k"))
        if args.include_zmc:
            cells.append(("zmc_multifunctions", "mc_10k_fns"))
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    failures = 0
    records = []
    for multi_pod in meshes:
        for arch, sname in cells:
            rec = run_cell(arch, sname, multi_pod, args.out, force=args.force)
            records.append(rec)
            if rec["status"] == "ok":
                mem = rec["memory"]["argument_bytes"] / 2**30
                coll = rec["collectives"]["total_bytes"] / 2**30
                print(f"OK   {arch:24s} {sname:12s} {rec['mesh']:10s} "
                      f"args/dev={mem:8.2f}GiB coll={coll:9.2f}GiB")
            else:
                failures += 1
                print(f"FAIL {arch:24s} {sname:12s} {rec['mesh']:10s} {rec['error']}")
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("all dry-run cells passed")
    return records


if __name__ == "__main__":
    main()
