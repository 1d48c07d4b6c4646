"""Model assembly for training and serving (port of
``repro.models.model``), every family.

The reference stacks each stage's layers and runs them under ``lax.scan``;
here :class:`Model` is an ``nn.Module`` holding an ``nn.ModuleList`` of
blocks and loops over them.  The stages are the reference's:

  dense / encoder / vlm : [dense x L]
  moe (deepseek)        : [dense x first_dense_layers, moe x rest]
  ssm (mamba2)          : [ssm x L]
  hybrid (zamba2)       : [groups: (ssm x E, then the shared block) x G,
                           tail: ssm x (L - G E)]

with MLA attention in the moe family and the reference's
multi-token-prediction subtree (``mtp``) where ``mtp_depth`` asks for it,
which the loss reads and serving does not.  The hybrid family's shared
attention block (a dense GQA block with a gated MLP) has one set of weights,
``Model.shared_attn``, held once: :attr:`Model.plan` lists the modules in
the order they run, the shared block after every E Mamba-2 blocks of the
``groups`` stage, and each of its G invocations keeps a KV cache of its own.

Entries: ``forward`` (logits over the whole sequence, or the final-norm
hidden states), ``loss`` (the training loss: chunked cross-entropy, and
DeepSeek-V3's multi-token-prediction loss at weight 0.3 through the
carried ``mtp`` subtree), ``prefill`` (last-position logits and the
caches, padded to ``seq_cap``) and ``decode_step`` (one token; the caches
are updated in place).  The parameters are trainable; ``prefill`` and
``decode_step`` run under ``torch.no_grad()`` and record no graph.  With
``cfg.remat == "full"`` and grad enabled, every entry of ``plan`` runs
under ``torch.utils.checkpoint`` (backward recomputes it from its saved
input: the reference's per-layer ``jax.checkpoint``), and so does each
cross-entropy chunk, whose (B, chunk, vocab) f32 logits are never saved.
The hybrid's shared block sums its gradient over its G invocations.
:meth:`Model.param_tree` lays the parameters out as the reference's tree
(each stage leaf a list of the per-layer tensors).

The caches are a list with one dict per entry of ``plan``, in run order: ``{"k",
"v"}`` (GQA: a dense block or an invocation of the shared block),
``{"c_kv", "k_rope"}`` (MLA) or ``{"conv_x", "conv_B", "conv_C",
"state"}`` (Mamba-2).  For every family but the hybrid that is one dict
per block.  :attr:`Model.cache_slots` says where each sits in the
reference's cache tree (``stages/<stage>`` stacked by layer, and the
hybrid's ``shared_attn`` stacked by invocation), :meth:`Model.init_cache`
builds zero caches in that layout and :meth:`Model.reference_cache` maps a
list back onto the tree.

On a mesh (a model sharded by :mod:`repro_torch.distributed.fsdp`, run
inside :func:`~repro_torch.distributed.sharding.logical_sharding`) every
entry computes tensor parallel over ``model`` on this rank's blocks:
``forward`` and the serving entries return this rank's vocab columns of
the logits, ``loss`` takes the vocab-split cross-entropy, and the caches
are this rank's blocks (a GQA or MLA cache split along the sequence where
``model`` divides ``seq_cap``, which ``decode_step`` then needs).  With
``cfg.sp_activations`` (DeepSeek-V3's Megatron-SP residual saves) and rules
that map ``attn_q_seq`` onto ``model``, ``forward`` keeps the carry between
the entries of a non-hybrid stage as this rank's block of the sequence:
each entry gathers it at its start and cuts its output back, so remat
saves 1/m of it; a sequence that ``model`` does not divide stays whole (the
reference's divisibility fallback), and the hybrid's groups, the MTP block
and the serving entries keep it whole, as the reference's scope does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.models import blocks, layers
from repro_torch.models.config import (ModelConfig, PSpec, abstract_params, flatten,
                                       init_params, logical_specs, stack_defs, tree_map)

SHARED = "shared_attn"   # the hybrid's shared block: its parameters' and caches' key
CE_CHUNK = 1024          # sequence positions per cross-entropy chunk
MTP_WEIGHT = 0.3         # DeepSeek-V3's multi-token-prediction loss weight


@dataclasses.dataclass(frozen=True)
class StageDesc:
    name: str
    kind: str        # dense | moe | ssm | hybrid
    n_layers: int    # layers in the stage (G * E for the hybrid's groups)
    group: int = 0   # hybrid: Mamba-2 blocks per group


def sp_entries(stages) -> tuple[bool, ...]:
    """For each plan entry in run order, whether ``sp_activations`` splits
    its carry: an entry of a non-hybrid stage (the reference's
    ``_run_stage``; the hybrid's groups and its shared block run apart)."""
    out = []
    for s in stages:
        for i in range(s.n_layers):
            out.append(s.kind != "hybrid")
            if s.kind == "hybrid" and (i + 1) % s.group == 0:
                out.append(False)
    return tuple(out)


def _stages_for(cfg: ModelConfig) -> list[StageDesc]:
    if cfg.family in ("dense", "encoder", "vlm"):
        return [StageDesc("layers", "dense", cfg.n_layers)]
    if cfg.family == "moe":
        out = []
        if cfg.first_dense_layers:
            out.append(StageDesc("dense_layers", "dense", cfg.first_dense_layers))
        out.append(StageDesc("moe_layers", "moe", cfg.n_layers - cfg.first_dense_layers))
        return out
    if cfg.family == "ssm":
        return [StageDesc("layers", "ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        g = cfg.n_layers // e
        out = [StageDesc("groups", "hybrid", g * e, group=e)]
        if cfg.n_layers - g * e:
            out.append(StageDesc("tail", "ssm", cfg.n_layers - g * e))
        return out
    raise ValueError(cfg.family)


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("ssm", "hybrid"):
        return blocks.ssm_block_defs(cfg)
    return blocks.dense_block_defs(cfg, kind == "moe")


def param_defs(cfg: ModelConfig) -> dict:
    """The reference's PSpec tree for ``cfg`` (each stage's layers stacked
    under ``stages/<stage>``); ``count_params`` of it equals the reference's."""
    defs: dict[str, Any] = {"embed": layers.embed_defs(cfg)}
    defs["stages"] = {s.name: stack_defs(_block_defs(cfg, s.kind), s.n_layers)
                      for s in _stages_for(cfg)}
    if cfg.family == "hybrid":
        defs[SHARED] = blocks.dense_block_defs(cfg)
    defs["final_norm"] = layers.rmsnorm_defs(cfg.d_model)
    if layers.head_defs(cfg):
        defs["head"] = layers.head_defs(cfg)
    if cfg.mtp_depth:
        defs["mtp"] = {
            "proj": PSpec((2 * cfg.d_model, cfg.d_model), (None, "embed")),
            "ln_h": layers.rmsnorm_defs(cfg.d_model),
            "ln_e": layers.rmsnorm_defs(cfg.d_model),
            "block": blocks.dense_block_defs(cfg),
        }
    return defs


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stacked)


def _nest(flat: dict[str, Any]) -> dict:
    """``{"a.b": v}`` -> ``{"a": {"b": v}}``."""
    out: dict[str, Any] = {}
    for name, v in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _remat(fn, *args, early_stop: bool = True):
    """``fn(*args)``, recomputed in backward instead of saving its
    intermediates (the model draws no random numbers: no RNG state kept),
    under the mesh and rules of the forward (:func:`sharding.carried`).
    ``early_stop=False`` recomputes all of ``fn`` (a sharded model's entry:
    every collective of it runs again, so the count is the schedule's)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      early_stop=early_stop,
                      context_fn=lambda: (contextlib.nullcontext(), sh.carried()))


_CARRIES: list | None = None      # saved_carries()'s record while one is open


@contextlib.contextmanager
def saved_carries():
    """A context in which :meth:`Model.forward` records, for each plan entry
    it remats, the bytes of the floating tensors that the entry's
    checkpoint saves (its inputs: the carry between entries, what
    ``sp_activations`` cuts to 1/m), counted by
    ``torch.autograd.graph.saved_tensors_hooks``; yields the list."""
    global _CARRIES
    outer, _CARRIES = _CARRIES, []
    try:
        yield _CARRIES
    finally:
        _CARRIES = outer


def _remat_entry(fn, *args, early_stop: bool):
    """:func:`_remat` of one plan entry, its saved carry recorded inside
    :func:`saved_carries`."""
    if _CARRIES is None:
        return _remat(fn, *args, early_stop=early_stop)
    seen = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: (seen.append(t), t)[1],
                                                  lambda t: t):
        out = _remat(fn, *args, early_stop=early_stop)
    _CARRIES.append(sum(t.numel() * t.element_size() for t in seen if t.is_floating_point()))
    return out


class Model(nn.Module):
    """A decoder LM of any family, with its parameters.

    ``device`` defaults to the card and raises without one
    (:func:`repro_torch.device.resolve_device`); ``"meta"`` builds the
    skeleton without drawing (``cast`` fills it).  Parameters are drawn in
    the reference's tree order from a ``torch.Generator`` on ``device``
    seeded with ``seed``, in ``dtype`` (the config's ``param_dtype`` by
    default): the reference's distributions, not its ``jax.random`` values.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.stages = _stages_for(cfg)
        dtype = dtype if dtype is not None else cfg.dtype("param")
        defs = param_defs(cfg)
        if device == "meta":
            tree = tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), defs)
        else:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            tree = init_params(defs, gen, dtype, dev)
        self.embed = blocks.param_module(tree["embed"])
        self.blocks = nn.ModuleList(
            self._block(s.kind, _layer(tree["stages"][s.name], i))
            for s in self.stages for i in range(s.n_layers))
        # the hybrid's shared block: registered once, run after every E blocks
        self.shared_attn = blocks.DenseBlock(cfg, tree[SHARED]) if SHARED in tree else None
        self.final_norm = blocks.param_module(tree["final_norm"])
        self.head = blocks.param_module(tree["head"]) if "head" in tree else None
        # the multi-token-prediction module: carried, counted, not served
        self.mtp = blocks.param_module(tree["mtp"]) if "mtp" in tree else None
        plan, slots, first = [], [], 0
        for s in self.stages:
            for i in range(s.n_layers):
                plan.append(self.blocks[first + i])
                slots.append((s.name, i))
                if s.kind == "hybrid" and (i + 1) % s.group == 0:
                    plan.append(self.shared_attn)
                    slots.append((SHARED, i // s.group))
            first += s.n_layers
        # a tuple, not a ModuleList: the shared block is not registered again
        self.plan: tuple[nn.Module, ...] = tuple(plan)
        # for each entry of the plan, where its cache sits in the reference's
        # tree: (a stage's name, the layer) or ("shared_attn", the invocation)
        self.cache_slots: tuple[tuple[str, int], ...] = tuple(slots)
        self.sp_entries: tuple[bool, ...] = sp_entries(self.stages)
        # a sharded model's parameter gatherer (repro_torch.distributed.fsdp)
        self.param_source = None

    def _block(self, kind: str, tree: dict) -> nn.Module:
        if kind in ("ssm", "hybrid"):
            return blocks.SSMBlock(self.cfg, tree)
        return blocks.DenseBlock(self.cfg, tree, kind == "moe")

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def cast(self, dtype: torch.dtype) -> "Model":
        """A copy with every parameter cast to ``dtype`` (the serving copy in
        the compute dtype: the same bits as the reference's cast at each use)."""
        out = Model(self.cfg, device="meta", dtype=dtype)
        out.load_state_dict({k: v.to(dtype) for k, v in self.state_dict().items()},
                            assign=True)
        return out

    # -- input embedding --------------------------------------------------------
    def embed_input(self, batch: dict):
        """(x (B, S, d) in the compute dtype, positions) for a batch of
        ``tokens``, audio ``frames`` (the hubert stub) or ``tokens`` with
        ``vision_embeds`` spliced ahead and (3, B, S) M-RoPE ``positions``."""
        cfg = self.cfg
        cd = cfg.dtype("compute")
        if "frames" in batch:                     # audio stub frontend
            x = torch.matmul(batch["frames"].to(cd), self.embed["frontend_proj"].to(cd))
            positions = self._positions(x)
        elif "vision_embeds" in batch:            # VLM stub frontend
            tok = layers.embed(batch["tokens"], self.embed, cfg)
            vis = torch.matmul(batch["vision_embeds"].to(cd),
                               self.embed["frontend_proj"].to(cd))
            x = torch.cat([vis, tok[:, vis.shape[1]:]], dim=1)
            positions = batch["positions"]
        else:
            x = layers.embed(batch["tokens"], self.embed, cfg)
            positions = self._positions(x)
        return constrain(x.to(cd), ("batch", "seq", "embed")), positions

    @staticmethod
    def _positions(x):
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def logits(self, x):
        """The final norm and the head: logits (..., vocab_padded) of hidden x."""
        x = layers.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return layers.lm_head(x, self.head, self.embed, self.cfg)

    # -- forward and loss -------------------------------------------------------
    def forward(self, batch: dict, return_hidden: bool = False):
        """Logits (B, S, vocab_padded) over the whole sequence, or with
        ``return_hidden`` the final norm's output (B, S, d)."""
        x, positions = self.embed_input(batch)
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        sp = self._sp_mesh(x.shape[1])
        blocked = False
        for i in range(len(self.plan)):
            if sp is not None and self.sp_entries[i] != blocked:
                # entering (leaving) a run of sequence-parallel entries
                cut = collectives.gather_along if blocked else collectives.slice_along
                x = cut(x, sp, ("model",), dim=1)
                blocked = not blocked
            run = self._sp_entry if blocked else self._entry
            x = (_remat_entry(run, i, x, positions, early_stop=self.param_source is None)
                 if remat else run(i, x, positions))
        if blocked:
            x = collectives.gather_along(x, sp, ("model",), dim=1)
        if return_hidden:
            return layers.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x)

    def _entry(self, i: int, x, positions):
        """Plan entry ``i`` on ``x``; with a ``param_source`` (a sharded
        model, :mod:`repro_torch.distributed.fsdp`) its parameters are
        gathered around the call (over every axis of their spec but a
        tensor-parallel leaf's ``model``), again in the recompute under
        remat."""
        block = self.plan[i]
        if self.param_source is None:
            return block(x, positions)
        with self.param_source.entry(block):
            return block(x, positions)

    def _sp_mesh(self, seq: int):
        """The mesh where ``cfg.sp_activations`` splits the carry between
        plan entries along the sequence (Megatron-SP: the rules map
        ``attn_q_seq`` onto ``model``, which divides ``seq``), else None."""
        mesh = sh.current_mesh()
        if (not self.cfg.sp_activations or mesh is None
                or sh.tp_ways(mesh, sh.current_rules(), "attn_q_seq", seq) == 1):
            return None
        return mesh

    def _sp_entry(self, i: int, x, positions):
        """Plan entry ``i`` on this rank's sequence block ``x``: the block
        gathered whole over ``model`` at its start (under remat, again in
        the recompute), the output cut back to this rank's block, which is
        what remat saves between entries (the reference's carry constraint
        ``("batch", "attn_q_seq", "embed")``)."""
        mesh = sh.current_mesh()
        x = self._entry(i, collectives.gather_along(x, mesh, ("model",), dim=1), positions)
        return constrain(collectives.slice_along(x, mesh, ("model",), dim=1),
                         ("batch", "attn_q_seq", "embed"), {"attn_q_seq": x.shape[1]})

    def _chunk_ce(self, hs, labels):
        """Summed cross-entropy of one chunk: f32 logsumexp of the compute
        dtype's logits less the gold logit.  With a vocab-split head each
        rank holds its columns: the row maximum is exact over ``model``, the
        sums of exponentials fold in rank order, and the gold logit is the
        owning rank's."""
        logits = layers.lm_head(hs, self.head, self.embed, self.cfg).float()
        n = logits.shape[-1]
        if n == self.cfg.vocab_padded:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
            return torch.sum(lse - gold)
        mesh, _, r = layers.model_axis()
        top = logits.detach().amax(dim=-1)
        for part in collectives.all_gather_axes(top, mesh, ("model",)):
            top = torch.maximum(top, part)
        se = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
        lse = top + torch.log(collectives.tp_reduce(se, mesh))
        local = labels.long() - r * n
        hit = (local >= 0) & (local < n)
        gold = torch.take_along_dim(logits, local.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
        gold = collectives.tp_reduce(gold.masked_fill(~hit, 0.0), mesh)
        return torch.sum(lse - gold)

    def _ce_chunked(self, hidden, labels, shift: int):
        """Mean cross-entropy over the predicted positions, in sequence
        chunks of ``CE_CHUNK`` and a shorter tail.  shift=1: next-token LM;
        shift=0: same-position (encoder) prediction."""
        b = hidden.shape[0]
        if shift:
            hidden = hidden[:, :-shift]
            labels = labels[:, shift:]
        t = hidden.shape[1]
        chunk = min(CE_CHUNK, t)
        remat = torch.is_grad_enabled()
        whole = self.param_source is None
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for lo in range(0, t, chunk):              # the last chunk is the tail
            hs, ls = hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk]
            total = total + (_remat(self._chunk_ce, hs, ls, early_stop=whole) if remat
                             else self._chunk_ce(hs, ls))
        return total / (b * t)

    def loss(self, batch: dict):
        """The training loss and its metrics ``{"ce", ["mtp",] "loss"}``."""
        cfg = self.cfg
        hidden = self.forward(batch, return_hidden=True)
        shift = 0 if cfg.is_encoder else 1
        loss = self._ce_chunked(hidden, batch["labels"], shift)
        metrics = {"ce": loss}
        if cfg.mtp_depth and "tokens" in batch:
            mp = self.mtp
            cd = cfg.dtype("compute")
            h = layers.rmsnorm(hidden[:, :-1], mp["ln_h"], cfg.norm_eps)
            e = layers.embed(batch["tokens"][:, 1:], self.embed, cfg)
            e = layers.rmsnorm(e, mp["ln_e"], cfg.norm_eps)
            x = torch.matmul(torch.cat([h, e], dim=-1), mp["proj"].to(cd))
            x = blocks.dense_block(x, mp["block"], cfg, self._positions(x))
            mtp_loss = self._ce_chunked(x, batch["labels"][:, 1:], 1)
            metrics["mtp"] = mtp_loss
            loss = loss + MTP_WEIGHT * mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def param_defs(self) -> dict:
        return param_defs(self.cfg)

    def abstract(self, dtype: torch.dtype | None = None) -> dict:
        """The reference's parameter tree as ``meta`` tensors (stacked stage
        leaves), in ``dtype`` (the config's ``param_dtype`` by default)."""
        return abstract_params(param_defs(self.cfg),
                               dtype if dtype is not None else self.cfg.dtype("param"))

    def specs(self) -> dict:
        """The logical axes of every leaf of :meth:`abstract`."""
        return logical_specs(param_defs(self.cfg))

    def abstract_cache(self, batch: int, seq_cap: int) -> dict:
        return abstract_params(self.cache_defs(batch, seq_cap), self.cfg.dtype("compute"))

    def cache_specs(self, batch: int, seq_cap: int) -> dict:
        return logical_specs(self.cache_defs(batch, seq_cap))

    def param_tree(self) -> dict:
        """The parameters as the reference's tree (``embed``, ``stages/<stage>``,
        ``shared_attn``, ``final_norm``, ``head``, ``mtp``): the module's own
        tensors, no copies, each stage leaf a list of its layers' tensors
        (the reference stacks them along a leading ``layers`` axis).  A
        stage of no layers (deepseek-v3 cut to its dense layers) has no
        tensor to list: each of its leaves is :meth:`_empty_stack`'s."""
        named = dict(self.named_parameters())
        flat: dict[str, Any] = {}
        first = 0
        for s in self.stages:
            for path, spec in flatten(_block_defs(self.cfg, s.kind)).items():
                flat[f"stages.{s.name}.{path}"] = (
                    [named[f"blocks.{first + i}.{path}"] for i in range(s.n_layers)]
                    if s.n_layers else self._empty_stack(spec))
            first += s.n_layers
        flat.update({k: p for k, p in named.items() if not k.startswith("blocks.")})
        return _nest(flat)

    def _empty_stack(self, spec: PSpec) -> nn.Parameter:
        """The leaf of a stage of no layers: a parameter of the reference's
        shape ``(0, *spec.shape)`` (this rank's block of it on a sharded
        model) in the model's dtype, its gradient an empty tensor, so the
        optimizer, the clip and the checkpoint treat it as any tensor leaf.
        The per-layer shape comes from ``spec``, since no layer holds one."""
        shape = (0,) + spec.shape
        src = self.param_source
        if src is not None:
            axes = ("layers",) + spec.axes
            shape = sh.shard_shape(shape, sh.logical_to_spec(shape, axes, src.mesh, src.rules,
                                                             param_retry=True), src.mesh)
        like = self.final_norm["scale"]
        leaf = nn.Parameter(torch.zeros(shape, dtype=like.dtype, device=like.device))
        leaf.grad = torch.zeros_like(leaf)
        return leaf

    # -- serving -------------------------------------------------------------------
    def cache_defs(self, batch: int, seq_cap: int) -> dict:
        """The reference's cache tree: each stage's layers stacked under
        ``stages``, the hybrid's G shared-block caches under ``shared_attn``."""
        cfg = self.cfg
        out = {"stages": {s.name: stack_defs(
            blocks.ssm_cache_defs(cfg, batch) if s.kind in ("ssm", "hybrid")
            else blocks.dense_cache_defs(cfg, batch, seq_cap), s.n_layers)
            for s in self.stages}}
        n_shared = sum(key == SHARED for key, _ in self.cache_slots)
        if n_shared:
            out[SHARED] = stack_defs(blocks.dense_cache_defs(cfg, batch, seq_cap), n_shared)
        return out

    def init_cache(self, batch: int, seq_cap: int) -> list[dict]:
        """Zero caches in the compute dtype, one dict per entry of ``plan``;
        under a mesh (:func:`~repro_torch.distributed.sharding.logical_sharding`)
        this rank's blocks of the caches of a global ``batch``."""
        cd, dev = self.cfg.dtype("compute"), self.device
        mesh = sh.current_mesh()

        def zeros(p):
            shape = p.shape
            if mesh is not None:
                spec = sh.logical_to_spec(shape, p.axes, mesh, sh.current_rules())
                shape = sh.shard_shape(shape, spec, mesh)
            return torch.zeros(shape, dtype=cd, device=dev)
        stacked = tree_map(zeros, self.cache_defs(batch, seq_cap))
        return [_layer(stacked[SHARED] if key == SHARED else stacked["stages"][key], i)
                for key, i in self.cache_slots]

    def reference_cache(self, caches: list[dict]) -> dict:
        """``caches`` as the reference's tree (each leaf stacked along a
        leading layer or invocation axis, as :meth:`cache_defs` lays out)."""
        if len(caches) != len(self.cache_slots):
            raise ValueError(f"{len(caches)} caches for a plan of {len(self.cache_slots)}")
        by_key: dict[str, list[dict]] = {}
        for (key, _), cache in zip(self.cache_slots, caches):
            by_key.setdefault(key, []).append(cache)
        stacked = {key: {name: torch.stack([c[name] for c in group])
                         for name in group[0]} for key, group in by_key.items()}
        out: dict[str, Any] = {"stages": {s.name: stacked[s.name] for s in self.stages}}
        if SHARED in stacked:
            out[SHARED] = stacked[SHARED]
        return out

    def _top(self):
        """The serving entries' embedding, final norm and head, gathered
        around their use on a sharded model (:mod:`repro_torch.distributed.fsdp`)."""
        if self.param_source is None:
            return contextlib.nullcontext()
        return self.param_source.top(serving=True)

    def _params_of(self, block):
        if self.param_source is None:
            return contextlib.nullcontext()
        return self.param_source.entry(block)

    @torch.no_grad()
    def prefill(self, batch: dict, seq_cap: int):
        """Full-sequence forward building the caches.

        Returns (last-position logits (B, vocab_padded), caches); under a
        mesh this rank's rows, vocab columns and cache blocks."""
        with self._top():
            x, positions = self.embed_input(batch)
            caches = []
            for block in self.plan:
                with self._params_of(block):
                    x, cache = block.prefill(x, positions, seq_cap)
                caches.append(cache)
            return self.logits(x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches: list[dict], tokens, pos: int, seq_cap: int | None = None):
        """One decode step. tokens: (B, 1) integers; pos: their position;
        ``seq_cap``: the caches' whole length (their own on one device; a
        mesh, where a cache may rest split along it, needs it).

        Returns (logits (B, vocab_padded), caches), updated in place."""
        if seq_cap is None and sh.current_mesh() is not None:
            raise ValueError("decode_step on a mesh needs the caches' seq_cap")
        with self._top():
            x = layers.embed(tokens, self.embed, self.cfg)
            for block, cache in zip(self.plan, caches, strict=True):
                with self._params_of(block):
                    x, _ = block.decode(x, cache, pos, seq_cap)
            return self.logits(x)[:, 0], caches
