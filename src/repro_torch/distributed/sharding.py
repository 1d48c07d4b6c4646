"""Logical-axis sharding rules, MaxText-style (port of
``repro.distributed.sharding``), and the slicing they imply.

Model code annotates parameters and activations with *logical* axis names
('batch', 'heads', 'mlp', 'experts', ...).  A rule table maps logical names
to physical mesh axes; :func:`logical_to_spec` applies the table with a
divisibility fallback (an axis that does not divide evenly is left
unsharded, e.g. chatglm3's 2 KV heads on a 16-way model axis), which is what
makes one rule table serve all ten architectures.

A spec is a plain tuple, one entry per leading dim: ``None`` (whole), an
axis name, or a tuple of axis names (the dim split over their product,
the first axis slowest), trailing ``None`` entries stripped as the
reference's ``PartitionSpec`` prints them.  A mesh is anything with
``axis_names`` and ``shape`` (a ``{name: size}`` mapping), as the
reference's tests' ``_FakeMesh``, or a ``DeviceMesh`` (:func:`mesh_axes`
reads both), so the dry run reasons about 256 and 512 chips with no ranks.

At rest every rank holds, of each leaf, the block that its mesh position
owns under the leaf's spec (:func:`shard_slices`, :func:`local_shard`;
:func:`from_shards` puts the blocks back together): jax's
``devices_indices_map`` for the same mesh and spec.

:func:`constrain` returns its input.  Under a mesh the port's model code
computes on this rank's block (tensor parallelism over ``model``, the batch
over its axes: :mod:`repro_torch.distributed.fsdp`), and :func:`constrain`
checks that the tensor is the block that :func:`logical_to_spec` gives the
whole array under the rules: every dim the rules shard (``batch``,
``heads``, ``kv_heads``, ``mlp``, ``shared_mlp``, ``vocab``,
``ssm_heads``, ``cache_seq``, ...), from the whole sizes the call site
names.  A wrong layout raises.  :func:`tp_ways` says how many ways a
logical axis splits over ``model``, from which model code and the
parameter roles of :mod:`~repro_torch.distributed.fsdp` take their local
head, width and vocab counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch

# logical axis -> physical mesh axis (or tuple of axes, or None)
#
# 'embed' -> 'data' is the FSDP axis: parameters (and their optimizer
# moments) shard 2D over (model x data), so no rank ever holds a
# model-parallel-only replica.  Activations are unaffected: their batch dim
# claims 'data' first and the used-set rule skips a second use.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": "model",      # decode KV cache: sequence sharded for flash-decode
    "cache_kv": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": "data",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "shared_mlp": "model",
    "q_lora": None,
    "kv_lora": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "frontend": None,
    "stats": None,
    # attention score sharding: q-sequence over model (context parallel)
    # when heads cannot shard (see models.layers._score_axes)
    "attn_q_seq": "model",
    "qgroup": None,
    # MC integration engine aliases
    "fn": "model",
    "sample": ("pod", "data"),
}

# Sub-1B models on a fixed 16x16 mesh: replicate the (tiny) weights and
# spread the batch over both axes instead of paying tensor-parallel
# activation traffic.  On the multi-pod mesh the batch (256) cannot cover
# 512 chips; ('data', 'model') still covers the pod and 'pod' stays pure DP.
SMALL_DP_RULES: dict[str, Any] = dict(
    DEFAULT_RULES,
    batch=[("data", "model"), ("data",), ("model",)],
    sample=[("data", "model"), ("data",), ("model",)],
    embed=None, mlp=None, vocab=None, heads=None, kv_heads=None,
    shared_mlp=None, ssm_heads=None, attn_q_seq=None, experts=None,
)

PROFILES = {"default": DEFAULT_RULES, "small_dp": SMALL_DP_RULES}

Spec = tuple   # of None | str | tuple[str, ...]


def rules_for(cfg) -> dict[str, Any]:
    """Rule table for a model config (reads ``cfg.sharding_profile``)."""
    return dict(PROFILES[getattr(cfg, "sharding_profile", "default")])


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order, for a ``DeviceMesh``
    or an object with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks (what the dry run reasons about)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, Any] = dict(DEFAULT_RULES)
        self.enabled: bool = True
        self.local_batch: int | None = None
        self.global_batch: int | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def logical_sharding(mesh, rules: dict[str, Any] | None = None):
    """Model code run inside sees ``mesh`` and ``rules``: :func:`constrain`
    checks, and the MoE feed-forward takes its expert-parallel island."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.enabled)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    _CTX.enabled = mesh is not None
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.enabled = prev


@contextlib.contextmanager
def no_constraints():
    """Disable constraints (inside an island that slices tokens itself)."""
    prev = _CTX.enabled
    _CTX.enabled = False
    try:
        yield
    finally:
        _CTX.enabled = prev


def current_mesh():
    return _CTX.mesh


def carried():
    """A context manager that re-enters the mesh, rules and batch the
    caller sees now, on whatever thread enters it (autograd runs a
    recompute under remat on its own thread on the card)."""
    state = (_CTX.mesh, _CTX.rules, _CTX.enabled, _CTX.local_batch, _CTX.global_batch)

    @contextlib.contextmanager
    def enter():
        prev = (_CTX.mesh, _CTX.rules, _CTX.enabled, _CTX.local_batch, _CTX.global_batch)
        (_CTX.mesh, _CTX.rules, _CTX.enabled, _CTX.local_batch, _CTX.global_batch) = state
        try:
            yield
        finally:
            (_CTX.mesh, _CTX.rules, _CTX.enabled, _CTX.local_batch, _CTX.global_batch) = prev
    return enter()


def _candidates(logical: str | None, mesh, rules) -> list[tuple[str, ...]]:
    """Candidate physical mappings for a logical axis, in preference order.

    A rule value may be a str, a tuple (one multi-axis mapping), or a LIST
    of str/tuple alternatives tried until one divides the dimension (e.g.
    small_dp batch: [('data','model'), 'data'])."""
    if logical is None:
        return []
    phys = rules.get(logical, None)
    if phys is None:
        return []
    names = tuple(mesh_axes(mesh))
    out = []
    for alt in phys if isinstance(phys, list) else [phys]:
        if isinstance(alt, str):
            alt = (alt,)
        filtered = tuple(a for a in alt if a in names)
        if filtered:
            out.append(filtered)
    return out


# When the primary rule for a parameter cannot shard the model axis (e.g.
# qwen2.5's 40 heads on a 16-way axis), retry these logical dims in order:
# 'head_dim' first reproduces Megatron's row/column-parallel attention,
# 'embed' last.
_MODEL_RETRY_PRIORITY = ("head_dim", "kv_lora", "q_lora", "mlp", "frontend", "embed")
# axes that mark an array as an activation/cache (no retry pass)
_ACTIVATION_AXES = {"batch", "seq", "cache_seq", "sample"}


def logical_to_spec(shape: Sequence[int], axes: Sequence[str | None], mesh,
                    rules=None, *, param_retry: bool = False) -> Spec:
    """The spec of one array, with divisibility fallback.

    ``param_retry``: for parameter-like arrays, if the 'model' axis ended up
    unused (primary rule non-divisible), retry alternate dims so no large
    parameter is ever fully replicated."""
    rules = rules if rules is not None else _CTX.rules
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        placed = False
        for cand in _candidates(name, mesh, rules):
            phys = tuple(a for a in cand if a not in used)
            if not phys or len(phys) != len(cand):
                continue  # partially-consumed mapping: try next alternative
            if dim % math.prod(sizes[a] for a in phys) == 0:
                entries.append(phys if len(phys) > 1 else phys[0])
                used.update(phys)
                placed = True
                break
        if not placed:
            entries.append(None)

    if (param_retry and "model" in sizes and "model" not in used
            and not (_ACTIVATION_AXES & set(a for a in axes if a))):
        msize = sizes["model"]
        for want in _MODEL_RETRY_PRIORITY:
            placed = False
            for i, (dim, name) in enumerate(zip(shape, axes)):
                if name == want and entries[i] is None and dim % msize == 0:
                    entries[i] = "model"
                    placed = True
                    break
            if placed:
                break

    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh axis the spec uses, in dim order."""
    return tuple(a for e in spec for a in spec_axes(e))


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """The block each rank holds of an array of ``shape``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in spec_axes(e))
    return tuple(out)


def shard_slices(shape: Sequence[int], spec: Spec, mesh,
                 coord: dict[str, int]) -> tuple[slice, ...]:
    """The index range that the mesh position ``coord`` ({axis: index})
    owns, one slice per dim: along a dim split over axes (a, b), block
    ``coord[a] * size(b) + coord[b]`` (jax's ``devices_indices_map``)."""
    sizes = mesh_axes(mesh)
    out = []
    for i, dim in enumerate(shape):
        axes = spec_axes(spec[i]) if i < len(spec) else ()
        if not axes:
            out.append(slice(None))
            continue
        block, n = 0, 1
        for a in axes:
            block = block * sizes[a] + coord[a]
            n *= sizes[a]
        step = dim // n
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def mesh_coords(mesh) -> list[dict[str, int]]:
    """Every mesh position in row-major order (the first axis slowest)."""
    sizes = mesh_axes(mesh)
    out: list[dict[str, int]] = [{}]
    for a, n in sizes.items():
        out = [dict(c, **{a: i}) for c in out for i in range(n)]
    return out


def local_shard(full: torch.Tensor, spec: Spec, mesh, coord: dict[str, int]) -> torch.Tensor:
    """The block of ``full`` that ``coord`` owns, as a contiguous copy."""
    return full[shard_slices(full.shape, spec, mesh, coord)].clone(
        memory_format=torch.contiguous_format)


def from_shards(shards: Sequence[torch.Tensor], spec: Spec, mesh) -> torch.Tensor:
    """The full array from every position's block (``shards`` in
    :func:`mesh_coords` order; replicas overwrite their equals)."""
    coords = mesh_coords(mesh)
    sizes = mesh_axes(mesh)
    shape = list(shards[0].shape)
    for i, e in enumerate(spec):
        shape[i] *= math.prod(sizes[a] for a in spec_axes(e))
    full = torch.empty(shape, dtype=shards[0].dtype, device=shards[0].device)
    for c, s in zip(coords, shards, strict=True):
        full[shard_slices(shape, spec, mesh, c)] = s
    return full


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one array's spec (``jax.sharding.NamedSharding``'s place)."""
    mesh: Any
    spec: Spec

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)

    def slices(self, shape: Sequence[int], coord: dict[str, int]) -> tuple[slice, ...]:
        return shard_slices(shape, self.spec, self.mesh, coord)


def named_sharding(shape, axes, mesh=None, rules=None) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    return NamedSharding(mesh, logical_to_spec(shape, axes, mesh, rules, param_retry=True))


# every constrain check made, by its axes: {axes: count}
CHECKS: dict = {}


def constrain(x, axes: Sequence[str | None], sizes: dict[str, int] | None = None):
    """Returns ``x``.  Under a mesh (:func:`logical_sharding`), checks that
    ``x`` is this rank's block of the whole array the reference constrains
    to ``axes``: its spec is :func:`logical_to_spec` of the whole shape
    (``sizes`` gives the whole size of each named logical axis; a ``batch``
    dim is the global batch of :func:`local_batch`; every other dim is taken
    as whole), and every dim must be that spec's block.  Raises
    ``ValueError`` where it is not."""
    if not _CTX.enabled or _CTX.mesh is None or not axes:
        return x
    mesh, rules = _CTX.mesh, _CTX.rules
    sizes = sizes or {}
    whole = []
    for n, name in zip(x.shape, axes):
        if name == "batch":
            if _CTX.local_batch is not None and n != _CTX.local_batch:
                raise ValueError(f"activation batch {n} is not this rank's block "
                                 f"{_CTX.local_batch}")
            whole.append(global_rows(n, mesh, rules))
        else:
            whole.append(sizes.get(name, n) if name is not None else n)
    whole += list(x.shape[len(whole):])
    spec = logical_to_spec(whole, tuple(axes) + (None,) * (len(whole) - len(axes)), mesh,
                           rules)
    want = shard_shape(whole, spec, mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"{tuple(axes)}: {tuple(x.shape)} is not this rank's block {want} "
                         f"of {tuple(whole)} under spec {spec}")
    key = tuple(axes)
    CHECKS[key] = CHECKS.get(key, 0) + 1
    return x


def global_rows(rows: int, mesh, rules) -> int:
    """The global batch of which ``rows`` is this rank's block: the one
    :func:`local_batch` names, else ``rows`` times the batch rule's first
    mapping."""
    if _CTX.global_batch is not None:
        return _CTX.global_batch
    cands = _candidates("batch", mesh, rules)
    sizes = mesh_axes(mesh)
    return rows * (math.prod(sizes[a] for a in cands[0]) if cands else 1)


@contextlib.contextmanager
def local_batch(rows: int | None, total: int | None = None):
    """:func:`constrain` checks ``batch`` dims against ``rows`` inside, this
    rank's block of a global batch of ``total`` rows (by default ``rows``
    times the batch rule's first mapping)."""
    prev = (_CTX.local_batch, _CTX.global_batch)
    _CTX.local_batch, _CTX.global_batch = rows, total
    try:
        yield
    finally:
        _CTX.local_batch, _CTX.global_batch = prev


def tp_ways(mesh, rules, logical: str, dim: int) -> int:
    """How many ways a dim of ``dim`` along ``logical`` splits over
    ``model``: the model axis's size where the rules map ``logical`` onto
    ``model`` alone, the axis has more than one rank and divides ``dim``;
    else 1 (the dim is whole on every rank)."""
    if mesh is None:
        return 1
    m = mesh_axes(mesh).get("model", 1)
    cands = _candidates(logical, mesh, rules)
    if m == 1 or not cands or cands[0] != ("model",):
        return 1
    return m if dim % m == 0 else 1


def current_rules() -> dict[str, Any]:
    return _CTX.rules


def is_axes_leaf(x) -> bool:
    """A logical-axes annotation: tuple of str/None (possibly empty)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def _leaves(tree, is_leaf) -> list:
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def _shape_of(leaf) -> tuple[int, ...]:
    if isinstance(leaf, (list, tuple)) and leaf and isinstance(leaf[0], torch.Tensor):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def tree_shardings(abstract_tree, spec_tree, mesh=None, rules=None):
    """A :class:`NamedSharding` tree for an (abstract tree, logical-axes
    tree) pair with the same dict structure; an abstract leaf is anything
    with a ``shape`` (a ``meta`` tensor, :class:`repro_torch.launch.specs.Struct`)
    or a list of same-shaped tensors standing for their stack."""
    mesh = mesh if mesh is not None else _CTX.mesh

    def walk(a, s):
        if isinstance(a, dict):
            if not isinstance(s, dict) or set(a) != set(s):
                raise ValueError(f"params/axes tree mismatch at keys {sorted(a)}")
            return {k: walk(a[k], s[k]) for k in a}
        if not is_axes_leaf(s):
            raise ValueError(f"params/axes tree mismatch: leaf vs {type(s).__name__}")
        return named_sharding(_shape_of(a), s, mesh, rules)

    n_a = len(_leaves(abstract_tree, lambda x: not isinstance(x, dict)))
    n_s = len(_leaves(spec_tree, is_axes_leaf))
    if n_a != n_s:
        raise ValueError(f"params/axes tree mismatch: {n_a} vs {n_s} leaves")
    return walk(abstract_tree, spec_tree)
