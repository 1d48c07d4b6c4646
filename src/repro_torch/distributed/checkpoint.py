"""Checkpointing with atomic commits and an async writer, in the reference's
on-disk format (port of ``repro.distributed.checkpoint``).

Layout:  <dir>/step_<k>/          one .npy per leaf + manifest.json
         <dir>/step_<k>.tmp/      staging (os.replace'd on commit)

Leaves are named as ``jax.tree_util.tree_flatten_with_path`` names the
reference's tree: dict keys in sorted order joined by ``/``
(``params/stages/layers/attn/wq``, ``opt/mu/...``, ``step``); file names
are those names sanitised.  A list leaf (a stage's per-layer tensors, see
:mod:`repro_torch.optim.optimizers`) is written stacked along a new axis
0, as the reference's stage leaves are.  A bf16 leaf is written as the
reference writes an ``ml_dtypes`` bfloat16 array: a ``<V2`` record array
of its raw bits, ``"dtype": "bfloat16"`` in the manifest (numpy has no
bfloat16, and the bits go through ``torch.int16``).  Either package reads
the other's checkpoints.

Restore is device-independent: leaves are read whole and placed where the
``like`` tree's leaves are (or on ``device``).

On a mesh (``shardings=``, a tree of
:class:`~repro_torch.distributed.sharding.NamedSharding` matching the
tree), each rank holds its blocks: ``save`` gathers each leaf's blocks to
rank 0 (:func:`repro_torch.distributed.collectives.gather_to_rank0`),
which writes the whole array as above, then every rank waits at a
barrier; ``restore`` reads each rank's block alone from a memory-mapped
file.  The files do not depend on the mesh, so a run resumes on any mesh
(:mod:`repro_torch.distributed.elastic`).
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.optim.optimizers import is_stacked

BF16_DESCR = "<V2"     # how numpy writes an ml_dtypes bfloat16 array's records


def leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) in the reference's flattening order: sorted dict keys."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_./-]", "_", name).replace("/", "__")


def _host(leaf, copy: bool) -> torch.Tensor:
    """A leaf on the host (a list leaf stacked), detached from any graph;
    ``copy`` makes it a copy even where the leaf is a host tensor already."""
    if is_stacked(leaf):
        return torch.stack([t.detach().cpu() for t in leaf])
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return torch.as_tensor(np.asarray(leaf)).clone()


def _save_npy(path: str, t: torch.Tensor) -> str:
    """Write ``t`` as the reference's ``np.save`` would; returns its dtype
    name for the manifest."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": bits.shape})
            f.write(bits.tobytes())
        return "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return str(arr.dtype)


def _load_npy(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V":
        # raw records (bfloat16): reinterpret by the manifest's dtype
        if dtype_name != "bfloat16":
            raise ValueError(f"{path}: raw records of {dtype_name!r}, only bfloat16 is read")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def gather_tree(tree, shardings):
    """Each leaf of a tree of this rank's blocks gathered whole on rank 0,
    as host tensors: the tree there, ``None`` on the other ranks."""
    out = {}
    first = True
    for (name, leaf), (_, s) in zip(leaf_paths(tree), leaf_paths(shardings), strict=True):
        if first:
            order = s.mesh.mesh.reshape(-1).tolist()
            first = False
        parts = collectives.gather_to_rank0(_host(leaf, copy=False))
        if parts is not None:
            out[name] = sh.from_shards([parts[r] for r in order], s.spec, s.mesh)
    if dist.get_rank() != 0:
        return None
    return _nest_names(out)


def _nest_names(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def save(directory: str, step: int, tree, *, extra: dict | None = None,
         shardings=None) -> str:
    """Atomically write ``tree`` under <directory>/step_<step>; with
    ``shardings`` every rank calls it with its blocks, rank 0 writes."""
    final = os.path.join(directory, f"step_{step}")
    if shardings is not None:
        whole = gather_tree(tree, shardings)
        if whole is not None:
            save(directory, step, whole, extra=extra)
        dist.barrier()
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in leaf_paths(tree):
        t = _host(leaf, copy=False)
        fname = _sanitize(name) + ".npy"
        dtype = _save_npy(os.path.join(tmp, fname), t)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": list(t.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _like_meta(like) -> tuple[tuple[int, ...], torch.dtype, torch.device]:
    if is_stacked(like):
        t = like[0]
        return (len(like),) + tuple(t.shape), t.dtype, t.device
    return tuple(like.shape), like.dtype, like.device


def _load_block(path: str, dtype_name: str, where) -> torch.Tensor:
    """One block of a saved array, read from a memory map."""
    arr = np.load(path, mmap_mode="r")
    block = np.array(arr[where], order="C")     # a writable copy, 0-d kept
    if block.dtype.kind == "V":
        if dtype_name != "bfloat16":
            raise ValueError(f"{path}: raw records of {dtype_name!r}, only bfloat16 is read")
        return torch.from_numpy(block.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(block)


def restore(directory: str, step: int, like_tree, *, device=None, shardings=None):
    """Read <directory>/step_<step> into the structure of ``like_tree``.

    Each leaf takes its ``like`` leaf's dtype and device (``device``
    overrides the device; a ``meta`` like leaf gives the CPU); a list leaf
    comes back as a list of its rows.  With ``shardings`` (a tree matching
    ``like_tree``) each rank reads the block its mesh position owns, and
    ``like_tree``'s leaves are blocks.  Returns (tree, manifest)."""
    final = os.path.join(directory, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    def read(name, like, s):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = by_name[name]
        path = os.path.join(final, entry["file"])
        if s is None:
            t = _load_npy(path, entry["dtype"])
        else:
            coord = collectives._coord(s.mesh)
            t = _load_block(path, entry["dtype"], s.slices(entry["shape"], coord))
        shape, dtype, dev = _like_meta(like)
        if tuple(t.shape) != shape and not (s is not None and shape == tuple(entry["shape"])):
            # a block's like leaf is the block, or (an abstract tree) the whole leaf
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        dev = torch.device(device) if device is not None else dev
        if dev.type == "meta":
            dev = torch.device("cpu")
        t = t.to(device=dev, dtype=dtype)
        return list(t.unbind(0)) if is_stacked(like) else t

    def walk(tree, s, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, None if s is None else s[k], f"{prefix}{k}/")
                    for k, v in tree.items()}
        return read(prefix[:-1], tree, s)

    return walk(like_tree, shardings, ""), manifest


class AsyncCheckpointer:
    """Background-thread writer: the train loop never blocks on file I/O.

    ``save()`` copies every tensor to the host before it enqueues the write
    (the optimizer updates the live tensors in place, so a write that still
    held them would race the next step); ``wait()`` drains the queue (call
    before exit and before a restore)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.mesh_save = False
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: list[Exception] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save(self.directory, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:  # surfaced on wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def save(self, step: int, tree, extra: dict | None = None, shardings=None):
        """Enqueue a write of ``tree``; with ``shardings`` (every rank calls
        it with its blocks) the blocks are gathered to rank 0 now and rank 0
        alone enqueues, and ``wait`` ends at a barrier."""
        if shardings is not None:
            self.mesh_save = True
            host_tree = gather_tree(tree, shardings)
            if host_tree is None:
                return
        else:
            host_tree = _host_tree(tree)
        self._q.put((step, host_tree, extra))

    def wait(self):
        self._q.join()
        if self.mesh_save:
            dist.barrier()
        if self._err:
            raise self._err[0]

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _host(tree, copy=True)
