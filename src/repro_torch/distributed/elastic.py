"""Elastic scaling: resume the same logical state on a different mesh (port
of ``repro.distributed.elastic``).

Nothing in the framework's state is mesh-shaped: checkpoints store whole
arrays, the data pipeline is step-addressed, and each leaf's block is
(re)derived from its logical axes on the mesh at hand.  So an elastic
resize is a restore with the new mesh's shardings, each rank reading only
its block.
"""

from __future__ import annotations

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import collectives
from repro_torch.distributed.fsdp import shard_tree
from repro_torch.distributed.sharding import tree_shardings


def elastic_restore(directory: str, step: int, abstract_tree, spec_tree, mesh,
                    rules=None, device=None):
    """Restore a checkpoint onto ``mesh`` (any shape or axis layout): each
    rank gets its blocks of ``abstract_tree``'s leaves (``meta`` tensors,
    stage leaves stacked), on its device.  Returns (tree, manifest)."""
    shardings = tree_shardings(abstract_tree, spec_tree, mesh, rules)
    return ckpt.restore(directory, step, abstract_tree, shardings=shardings,
                        device=collectives.mesh_device(mesh, device))


def reshard(tree, abstract_tree, spec_tree, mesh, rules=None):
    """Move live whole state onto ``mesh`` without a checkpoint: this
    rank's block of every leaf of ``tree`` (whole tensors, the structure of
    ``abstract_tree``)."""
    shardings = tree_shardings(abstract_tree, spec_tree, mesh, rules)
    return shard_tree(tree, shardings, collectives._coord(mesh))
