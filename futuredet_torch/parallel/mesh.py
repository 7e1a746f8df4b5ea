"""The data-parallel width of a run.

Port of `futuredet_tpu/parallel/mesh.py`. The JAX package lays its devices
out in a `jax.sharding.Mesh` with a `data` axis (and a `space` axis that
shards the BEV rows), and its step runs under `shard_map` over it. torch
has no mesh: data parallelism here is one process per card in a
`torch.distributed` process group (`parallel/collectives.py`), so the
data axis is the group's world size. `make_mesh`, `make_mesh_2d`,
`canvas_sharding`, `batch_sharding` and `replicated` describe XLA
shardings and have no torch meaning; they are not copied. The `space`
axis (GSPMD spatial sharding of the canvas) would need a hand-written
halo exchange and is not ported (ROADMAP.md, queue 1: spatial sharding).
"""
from __future__ import annotations

from .collectives import world_size

SPATIAL_SHARDING = ("--space > 1: GSPMD spatial sharding of the BEV rows is "
                    "not ported (ROADMAP.md, queue 1: spatial sharding)")


def data_axis_size(n_space: int = 1) -> int:
    """The data-parallel width (`futuredet_tpu/parallel/mesh.py:48`): the
    world size of the default process group, 1 without one. Each rank
    holds one card and its own batch, so every rank's batch divides the
    global one. Raises for `n_space` > 1."""
    if n_space > 1:
        raise NotImplementedError(SPATIAL_SHARDING)
    return world_size()
