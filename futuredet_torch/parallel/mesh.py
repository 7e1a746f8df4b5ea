"""The (data, space) layout of a run's ranks.

Port of `futuredet_tpu/parallel/mesh.py`. The JAX package lays its devices
out in a `jax.sharding.Mesh` with a `data` axis and a `space` axis that
shards the BEV rows (`make_mesh_2d`, `canvas_sharding`), and XLA inserts
the collectives. torch has no mesh and no partitioner: here a run is one
process per card in a `torch.distributed` process group
(`parallel/collectives.py`), and `--space S` lays its `n_data x S` ranks
out as `make_mesh_2d` lays out its devices: rank r is data index r // S
and space index r % S, so the ranks of one space group are adjacent.
`SpaceGroup` holds this rank's place, the process groups of its space
group and of its data group, and the band rule; the halo exchange, the
band gather and the group-aware reductions are in
`parallel/collectives.py`, the band-aware layers in `models/layers.py`.
`make_mesh`, `canvas_sharding`, `batch_sharding` and `replicated`
describe XLA shardings and have no torch meaning; they are not copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch.distributed as dist

from .collectives import rank, world_size


def data_axis_size(n_space: int = 1) -> int:
    """The data-parallel width (`futuredet_tpu/parallel/mesh.py:48`): the
    world size of the default process group (1 without one) over
    `n_space`. Each data index holds its own batch, read alike by the
    ranks of its space group. Raises ValueError when `n_space` does not
    divide the world size."""
    world = world_size()
    if n_space < 1 or world % n_space:
        raise ValueError(f"--space {n_space} does not divide the world "
                         f"size {world}")
    return world // n_space


def band_bounds(rows: int, n_space: int) -> List[Tuple[int, int]]:
    """The rows [start, stop) of each space index: contiguous, ceil(rows /
    n_space) rows to each leading index, the rest to the last. Raises
    ValueError when an index would hold no row."""
    per = -(-rows // n_space)
    bounds = [(i * per, min((i + 1) * per, rows)) for i in range(n_space)]
    if bounds[-1][0] >= rows:
        raise ValueError(f"{rows} rows leave a space index of {n_space} "
                         f"without a band")
    return bounds


@dataclass(frozen=True)
class SpaceGroup:
    """This rank's place in the (data, space) layout. `space` and `data`
    are the process groups of its space group (the ranks that share its
    batch, each holding a band of the canvas rows) and of its data group
    (the ranks of its space index, one for each batch); `ranks` are the
    global ranks of its space group by space index."""
    n_data: int
    n_space: int
    data_index: int
    index: int
    space: Any
    data: Any
    ranks: Tuple[int, ...]

    def band(self, rows: int, scale: int = 1) -> Tuple[int, int]:
        """This rank's band of `rows` coarse rows, in rows of a level
        `scale` times finer."""
        a, b = band_bounds(rows, self.n_space)[self.index]
        return a * scale, b * scale

    def bands(self, rows: int, scale: int = 1) -> List[Tuple[int, int]]:
        return [(a * scale, b * scale)
                for a, b in band_bounds(rows, self.n_space)]

    @property
    def above(self) -> Optional[int]:
        """The global rank of the band above (lower rows), None at the
        canvas's edge."""
        return self.ranks[self.index - 1] if self.index > 0 else None

    @property
    def below(self) -> Optional[int]:
        return (self.ranks[self.index + 1]
                if self.index + 1 < self.n_space else None)


def make_space_group(n_space: int) -> Optional[SpaceGroup]:
    """The layout of `n_space` > 1 over the default process group: every
    rank creates every space group, then every data group, in the same
    order, as `dist.new_group` requires. None for `n_space` 1 (the data-
    parallel run of `parallel/collectives.py`)."""
    n_data = data_axis_size(n_space)
    if n_space == 1:
        return None
    r = rank()
    space = data = None
    for d in range(n_data):
        ranks = tuple(d * n_space + s for s in range(n_space))
        g = dist.new_group(list(ranks))
        if r in ranks:
            space, space_ranks = g, ranks
    for s in range(n_space):
        g = dist.new_group([d * n_space + s for d in range(n_data)])
        if r % n_space == s:
            data = g
    return SpaceGroup(n_data=n_data, n_space=n_space,
                      data_index=r // n_space, index=r % n_space,
                      space=space, data=data, ranks=space_ranks)
