"""Rank grids of the port (``chainermn_tpu/comm/mesh.py``).

The JAX package lays its devices out as a :class:`jax.sharding.Mesh` with
named axes; one controller drives them all.  The port runs one process
per rank, so its grid holds ranks, not devices: a :class:`RankMesh` is an
N-D array of communicator ranks with axis names, and a :class:`Topology`
says which host (``proc``) owns each rank.  ``topology_mesh`` gives the
``(inter, intra)`` grid of the hierarchical communicators: ``inter`` runs
across hosts, ``intra`` over the ranks of one host, host-major as MPI lays
ranks out.  No collective is built here; :mod:`~chainermn_tpu_torch.comm.
process_group` builds one process group per line of a grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: Axis names shared with the JAX package.
INTER_AXIS = "inter"  # across hosts
INTRA_AXIS = "intra"  # ranks within a host
DATA_AXIS = "data"  # flat data-parallel axis (one-axis grids)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """An N-D grid of ranks with named axes: ``ranks[i, j, ...]`` is the
    rank at that position, ``axis_names[k]`` names axis ``k``."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-D ranks for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def lines(self, axes: Sequence[str]) -> np.ndarray:
        """The grid regrouped over ``axes``: row ``j`` holds the ranks of
        one group (one position of the other axes), in row-major order of
        ``axes``; rows follow the other axes' row-major order."""
        names = list(self.axis_names)
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{self.axis_names}")
        part = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in part]
        size = int(np.prod([self.ranks.shape[i] for i in part]))
        return np.transpose(self.ranks, rest + part).reshape(-1, size)


def flat_mesh(size: int, axis_name: str = DATA_AXIS) -> RankMesh:
    """A 1-D grid over ``size`` ranks: the ``pure_nccl`` analog (one flat
    ring)."""
    return RankMesh(np.arange(size), (axis_name,))


def hybrid_mesh(shape: dict, size: Optional[int] = None) -> RankMesh:
    """An N-D grid from ``{axis_name: size}``, ranks in row-major order:
    ``hybrid_mesh({"data": 2, "model": 4})`` puts ranks 0-3 on data row 0.
    ``size`` (the world size) is checked against the grid when given."""
    sizes = tuple(int(v) for v in shape.values())
    n = int(np.prod(sizes))
    if size is not None and n != size:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, got {size}")
    return RankMesh(np.arange(n).reshape(sizes), tuple(shape.keys()))


def topology_mesh(hosts: Sequence) -> RankMesh:
    """The ``(inter, intra)`` grid of ranks whose host names (or any
    hashable host keys) are ``hosts[rank]``: one row per host, in the order
    the hosts first appear, each row its ranks in rank order.  Hosts with
    different rank counts give a flat ``(n, 1)`` layout, as the JAX
    package's ragged fallback does."""
    by_host: Dict = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    rows = list(by_host.values())
    if len({len(v) for v in rows}) != 1:
        return RankMesh(np.arange(len(hosts)).reshape(-1, 1),
                        (INTER_AXIS, INTRA_AXIS))
    return RankMesh(np.array(rows), (INTER_AXIS, INTRA_AXIS))


@dataclasses.dataclass(frozen=True)
class Topology:
    """Rank and host bookkeeping (the JAX package's ``Topology``).  One
    process per rank, so ``rank`` is this process's rank in the group and
    ``intra_rank`` its position among the group's ranks on its host;
    ``proc_of_rank[r]`` is the host index of rank ``r``, ``procs`` the
    hosts in rank order."""

    rank: int
    size: int
    intra_rank: int
    intra_size: int
    inter_rank: int
    inter_size: int
    proc_of_rank: Tuple[int, ...] = ()
    procs: Tuple[int, ...] = ()

    def proc_of(self, rank: int) -> int:
        return self.proc_of_rank[rank]

    def inter_rank_of(self, rank: int) -> int:
        return self.procs.index(self.proc_of_rank[rank])

    def intra_rank_of(self, rank: int) -> int:
        p = self.proc_of_rank[rank]
        return [r for r in range(self.size)
                if self.proc_of_rank[r] == p].index(rank)

    def ranks_of_proc(self, proc: int) -> Tuple[int, ...]:
        return tuple(r for r in range(self.size)
                     if self.proc_of_rank[r] == proc)


def topology(rank: int, hosts: Sequence) -> Topology:
    """The topology of a group whose rank ``r`` runs on host
    ``hosts[r]``, seen from ``rank``."""
    ids: Dict = {}
    proc_of_rank = tuple(ids.setdefault(h, len(ids)) for h in hosts)
    procs = tuple(dict.fromkeys(proc_of_rank))
    topo = Topology(rank=rank, size=len(hosts), intra_rank=0, intra_size=1,
                    inter_rank=0, inter_size=len(procs),
                    proc_of_rank=proc_of_rank, procs=procs)
    return dataclasses.replace(
        topo, intra_rank=topo.intra_rank_of(rank),
        intra_size=max(len(topo.ranks_of_proc(p)) for p in procs),
        inter_rank=topo.inter_rank_of(rank))
