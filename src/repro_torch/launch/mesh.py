"""Meshes: the logical (node, model) mesh and its realisation over ranks.

The port of ``repro.launch.mesh``.  The reference builds a ``jax.sharding.
Mesh`` of devices; the port keeps the mesh logical -- axis names and
sizes, no devices -- because one process holds a node's model shards
whole (``repro_torch.models.sharding``).  :class:`ProcessMesh` realises
the node axes over the ranks of a ``torch.distributed`` process group:
rank r holds the contiguous node block ``[r N / W, (r + 1) N / W)``, all M
model shards of those nodes in the rank.  Functions, not module-level
constants: importing this module touches no device and no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape`` and ``axis_names`` align
    (``("data", "model")``, or ``("pod", "data", "model")``)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in rank")
        if "data" not in self.axis_names or min(self.shape) < 1:
            raise ValueError(f"mesh {self.shape} over {self.axis_names}: "
                             f"needs a 'data' axis and sizes >= 1")

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_nodes(self) -> int:
        """Decentralized graph size on this mesh."""
        return self.sizes.get("pod", 1) * self.sizes["data"]

    @property
    def n_chips(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, logically: one TPU v5e pod =
    256 chips as (data=16, model=16); two pods add a leading 'pod' axis.
    The decentralized node axis is ('pod', 'data')."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def n_nodes(mesh: Mesh) -> int:
    """Decentralized graph size on this mesh (the reference's function;
    :attr:`Mesh.n_nodes`)."""
    return mesh.n_nodes


def n_chips(mesh: Mesh) -> int:
    """Devices of the mesh (the reference's function; :attr:`Mesh.n_chips`)."""
    return mesh.n_chips


class ProcessMesh:
    """``mesh``'s node axes over the ranks of a process group: rank r
    holds nodes ``[lo, hi)`` = ``[r N / W, (r + 1) N / W)``.  ``rank`` and
    ``world`` default to the initialised default group's.  Refuses a node
    count the world size does not divide."""

    def __init__(self, mesh: Mesh, *, rank: Optional[int] = None,
                 world: Optional[int] = None, group=None) -> None:
        if rank is None or world is None:
            import torch.distributed as dist
            rank = dist.get_rank(group) if rank is None else rank
            world = dist.get_world_size(group) if world is None else world
        n = mesh.n_nodes
        if world < 1 or n % world:
            raise ValueError(f"{n} nodes do not split evenly over {world} "
                             f"ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        self.mesh, self.rank, self.world, self.group = mesh, rank, world, group
        self.n_local = n // world
        self.lo = rank * self.n_local
        self.hi = self.lo + self.n_local

    @property
    def n_nodes(self) -> int:
        return self.mesh.n_nodes

    def owner(self, node: int) -> int:
        """The rank that holds ``node``."""
        return node // self.n_local

    def rows(self, x):
        """The rows of a node-stacked ``x`` (N, ...) this rank holds."""
        return x[self.lo:self.hi]
