"""Device meshes (torch counterpart of
``stereo_match_traditional_tpu.parallel.mesh``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of
devices.  The port runs one process a device over ``torch.distributed``
(SPMD), and a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the process group:

* tile-DP: image rows sharded over the ``tile`` axis, with halo exchange
  (``parallel.tiled``);
* disparity parallelism: the D axis sharded over the ``disp`` axis with a
  two-stage WTA (``parallel.wta_shard``);
* the sharded scanline (``parallel.scan_carry``): one ``all_to_all`` from
  rows to columns and back.

A sharded function takes an axis as :class:`MeshAxis` (the mesh and the
axis' name), where the JAX package takes the axis' name inside its
``shard_map``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class MeshAxis(NamedTuple):
    """One named axis of a ``DeviceMesh``: the process group along it, its
    size and this rank's index on it (``lax.axis_index``)."""

    mesh: DeviceMesh
    name: str

    @property
    def group(self):
        return self.mesh.get_group(self.name)

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.name)

    @property
    def index(self) -> int:
        return self.mesh.get_local_rank(self.name)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the mesh axis ``name`` (JAX's
    ``mesh.shape[name]``)."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {name!r}; its axes: {mesh.mesh_dim_names}")
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("tile",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build a ``DeviceMesh`` over the first ``n_devices`` ranks of the
    process group (``parallel.distributed.initialize`` starts one of world
    1 where none runs), one device a rank.

    ``shape`` reshapes the ranks for multi-axis meshes, e.g.
    ``make_mesh(8, ("tile", "disp"), (4, 2))``; with a shape and no
    ``n_devices`` it takes exactly ``prod(shape)`` ranks.  ``devices``: the
    ranks in mesh order (default: all, in rank order).  A mesh spans every
    rank of the world: a ``DeviceMesh`` is built by all ranks together, and
    a rank outside it would hang the others' collectives, so fewer ranks
    than the world raise ``ValueError`` as too many do."""
    from stereo_match_traditional_tpu_torch.parallel import distributed

    distributed.initialize()
    world = dist.get_world_size()
    ranks = list(devices if devices is not None else range(world))
    if n_devices is None:
        n_devices = int(torch.tensor(shape).prod()) if shape is not None else len(ranks)
    if n_devices > len(ranks):
        raise ValueError(f"need {n_devices} devices, have {len(ranks)}")
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices in a world of {world}: a DeviceMesh spans every "
            "rank of the process group (start as many processes as the mesh has devices)")
    ranks = ranks[:n_devices]
    if shape is None:
        shape = (n_devices,)
    if int(torch.tensor(shape).prod()) != n_devices:
        raise ValueError(f"shape {tuple(shape)} does not use {n_devices} devices")
    if len(axis_names) != len(shape):
        raise ValueError(f"axis names {tuple(axis_names)} for a mesh of shape {tuple(shape)}")
    return DeviceMesh(distributed.device_type(), torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))
