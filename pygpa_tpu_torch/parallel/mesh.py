"""Device meshes on torch.distributed (counterpart of
pygpa_tpu/parallel/mesh.py), and the local blocks the sharded functions
work on.

The reference is single-controller: GSPMD partitions global arrays over
a jax Mesh. Here every rank of a torch.distributed world calls the same
function (SPMD). A mesh is a DeviceMesh; a sharded result is a DTensor,
Shard on the sharded tensor axis over the mesh dimension `axis` and
Replicate() over the others. The functions take a full tensor (each
rank keeps its own block, as jax.device_put with a sharding does) or a
DTensor already sharded that way, work on the local blocks with explicit
collectives on mesh.get_group(axis), and never let DTensor propagate an
operation along a sharded axis (it would gather the whole plane).
"""
import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core import entry_tensor


def make_mesh(n_devices=None, axis_names=("batch",), shape=None,
              device_type=None):
    """A DeviceMesh over the ranks of the initialised process group, one
    device a rank; n_devices (None: the world size) must be the world
    size, since every rank runs the sharded functions.

    With one axis name the mesh is 1D; pass shape for multi-axis layouts,
    e.g. make_mesh(4, ("batch", "k"), (2, 2)) to split image batches over
    one axis and k-candidates over the other. device_type None means the
    card ("cuda"); the CPU tests pass "cpu" (a gloo group)."""
    world = torch.distributed.get_world_size()
    if n_devices is None:
        n_devices = world
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (int(n_devices),)
    if int(np.prod(shape)) != int(n_devices) or n_devices != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} over {n_devices} "
                         f"devices must cover the world of {world} ranks")
    return init_device_mesh(device_type or "cuda", tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh, axis="batch", ndim=3):
    """The placements that shard an ndim-axis tensor's leading (batch)
    axis over the mesh dimension `axis` and replicate it over the others
    (the reference's NamedSharding(mesh, P(axis, None, ...)))."""
    return placements(mesh, axis, 0, ndim)


def placements(mesh, axis, dim, ndim):
    """Shard(dim) of an ndim-axis tensor on the mesh dimension `axis`,
    Replicate() on the others."""
    if not 0 <= dim % max(ndim, 1) < ndim:
        raise ValueError(f"axis {dim} of a {ndim}-axis tensor")
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return tuple(Shard(dim % ndim) if a == axis else Replicate()
                 for a in names)


def mesh_device(mesh):
    """The torch device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh, axis):
    """(group, this rank's index along `axis`, the axis's size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def local_block(x, mesh, axis, dim):
    """This rank's block of x along tensor axis `dim`, split evenly over
    the mesh dimension `axis`: x is a DTensor sharded that way (its local
    tensor) or a full tensor / array (its block, moved to the mesh's
    device). Raises when the axis does not split evenly."""
    _, rank, world = axis_info(mesh, axis)
    if isinstance(x, DTensor):
        want = placements(mesh, axis, dim, x.dim())
        if tuple(x.placements) != want or x.device_mesh != mesh:
            raise ValueError(f"expected a DTensor on this mesh with "
                             f"placements {want}, got {x.placements}")
        full, size, x = False, x.shape[dim], x.to_local()
    else:
        x = entry_tensor(x, mesh_device(mesh))
        full, size = True, x.shape[dim]
    if size % world:
        raise ValueError(f"axis {dim} of length {size} does not split "
                         f"evenly over the {world} ranks of mesh axis "
                         f"{axis!r}")
    return x.narrow(dim, rank * (size // world), size // world) if full \
        else x


def sharded(local, mesh, axis, dim):
    """The DTensor whose blocks along tensor axis `dim` are the ranks'
    `local` blocks (equal shapes), sharded over the mesh dimension
    `axis` and replicated over the others."""
    _, _, world = axis_info(mesh, axis)
    local = local.contiguous()
    shape = list(local.shape)
    shape[dim] *= world
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh,
                              placements(mesh, axis, dim, local.dim()),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))
