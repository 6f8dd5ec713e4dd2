"""Model meshes of the port (the reference's ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices its one
process sees.  The port is SPMD over ``torch.distributed``: one process per
rank, and a ``DeviceMesh`` over the initialized default process group,
which belongs to the caller (``torch.distributed.init_process_group`` on
every rank first; none is built here, as in ``placement_mesh``).  The dry
run (``launch.dryrun``) joins a ``"fake"`` group of 256 / 512 ranks, the
counterpart of the reference's forced host devices.

Meshes are made by FUNCTIONS, so importing this module touches no process
group.  ``device_type`` defaults to the card, as every entry point of the
port; the dry run and the CPU tests pass ``"cpu"``.

The multi-pod mesh shards the batch over ("pod", "data") together.  A
DTensor sharded on one dimension over two mesh axes meets strided shards
in every view that splits or merges that dimension, so batch-sharded
tensors live on ``batch_mesh(mesh)`` instead: the same ranks in the same
order as a 2-D ("pod_data", "model") mesh, whose first axis is the two
flattened -- one plain 32-way shard of the batch, as 16x16's is 16-way.
Parameters stay on the 3-D mesh (FSDP over "data" alone, as the
reference's specs say) and cross to the batch mesh where a layer gathers
them (``launch.shardings``).
"""

from __future__ import annotations

import torch.distributed as dist

from ..device import resolve_device

POD, DATA, MODEL = "pod", "data", "model"
POD_DATA = "pod_data"  # the batch mesh's flattened (pod, data) axis


def _mesh(shape: tuple, names: tuple, device_type):
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "torch.distributed.init_process_group(...) on every rank first"
        )
    size = 1
    for s in shape:
        size *= s
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = resolve_device(None).type
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 ranks, axes ("data", "model"); 2x16x16 with "pod" in front for
    the multi-pod dry run.  The group must have 256 / 512 ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), (POD, DATA, MODEL), device_type)
    return _mesh((16, 16), (DATA, MODEL), device_type)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str | None = None, *,
                    pod: int = 1):
    """A (data, model) mesh over the whole group (tests: 1x1, 2x2), with
    "pod" in front for ``pod > 1`` (tests: 2x2x1, 2x1x2)."""
    if pod > 1:
        return _mesh((pod, data, model), (POD, DATA, MODEL), device_type)
    return _mesh((data, model), (DATA, MODEL), device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of any object with
    ``.axis_names`` and a ``.shape`` mapping (the reference's fake meshes
    in tests)."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {n: shape[n] for n in names}
    return dict(zip(names, tuple(shape)))


def batch_mesh(mesh):
    """The mesh batch-sharded tensors live on: ``mesh`` itself, or for a
    ``DeviceMesh`` with a "pod" axis the ("pod_data", "model") mesh over
    the same ranks, built once per mesh object and kept on it (the module
    docstring says why).
    Anything else (the spec functions' mesh-like objects) is returned as
    it is."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or POD not in axis_sizes(mesh):
        return mesh
    # kept on the object, not in a table by value: meshes compare equal by
    # layout, and an equal mesh of an earlier, destroyed group holds dead
    # process groups
    if getattr(mesh, "_batch_mesh", None) is None:
        sizes = axis_sizes(mesh)
        mesh._batch_mesh = _mesh((sizes[POD] * sizes[DATA], sizes[MODEL]),
                                 (POD_DATA, MODEL), mesh.device_type)
    return mesh._batch_mesh


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ("pod", "data") multi-pod, ("pod_data",)
    on its batch mesh, else ("data",)."""
    return tuple(a for a in axis_sizes(mesh) if a in (POD, DATA, POD_DATA))


def batch_pspec(mesh) -> tuple:
    """The batch's spec (dimension 0 over the data axes), as the port's
    spec type: a tuple with one entry per dimension."""
    dp = data_axes(mesh)
    return (dp[0] if len(dp) == 1 else dp,)
