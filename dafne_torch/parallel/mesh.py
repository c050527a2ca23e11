"""The process mesh: one "data" axis over the processes.

Counterpart of ``dafne_tpu/parallel/mesh.py``.  JAX lays its devices out
on a ``jax.sharding.Mesh`` from TPU.MESH_SHAPE and TPU.MESH_AXIS_NAMES;
here each process drives one card, and the only axis is "data": its size
is the world size (a -1 entry absorbs it, as in JAX's ``create_mesh``), and
process p holds rows p*B/P .. (p+1)*B/P of every global batch
(``distributed.local_batch_slice``).  The "spatial" axis (feature maps
sharded along H, ``dafne_tpu/parallel/mesh.py::image_sharding``) is not
ported and raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from dafne_torch.parallel.distributed import process_count


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",),
                world_size: Optional[int] = None) -> Dict[str, int]:
    """{axis name: size} of a mesh over `world_size` processes (the process
    group's by default).  Raises unless the sizes multiply out to the world
    size, and for any axis but "data"."""
    world = process_count() if world_size is None else int(world_size)
    shape = list(mesh_shape if mesh_shape is not None else [-1])
    names = list(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"TPU.MESH_SHAPE {shape} and TPU.MESH_AXIS_NAMES {names} differ in length")
    if "spatial" in names:
        raise NotImplementedError(
            "the 'spatial' mesh axis (feature maps sharded along H, "
            "dafne_tpu/parallel/mesh.py::image_sharding) is not ported")
    if names != ["data"]:
        raise ValueError(f"only the 'data' mesh axis is ported, got {names}")
    known = 1
    for s in shape:
        if s > 0:
            known *= s
    sizes = [world // known if s == -1 else s for s in shape]
    total = 1
    for s in sizes:
        total *= s
    if total != world or shape.count(-1) > 1:
        raise ValueError(f"TPU.MESH_SHAPE {shape} does not multiply out to the world size {world}")
    return dict(zip(names, sizes))


def mesh_from_config(cfg, world_size: Optional[int] = None) -> Dict[str, int]:
    return create_mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXIS_NAMES, world_size)
