"""The ("dp", "lm") layout of the distributed window solve (port of
esvio_tpu/dist/sharding.py).

  * axis "dp": independent windows or sequences (no communication);
  * axis "lm": landmark lanes of each feature book, sharded for the Schur
    reduction (dist/distributed_ba.py), whose partial reduced systems are
    summed over "lm".

With a process group up, `make_mesh` lays the world's ranks out as a
`torch.distributed.device_mesh.DeviceMesh` with those dims, one
(dp, lm) coordinate per rank, and the "lm" sum is an all-reduce in the
"lm" group.  In one process it is a layout on one device: every window
and every lane shard is there, the shards are a leading axis, and the
"lm" sum is a sum over that axis.  The solver's code is the same in both;
only `sum_lm` and the final gathers differ.

The JAX module's `replicated` (a NamedSharding with no partitioning) is not
ported: nothing in the repository calls it, and a replicated placement has
no counterpart here, where a tensor lives on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Mesh:
    dp: int
    lm: int
    device_mesh: Optional[object] = None   # DeviceMesh when multi-process

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "lm": self.lm}

    @property
    def coordinate(self):
        """(dp index, lm index) of this process; (None, None) in one
        process, which holds every coordinate."""
        if self.device_mesh is None:
            return None, None
        return tuple(self.device_mesh.get_coordinate())

    def local(self, axis: str) -> slice:
        """The indices along `axis` held by this process."""
        i = self.coordinate[0 if axis == "dp" else 1]
        if i is None:
            return slice(0, self.shape[axis])
        return slice(i, i + 1)

    def _group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def sum_lm(self, x):
        """x (dp_local, lm_local, ...) summed over "lm" → (dp_local, 1,
        ...)."""
        if self.device_mesh is None:
            return x.sum(1, keepdim=True)
        import torch.distributed as dist
        t = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=self._group("lm"))
        return t

    def gather(self, x, axis: str, dim: int):
        """Concatenate every process's x along `dim` over mesh axis `axis`
        (one process: x already holds all of it)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return x
        import torch.distributed as dist
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=self._group(axis))
        return torch.cat(parts, dim)


def make_mesh(dp: int = 1, lm: int = 1) -> Mesh:
    """The ("dp", "lm") layout: over the ranks of the process group when
    one is up (dp · lm must equal its world size), else on one device."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return Mesh(dp, lm)
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    assert dp * lm == world, f"mesh dp={dp} lm={lm} needs {dp * lm} ranks, " \
        f"the group has {world}"
    dm = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                    torch.arange(world).reshape(dp, lm),
                    mesh_dim_names=("dp", "lm"))
    return Mesh(dp, lm, dm)
