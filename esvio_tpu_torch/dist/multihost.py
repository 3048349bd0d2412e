"""Multi-process launch glue: process-group init and the hybrid mesh (port
of esvio_tpu/dist/multihost.py).

  * axis "dp" (outer, across nodes): independent sequences / windows;
  * axis "lm" (inner): the landmark-sharded Schur BA
    (dist/distributed_ba.py), whose all-reduce stays among one node's
    local ranks.

Launch one process per GPU, same command everywhere:

    python -m esvio_tpu_torch.dist.multihost --coordinator HOST0:1234 \\
        --num-processes N --process-id $RANK [--lm LM] [--selftest] \\
        [--dtype float64]

or under torchrun (`initialize()` reads its environment).  The backend is
NCCL when each local rank owns its own GPU, else Gloo (on the CPU, and for
several ranks on one GPU, which NCCL refuses); Gloo's all-reduce and
all-gather take the CUDA tensors as they are.  In one process `initialize` is a
no-op and the mesh is the one-device layout, so the same code runs
everywhere.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from esvio_tpu_torch.dist.sharding import Mesh, make_mesh


def _local_world(num_processes) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes or 1))


def default_backend(device, num_processes=None) -> str:
    """NCCL when the card count covers this node's ranks, else Gloo."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= _local_world(num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, device="cuda"):
    """init_process_group from the arguments, or from torchrun's
    environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).  A no-op that
    returns False in one process."""
    if dist.is_initialized():
        return True
    from_env = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if num_processes in (None, 1) and coordinator is None and not from_env:
        return False
    if from_env and num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    backend = default_backend(device, num_processes)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return True


def make_hybrid_mesh(lm: int = None) -> Mesh:
    """("dp", "lm") mesh with "lm" inside one node's local ranks.

    Ranks are numbered node by node, so reshaping them to (world/lm, lm)
    with lm dividing the local world size keeps every "lm" group on one
    node.  In one process: the one-device layout with dp = 1."""
    if not dist.is_initialized():
        return make_mesh(dp=1, lm=lm or 1)
    world = dist.get_world_size()
    local = _local_world(world)
    lm = lm or local
    assert local % lm == 0, \
        f"lm={lm} must divide the local world size {local} (node-local sum)"
    return make_mesh(dp=world // lm, lm=lm)


def selftest(mesh: Mesh = None, device="cuda", dtype=torch.float32):
    """One distributed-BA solve on the mesh; every process must print the
    same cost vector.  Prints one JSON line and returns the costs (dp, 4)."""
    from esvio_tpu_torch.dist.distributed_ba import make_sharded_solver
    from esvio_tpu_torch.dist.dryrun import make_problem

    mesh = mesh or make_hybrid_mesh()
    dp, lm = mesh.dp, mesh.lm
    args = make_problem(dtype, L_img=8, L_evt=8 * lm, batch=dp,
                        device=device)
    costs = make_sharded_solver(mesh, iters=4)(*args)[3].cpu().numpy()
    up = dist.is_initialized()
    print(json.dumps({"rank": dist.get_rank() if up else 0, "mesh": mesh.shape,
                      "backend": dist.get_backend() if up else None,
                      "costs": costs.tolist()}),
          flush=True)
    return costs


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--lm", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        rank = args.process_id or int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        import esvio_tpu_torch
        esvio_tpu_torch.disable_tf32()
    initialize(args.coordinator, args.num_processes, args.process_id, device)
    try:
        if args.selftest:
            costs = selftest(make_hybrid_mesh(args.lm), device,
                             getattr(torch, args.dtype))
            assert np.isfinite(costs).all(), costs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
