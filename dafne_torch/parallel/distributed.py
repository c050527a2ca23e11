"""Several processes: one per GPU, data parallel over the global batch.

Counterpart of ``dafne_tpu/parallel/distributed.py``.  The reference
launches one process per GPU and coordinates them with torch.distributed
(``tools/plain_train_net.py:660-671``); the JAX package keeps that launch
contract and runs one SPMD program over the processes.  Here each process
runs the port's one-device step on its rows of the global batch, and the
collectives that the SPMD program gets from XLA are written out:

- the loss normalizers ``num_pos`` and ``loss_denorm`` are global sums
  (``all_reduce_sum``, in ``ops/losses.py``);
- BN towers take their training statistics over the global batch
  (``GlobalSum``, which keeps the gradient, in ``models/layers.py``);
- the gradients are summed over the processes (``all_reduce_grads_``, in
  ``engine/trainer.py``): each process's loss is its local numerator over
  the global normalizer, so the sum is the gradient of JAX's global loss;
- the parameters are broadcast from process 0 once (``broadcast_state_``);
- evaluation outputs are gathered to process 0 (``gather_to_main``,
  ``gather_objects_to_main``), which alone writes files.

Environment contract (``tools/train.py`` calls ``maybe_initialize_distributed``
first):

  DAFNE_COORDINATOR=host:port + DAFNE_NUM_PROCESSES + DAFNE_PROCESS_ID
                              -> an explicit cluster (the coordinator may be
                                 a file:// URL on a shared file system);
                                 LOCAL_RANK (default: the process id) picks
                                 the card
  DAFNE_DISTRIBUTED=auto      -> the launcher's RANK, WORLD_SIZE, LOCAL_RANK,
                                 MASTER_ADDR and MASTER_PORT (torchrun)
  DAFNE_CPU_COLLECTIVES=gloo  -> collectives through gloo, on the host
  otherwise                   -> NCCL on a CUDA device, gloo on the CPU
  DAFNE_DIST_TIMEOUT_S        -> seconds to wait for the peers (default 600)

With one process nothing here runs a collective: every helper returns its
input, so a single process keeps its one-device code path.  gloo has no
gather of CUDA tensors, and NCCL none of objects on the host, so the
gathers of evaluation outputs go through the host as pickled objects: over
the default group under gloo, over a gloo group of its own under NCCL.
The reductions go through the host under gloo too.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("dafne_torch")

#: the card of this process and the gloo group of the host-side gathers
_STATE: Dict[str, object] = {"local_rank": 0, "host_group": None}


def _cluster(env) -> Optional[dict]:
    """(init method, world size, rank, local rank) from the environment, or
    None when it asks for no cluster."""
    if env.get("DAFNE_DISTRIBUTED", "") == "auto":
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"DAFNE_DISTRIBUTED=auto but the launcher set no {missing}")
        return {"init_method": f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                "world_size": int(env["WORLD_SIZE"]), "rank": int(env["RANK"]),
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}
    if env.get("DAFNE_COORDINATOR", ""):
        rank = int(env["DAFNE_PROCESS_ID"])
        coord = env["DAFNE_COORDINATOR"]
        return {"init_method": coord if coord.startswith("file://") else f"tcp://{coord}",
                "world_size": int(env["DAFNE_NUM_PROCESSES"]), "rank": rank,
                "local_rank": int(env.get("LOCAL_RANK", rank))}
    return None


def maybe_initialize_distributed(env=None, device: str = "cuda") -> bool:
    """Form the process group if the environment asks for one, for a run on
    `device` ("cuda" or "cpu").  Returns False when it asks for nothing.
    Raises when the peers cannot be reached or the group cannot form:
    there is no quiet return to one process."""
    env = os.environ if env is None else env
    cluster = _cluster(env)
    if cluster is None:
        return False
    on_card = torch.device(device).type == "cuda"
    backend = env.get("DAFNE_CPU_COLLECTIVES", "") or ("nccl" if on_card else "gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"DAFNE_CPU_COLLECTIVES must be gloo, got {backend!r}")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(f"a distributed run on {device} asked for, but no GPU is visible")
        if cluster["local_rank"] >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {cluster['local_rank']} but "
                               f"{torch.cuda.device_count()} GPU(s) visible")
        torch.cuda.set_device(cluster["local_rank"])
    elif backend == "nccl":
        raise ValueError("NCCL collectives need a CUDA device")
    timeout = datetime.timedelta(seconds=float(env.get("DAFNE_DIST_TIMEOUT_S", 600)))
    dist.init_process_group(backend, init_method=cluster["init_method"],
                            world_size=cluster["world_size"], rank=cluster["rank"],
                            timeout=timeout)
    _STATE["local_rank"] = cluster["local_rank"]
    _STATE["host_group"] = (dist.new_group(backend="gloo", timeout=timeout)
                            if backend == "nccl" else dist.group.WORLD)
    logger.info(f"distributed: process {process_index()}/{process_count()} ({backend}), "
                f"local rank {cluster['local_rank']}")
    # every process meets here before any model building: a peer that
    # cannot join (or a backend that refuses the layout) fails now
    barrier()
    logger.info("distributed: startup barrier passed")
    return True


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(local_rank=0, host_group=None)


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_batch_slice(global_batch: int):
    """This process's contiguous row range [lo, hi) of a global batch:
    process p holds rows p*B/P .. (p+1)*B/P."""
    pc = process_count()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} does not split over {pc} processes")
    per = global_batch // pc
    p = process_index()
    return p * per, (p + 1) * per


def local_device(requested="cuda") -> torch.device:
    """The device this process runs on: the CPU only when `requested` is
    the CPU; else the card, ``cuda:LOCAL_RANK`` in a process group.
    Raises when a card is asked for and none is visible."""
    dev = torch.device(requested)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {requested!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {requested!r} asked for, but no GPU is visible")
    if process_count() > 1 or (dist.is_available() and dist.is_initialized()):
        return torch.device("cuda", int(_STATE["local_rank"]))
    return dev


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def _through_host() -> bool:
    return dist.get_backend() == "gloo"


def barrier() -> None:
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[int(_STATE["local_rank"])])
        else:
            dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the processes of `t` (a new tensor on `t`'s device; `t`
    itself with one process).  No gradient flows through it."""
    if process_count() == 1:
        return t
    out = t.detach().to("cpu", copy=True) if _through_host() else t.detach().clone()
    dist.all_reduce(out)
    return out.to(t.device)


class GlobalSum(torch.autograd.Function):
    """The sum over the processes, with the gradient: the total loss is the
    sum of the processes' losses, so the gradient at the sum is the sum of
    the processes' gradients, handed back to each (as SyncBatchNorm's)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous())


def all_reduce_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each parameter's gradient by its sum over the processes, in
    one all-reduce per dtype over the flattened gradients.  Parameters
    without a gradient stay without one (the same on every process: they
    run the same model)."""
    if process_count() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_state_(module: torch.nn.Module) -> None:
    """Process 0's parameters and buffers, copied into every process's
    `module`: one broadcast per dtype over the flattened tensors."""
    if process_count() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            buf = flat.cpu() if _through_host() else flat
            dist.broadcast(buf, src=0)
            flat = buf.to(flat.device)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def gather_to_main(arrays: Dict[str, np.ndarray]) -> Optional[Dict[str, np.ndarray]]:
    """Each process's row blocks of `arrays`, concatenated along the rows in
    process order on process 0 (None elsewhere), through the host."""
    parts = gather_objects_to_main(arrays)
    if parts is None or len(parts) == 1:
        return parts and parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in arrays}


def broadcast_from_main(obj):
    """Process 0's `obj` (picklable) on every process, through the host: a
    decision every process must share, such as TPU.TRAIN_DEVICE_AUG's
    "auto", which reads this host's cores."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_STATE["host_group"])
    return box[0]


def gather_objects_to_main(obj) -> Optional[list]:
    """Every process's `obj` (picklable), in process order, on process 0
    (None elsewhere), through the host."""
    if process_count() == 1:
        return [obj]
    main = is_main_process()
    parts = [None] * process_count() if main else None
    dist.gather_object(obj, parts, dst=0, group=_STATE["host_group"])
    return parts
