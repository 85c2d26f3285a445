"""Several processes: the ``torch.distributed`` group behind ``--coordinator
HOST:PORT --num-processes N --process-id i`` (the port's counterpart of
``jax.distributed.initialize`` in sylph_tpu/cli.py:269-278) and the host
merge of per-process grange histograms (the counterpart of
``multihost_utils.process_allgather`` in sylph_tpu/tpu/grange.py:
1731-1745).

Every process runs the same command. The grange engine gives process i the
chunks j with j % N == i, each process sweeps its own chunks on its own
devices, and ``allreduce_sum`` sums the [G, 64] int64 partial histograms on
the host, so every process goes on with the same merged histogram and
computes the same rows; only process 0 writes them.

The CLI's group is gloo: it carries only these host histograms. The
one-shot sharded step (gpu/pipeline.py::make_sharded_profile_step) runs on
a group its caller creates with ``init_group``, NCCL or gloo. Every group
is created with a finite timeout, so a process whose peer never comes fails
instead of waiting for ever. Outside a group ``process_count`` is 1 and
``process_index`` 0, and nothing here talks to another process.
"""

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 300.0    # rendezvous and collectives (jax.distributed's default)


def init_group(address: str, world_size: int, rank: int,
               backend: str = "gloo") -> None:
    """Join the process group of ``world_size`` processes whose rank 0
    listens at ``address`` (HOST:PORT), as ``rank``, over ``backend``.
    Raises where the group cannot be formed within the timeout, or where
    this process already belongs to one."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"process id {rank} is outside 0..{world_size - 1}")
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not HOST:PORT")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def init_from_flags(coordinator: Optional[str],
                    num_processes: Optional[int],
                    process_id: Optional[int]) -> bool:
    """The CLI's ``--coordinator/--num-processes/--process-id``: a gloo
    group when a coordinator is given (True), nothing otherwise (False).
    The coordinator is the address process 0 listens on."""
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    init_group(coordinator, num_processes, process_id)
    return True


def shutdown() -> None:
    """Leave the process group, if this process belongs to one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_collective(fn, t: torch.Tensor, group=None) -> torch.Tensor:
    """Run ``fn(t_on_host)`` where the group's backend is gloo and ``t``
    lies on a GPU (two ranks on one card share it through gloo), and
    ``fn(t)`` elsewhere; the result lies where ``t`` lay. The backend is
    the group's, chosen by whoever created it: nothing here switches it."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return fn(t.cpu()).to(t.device)
    return fn(t)


def allreduce_sum(partial: np.ndarray) -> np.ndarray:
    """The sum over every process of the group of its int64 array
    ``partial`` (equal shapes), reduced on the host over the CLI's gloo
    group; ``partial`` itself outside a group."""
    if process_count() == 1:
        return partial
    t = torch.from_numpy(np.array(partial, np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()
