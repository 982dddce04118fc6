"""Process groups: distributed init, the data group, batch shards.

Port of ``openpifpaf_tpu/parallel/mesh.py``.  JAX builds one global mesh
over every chip and lets XLA insert the gradient ``psum``; the port runs
one process per card in a ``torch.distributed`` group, as the reference
trains (DDP over NCCL).  The backend follows the device: NCCL for
``cuda``, gloo for ``cpu``, unless the caller names one (gloo also takes
CUDA tensors, in ``all_reduce`` and ``broadcast`` only, which lets several
ranks share one card).

``all_gather`` is the one gathering collective the port uses: it
concatenates every rank's tensor along the first axis.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import pickle
import queue as queue_mod
import socket
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..ops import common

LOG = logging.getLogger(__name__)

ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device: torch.device) -> str:
    return 'nccl' if device.type == 'cuda' else 'gloo'


def initialize_distributed(device=None, backend: Optional[str] = None
                           ) -> Optional[torch.device]:
    """Join the process group that torchrun's ``env://`` variables
    describe (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK``
    for the card (``device=None``), else ``device``.

    Without those variables it does nothing and returns ``None``, as the
    JAX version does without ``JAX_COORDINATOR``.  A failed rendezvous
    raises: going on would train independent copies on split data.
    """
    if not all(name in os.environ for name in ENV):
        missing = [name for name in ENV if name not in os.environ]
        LOG.info('distributed: %s not set, one process', ', '.join(missing))
        return None
    device = resolve_device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or backend_for(device),
                                init_method='env://', timeout=TIMEOUT)
    LOG.info('distributed: rank %d of %d on %s over %s', dist.get_rank(),
             dist.get_world_size(), device, dist.get_backend())
    return device


def data_group():
    """The group the data is split over: the default group, or ``None``
    in a single process."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def shard_batch(batch, group=None):
    """This rank's contiguous slice of a host batch (a tensor, or a list,
    tuple or dict of them), cut along the first axis into equal parts."""
    n, r = world(group), rank(group)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if x.shape[0] % n:
            raise ValueError(f'batch of {x.shape[0]} does not split into '
                             f'{n} equal shards')
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per]

    return cut(batch)


@torch.no_grad()
def replicate(module: nn.Module, group=None) -> None:
    """Rank 0's parameters and buffers on every rank (a broadcast over the
    default group, whose rank 0 is the source)."""
    if world(group) == 1:
        return
    for tensor in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(tensor.data, src=0, group=group)


def _host_staged(tensor: torch.Tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == 'gloo'


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group, in place.  gloo carries a CUDA tensor
    through host memory and the caller waits for it: one host sync,
    counted in ``common.HOST_SYNCS``.  Outside a group it returns
    ``tensor`` as it is."""
    if not dist.is_initialized():
        return tensor
    if _host_staged(tensor, group):
        common.HOST_SYNCS += 1
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` (the same shape on each) concatenated along
    the first axis, in rank order.  gloo gathers no CUDA tensor: there
    each rank writes its rows into zeros and an ``all_reduce`` sums them,
    which is exact (``x + 0 == x``)."""
    n, r = world(group), rank(group)
    if n == 1:
        return tensor
    dtype = tensor.dtype
    x = tensor.contiguous()
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    rows = x.shape[0]
    if _host_staged(x, group):
        out = x.new_zeros((n * rows,) + tuple(x.shape[1:]))
        out[r * rows:(r + 1) * rows] = x
        all_reduce(out, group)
    else:
        out = x.new_empty((n * rows,) + tuple(x.shape[1:]))
        # all_gather_into_tensor's new name, where torch has it
        gather = getattr(dist, 'all_gather_single',
                         dist.all_gather_into_tensor)
        gather(out, x, group=group)
    return out.to(dtype)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _group_worker(rank_: int, world_: int, port: int, device: str,
                  backend: str, fn: Callable, args: tuple, results) -> None:
    # one CPU thread a rank, so that the ranks do not oversubscribe the
    # host's cores (and the same for what a rank starts)
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world_),
                      LOCAL_RANK='0' if backend == 'gloo' else str(rank_),
                      MASTER_ADDR='localhost', MASTER_PORT=str(port),
                      OMP_NUM_THREADS='1')
    torch.set_num_threads(1)
    try:
        local = initialize_distributed(device, backend)
        # by value: torch's queue would pass tensors by shared memory,
        # which dies with this process
        results.put((rank_, None, pickle.dumps(fn(local, *args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank_, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(fn: Callable, world_: int, args: tuple = (), *,
              device: str = 'cpu', backend: Optional[str] = None,
              timeout: float = 600.0) -> list:
    """``fn(device, *args)`` in each of ``world_`` fresh processes (the
    ``spawn`` start method) joined in a group over ``localhost``; returns
    the ranks' results (on the CPU) in rank order and raises if any rank
    failed or did not finish within ``timeout`` seconds.  With the gloo backend every
    rank of a ``cuda`` group uses ``cuda:0``; with NCCL rank r uses
    ``cuda:r``.  Each rank runs on one CPU thread (``OMP_NUM_THREADS=1``).
    ``fn`` and ``args`` are pickled: ``fn`` must be importable by name."""
    backend = backend or backend_for(torch.device(device))
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_group_worker,
                         args=(r, world_, port, device, backend, fn, args,
                               results))
             for r in range(world_)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(world_):
            r, error, value = results.get(timeout=timeout)
            if error:
                errors.append(f'rank {r}:\n{error}')
            got[r] = None if error else pickle.loads(value)
    except queue_mod.Empty:
        errors.append(f'{world_ - len(got)} of {world_} ranks gave no '
                      f'result within {timeout} s')
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return [got[r] for r in range(world_)]
