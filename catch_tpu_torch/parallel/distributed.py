"""A process group: the mesh across processes.

Port of catch_tpu/parallel/distributed.py over torch.distributed.  Each
process (a *rank*) owns the places it sees (parallel/mesh.py
visible_places), and once the group is initialized make_mesh() spans
every rank's places in rank order, as jax.devices() orders them by
process.  What crosses ranks:

- nothing during the design scan: every rank scans the whole instance
  on its own places (ops/scan_instance.scan_places), as catch_tpu's
  scan keeps to the process's own devices;
- the span scan's verified spans (ops/scan_sparse.verify_spans_sharded):
  each rank verifies the candidate blocks of its own places, then the
  ranks exchange their spans;
- two exchanges every step of the sharded greedy solve
  (parallel/set_cover.py): the places' candidate slots, then the chosen
  set's update row.

The backend is gloo, for the CPU and for the card alike.  Every message
between ranks goes through host tensors, staged explicitly: device ->
pinned host -> gloo -> device.  NCCL and copies between distinct cards
are the card half of ROADMAP queue 1 item 10b (queue 1, item 4): the
machines the port was run on hold one card, and NCCL refuses two ranks
on one card.  Nothing switches backend on a failure, and a failed
initialization raises.

Launch (2 processes; any host:port the ranks can reach):
    CATCH_TPU_COORDINATOR=host0:8476 CATCH_TPU_NUM_PROCESSES=2 \
        CATCH_TPU_PROCESS_ID=0 python -m catch_tpu_torch.cli.design ...
    CATCH_TPU_COORDINATOR=host0:8476 CATCH_TPU_NUM_PROCESSES=2 \
        CATCH_TPU_PROCESS_ID=1 python -m catch_tpu_torch.cli.design ...
or, under a launcher that sets MASTER_ADDR, MASTER_PORT, RANK and
WORLD_SIZE (torchrun), CATCH_TPU_MULTIHOST=1 alone.
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["maybe_initialize", "is_initialized", "process_index",
           "process_count", "all_gather_rows", "all_reduce_sum",
           "all_reduce_max", "all_gather_object"]

# How long a rank waits for the others, at initialization and in every
# exchange, before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


def maybe_initialize(timeout=TIMEOUT):
    """Initialize a gloo process group from the environment, if asked.

    CATCH_TPU_COORDINATOR (host:port) with CATCH_TPU_NUM_PROCESSES and
    CATCH_TPU_PROCESS_ID initializes over tcp://host:port; or
    CATCH_TPU_MULTIHOST=1 alone takes the launcher's env:// variables
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).  With none of them
    set, nothing happens.  A rank that does not hear from the others
    within `timeout` (a datetime.timedelta) raises.

    Returns True when running with an initialized process group.
    """
    if is_initialized():
        return True
    coord = os.environ.get("CATCH_TPU_COORDINATOR")
    auto = os.environ.get("CATCH_TPU_MULTIHOST")
    if not coord and not auto:
        return False
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["CATCH_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["CATCH_TPU_PROCESS_ID"]), timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    logger.info("torch.distributed initialized: process %d of %d",
                process_index(), process_count())
    return True


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1


def _to_host(x):
    """x on the host, pinned where it lies on a card (the copy waits for
    the card's stream)."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def all_gather_rows(x, counts):
    """Every rank's rows of `x`, joined in rank order on x's device.

    x: a tensor whose first axis holds this rank's counts[rank] rows;
    counts: the rows of every rank (a list equal on every rank).  gloo's
    all_gather needs equal shapes, so each rank sends max(counts) rows,
    zero-padded.
    """
    rank = process_index()
    if x.shape[0] != counts[rank]:
        raise ValueError(f"rank {rank} holds {x.shape[0]} rows, not "
                         f"{counts[rank]}")
    width = max(counts)
    sent = torch.zeros((width, *x.shape[1:]), dtype=x.dtype)
    sent[:x.shape[0]] = _to_host(x)
    got = [torch.empty_like(sent) for _ in counts]
    dist.all_gather(got, sent)
    joined = torch.cat([g[:c] for g, c in zip(got, counts)])
    if x.device.type == "cpu":
        return joined
    # the copy to the card is queued on its stream from pinned memory
    return joined.pin_memory().to(x.device, non_blocking=True)


def _all_reduce(x, op):
    host = _to_host(x).clone()
    dist.all_reduce(host, op=op)
    return host.to(x.device, non_blocking=True)


def all_reduce_sum(x):
    """The sum of `x` over the ranks, on x's device."""
    return _all_reduce(x, dist.ReduceOp.SUM)


def all_reduce_max(x):
    """The elementwise maximum of `x` over the ranks, on x's device."""
    return _all_reduce(x, dist.ReduceOp.MAX)


def all_gather_object(obj):
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out
