"""Data parallelism over ``torch.distributed`` (port of
``msra_practice_project_tpu/parallel/mesh.py``).

The JAX package lays a 1-D mesh over its chips: batches shard along the
'data' axis, parameters and optimizer state replicate, and XLA inserts the
gradient psum.  Here each rank is one process with a replica of the model
and of the optimizer state:

  * ``init_from_env`` joins the group that ``torchrun`` describes: NCCL when
    every local rank has a card of its own; any other layout raises unless
    the caller names a backend (a gloo world on one card is asked for by
    name, never a silent fallback);
  * ``local_slice`` keeps this rank's contiguous block of a global batch,
    rows ``[r*B/n, (r+1)*B/n)``, as ``P("data")`` lays a batch out;
  * ``all_reduce_grads`` averages the gradients in one flattened buffer,
    one collective per optimizer step (the counterpart of the psum);
  * ``broadcast_state`` copies rank 0's tensors to every rank;
  * ``all_gather_rows`` concatenates every rank's block on every rank
    (through the host where gloo holds CUDA tensors: gloo cannot gather
    them);
  * ``spawn`` runs a function in n processes joined over a file store (the
    dry run, the tests and the card's checks).

No ``DistributedDataParallel``: the NeRF step calls two models inside one
render and the discriminator step's R1 penalty differentiates twice, so the
trainers reduce explicitly after their backward.  Without a process group
every function here is the single-process identity.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0: the rank that writes logs, images and checkpoints."""
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def init_from_env(backend: str | None = None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns whether
    a group was joined (False outside ``torchrun``).

    With no ``backend``, NCCL serves a layout where every local rank has a
    card of its own, and the rank's card becomes the current device; any
    other layout raises.  ``backend="gloo"`` runs the ranks over gloo,
    on the CPU or on CUDA tensors of a shared card."""
    if "WORLD_SIZE" not in os.environ:
        return False
    n = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < local_n:
            raise RuntimeError(
                f"{local_n} local ranks and {cards} CUDA devices: NCCL needs "
                "a card per rank; pass the backend 'gloo' by name to run "
                "these ranks over gloo")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=n)
    return True


def local_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows (all of them without a
    group).  Raises when the rows do not divide over the ranks."""
    n = world()
    if n == 1:
        return x
    b = x.shape[0]
    if b % n:
        raise ValueError(f"{b} rows do not divide over {n} ranks")
    r = rank()
    return x[r * b // n:(r + 1) * b // n]


def check_divides(what: str, *sizes: int) -> None:
    """Raise unless every size divides over the ranks: a run that cannot
    split its batch must not quietly repeat the same work on every rank."""
    n = world()
    bad = [s for s in sizes if s % n]
    if bad:
        raise ValueError(f"{what} {bad} do not divide over {n} ranks")


def all_reduce_grads(params, *scalars):
    """Average every parameter's ``.grad`` over the ranks in place, in one
    flattened buffer and one collective (sum / world); ``scalars`` (0-d
    tensors, e.g. the step's losses) ride in the same buffer and come back
    averaged.  Without a process group it returns ``scalars`` unchanged."""
    if not initialized():
        return scalars
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise ValueError("every parameter needs a gradient before the "
                         "all-reduce")
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.as_tensor(s).reshape(1).to(grads[0])
                        for s in scalars])
    dist.all_reduce(flat)
    flat /= world()
    lo = 0
    for g in grads:
        g.copy_(flat[lo:lo + g.numel()].view_as(g))
        lo += g.numel()
    return tuple(flat[lo + i] for i in range(len(scalars)))


def broadcast_state(*modules) -> None:
    """Every tensor of the modules' state (parameters and buffers) from
    rank 0 to every rank, in place."""
    if not initialized():
        return
    with torch.no_grad():
        for m in modules:
            for t in m.state_dict().values():
                dist.broadcast(t, 0)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), concatenated along dim 0
    in rank order, on every rank.  Gloo gathers through the host."""
    if not initialized():
        return x
    via_host = x.is_cuda and dist.get_backend() != "nccl"
    src = (x.cpu() if via_host else x).contiguous()
    out = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(out, src)
    y = torch.cat(out)
    return y.to(x.device) if via_host else y


def _spawned(r, n, store, backend, timeout_s, threads, out_dir, fn, args):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(r)      # NCCL: a card per rank
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=r, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{r}.pt"))


def spawn(fn, n: int, args=(), backend: str = "gloo",
          timeout_s: float = 600.0, threads: int = 1) -> list:
    """Run ``fn(*args)`` in ``n`` fresh processes (the spawn start method)
    joined in one group over a file store; returns each rank's result in
    rank order; under NCCL rank r runs on card r.  ``fn`` must be
    importable by name (a module-level function) and its result picklable
    by ``torch.save``.  A rank that raises makes this raise."""
    out_dir = tempfile.mkdtemp(prefix="msra_torch_spawn_")
    try:
        torch.multiprocessing.spawn(
            _spawned, nprocs=n, join=True,
            args=(n, os.path.join(out_dir, "store"), backend, timeout_s,
                  threads, out_dir, fn, tuple(args)))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
