"""The split-K dW pass that K2, K5 and K7 share (``csrc/tile_mm.cuh``).

For every task ``(a0, M, d0, N, off)``: ``dW[m, n] = sum_p act[p, a0 + m]
delta[p, d0 + n]``, or ``db[n] = sum_p delta[p, d0 + n]`` when ``a0 = -1``.
The points are cut into ``splits`` fixed ranges of whole chunks of ``PK``
points (``chunks_per_split``); each split writes an fp32 partial
``partials[split, off + m N + n]`` and the partials are summed in split
order.  It replaces the dW accumulation over the sequential grids of
``msra_practice_project_tpu/ops/pallas/nerf_mlp.py::_grad_body`` and of
``film_mlp.py::_bwd_kernel``.

``dw_splitk_plain`` is the plain version.  ``dw_splitk`` launches the bf16
kernel alone on CUDA tensors (``tile_mm_dw_splitk_bf16``, exported by both
libraries); K2, K5 and K7 launch it from their own C entries, and their
wrappers add those launches to ``dw_splitk.launches``.
"""

from __future__ import annotations

import ctypes

import torch

PK = 32  # points per chunk: a split is whole chunks (tile_mm.cuh's PK)


def chunks_per_split(n: int, splits: int) -> int:
    """Chunks of ``PK`` points per split when ``n`` points (a multiple of
    ``PK``) are cut into ``splits`` (``tile_mm.cuh::chunks_per_split``)."""
    return (n // PK + splits - 1) // splits


def split_ranges(n: int, splits: int) -> list:
    """The ``(lo, hi)`` point range of each split; the last ones may be
    short or empty."""
    per = chunks_per_split(n, splits) * PK
    return [(min(s * per, n), min((s + 1) * per, n)) for s in range(splits)]


def task_total(tasks) -> int:
    """The extent of the flat gradient the tasks write."""
    return max(off + m * n for _, m, _, n, off in tasks)


def dw_splitk_plain(acts: torch.Tensor, deltas: torch.Tensor, tasks,
                    splits: int):
    """(partials ``[splits, total]``, dw ``[total]``), fp32: each split's
    products in fp32 over its point range, then the splits summed in split
    order."""
    n = acts.shape[0]
    if n % PK or deltas.shape[0] != n:
        raise ValueError(f"point count {n} is not a multiple of {PK} or "
                         "differs between acts and deltas")
    total = task_total(tasks)
    partials = torch.zeros((splits, total), dtype=torch.float32,
                           device=acts.device)
    for s, (lo, hi) in enumerate(split_ranges(n, splits)):
        a, d = acts[lo:hi].float(), deltas[lo:hi].float()
        for a0, m, d0, nn, off in tasks:
            dd = d[:, d0:d0 + nn]
            g = dd.sum(dim=0) if a0 < 0 else a[:, a0:a0 + m].t() @ dd
            partials[s, off:off + m * nn] = g.reshape(-1)
    dw = partials[0].clone()
    for s in range(1, splits):
        dw += partials[s]
    return partials, dw


def _lib():
    from .build import load

    lib = load("nerf_mlp")
    fn = lib.tile_mm_dw_splitk_bf16
    if not getattr(fn, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, i, i, ctypes.POINTER(i), i, p]
        fn.restype = i
        fn._argtypes_set = True
    return fn


def dw_splitk(acts: torch.Tensor, deltas: torch.Tensor, tasks, splits: int):
    """The pass alone: (partials ``[splits, total]``, dw ``[total]``), fp32.
    CPU tensors take the plain version; CUDA tensors (bf16, contiguous,
    16-byte aligned rows) launch ``tile_mm.cuh``'s kernel and its
    fixed-order sum."""
    if acts.device.type == "cpu":
        return dw_splitk_plain(acts, deltas, tasks, splits)
    if acts.device.type != "cuda":
        raise ValueError(f"unsupported device {acts.device}")
    n = acts.shape[0]
    for name, t in (("acts", acts), ("deltas", deltas)):
        if (t.device != acts.device or t.dtype != torch.bfloat16
                or t.dim() != 2 or t.shape[0] != n or not t.is_contiguous()
                or (t.data_ptr() | t.shape[1] * 2) % 16):
            raise ValueError(f"{name} must be a contiguous bf16 [{n}, cols] "
                             f"tensor on {acts.device} with 16-byte aligned "
                             "rows")
    total = task_total(tasks)
    partials = torch.empty((splits, total), dtype=torch.float32,
                           device=acts.device)
    dw = torch.empty(total, dtype=torch.float32, device=acts.device)
    flat = [v for row in tasks for v in row]
    with torch.cuda.device(acts.device):
        err = _lib()(acts.data_ptr(), acts.shape[1], deltas.data_ptr(),
                     deltas.shape[1], partials.data_ptr(), dw.data_ptr(), n,
                     splits, (ctypes.c_int * len(flat))(*flat), len(tasks),
                     ctypes.c_void_p(
                         torch.cuda.current_stream(acts.device).cuda_stream))
    if err:
        raise RuntimeError(f"tile_mm_dw_splitk_bf16 launch failed: CUDA "
                           f"error {err}")
    dw_splitk.launches += 1
    return partials, dw


dw_splitk.launches = 0
KERNELS = (dw_splitk,)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
