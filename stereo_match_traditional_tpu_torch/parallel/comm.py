"""The collectives of the multi-device executors over ``torch.distributed``.

The JAX package runs one controller over a ``Mesh`` and names its
collectives by mesh axis (``ppermute``, ``all_to_all``, ``pmin`` /
``psum``, ``all_gather``).  The port runs one process a device (SPMD), and an
axis is a process group of a ``DeviceMesh`` (:class:`parallel.mesh.MeshAxis`):

==============================  ==========================================
JAX                             here
==============================  ==========================================
``lax.axis_index(axis)``        ``axis.index`` (``mesh.get_local_rank``)
``ppermute``                    :func:`exchange` (``batch_isend_irecv``)
``all_to_all(..., tiled=True)`` :func:`all_to_all` (``all_to_all_single``)
``pmin`` / ``pmax`` / ``psum``  :func:`all_reduce` (MIN / MAX / SUM)
``all_gather``                  :func:`all_gather`
==============================  ==========================================

Gloo's point-to-point ops take no CUDA tensors (torch 2.11 with CUDA 12.8:
its all-reduce, all-gather and all-to-all took them, its sends failed), so
on a gloo group every CUDA tensor is staged through host memory explicitly:
copied to the host, exchanged, and copied back onto its device.  That is the
only place where data leaves the card, and it happens for gloo groups alone
(processes sharing one card, or CPU runs); NCCL groups exchange CUDA tensors
as they are.  Booleans travel as uint8.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(axis, x: torch.Tensor) -> bool:
    """Whether ``x`` goes through host memory on ``axis``'s group: a CUDA
    tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def _wire(axis, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: uint8 for bool, on the host for a staged group;
    contiguous."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if _staged(axis, x):
        x = x.cpu()
    return x.contiguous()


def _empty_wire(axis, like: torch.Tensor) -> torch.Tensor:
    """An empty tensor shaped as ``like`` travels."""
    dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
    device = "cpu" if _staged(axis, like) else like.device
    return torch.empty(like.shape, dtype=dtype, device=device)


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received ``x`` on ``like``'s device with ``like``'s dtype."""
    return x.to(device=like.device, dtype=like.dtype)


def exchange(sends, recvs, axis) -> list:
    """Point-to-point exchange along ``axis``: ``sends`` is a list of
    ``(tensor, peer)``, ``recvs`` of ``(like, peer)`` with peers as indices
    along the axis; returns the received tensors, each shaped, typed and
    placed like its ``like``.  Every rank of the axis calls it with the
    operations that name it, as ``lax.ppermute``'s pairs do."""
    if not sends and not recvs:
        return []
    group = axis.group
    ops, bufs = [], []
    for x, peer in sends:
        ops.append(dist.P2POp(dist.isend, _wire(axis, x), dist.get_global_rank(group, peer),
                              group))
    for like, peer in recvs:
        buf = _empty_wire(axis, like)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_back(b, like) for b, (like, _) in zip(bufs, recvs)]


def all_reduce(x: torch.Tensor, op: str, axis) -> torch.Tensor:
    """The reduction ``op`` ('min', 'max' or 'sum') of ``x`` over ``axis``,
    a new tensor (``x`` is unchanged)."""
    reduce_op = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
                 "sum": dist.ReduceOp.SUM}[op]
    buf = _wire(axis, x)
    if buf is x or buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=reduce_op, group=axis.group)
    return _back(buf, x)


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` along ``axis``, in axis order."""
    buf = _wire(axis, x)
    parts = [_empty_wire(axis, x) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return _back(torch.stack(parts), x)


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` is ``[n, ...]`` with chunk ``k`` for rank ``k`` of ``axis``;
    returns ``[n, ...]`` whose chunk ``k`` came from rank ``k``
    (``lax.all_to_all(tiled=True)`` on contiguous chunks)."""
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all takes {axis.size} chunks, got {x.shape[0]}")
    buf = _wire(axis, x)
    out = _empty_wire(axis, x)
    dist.all_to_all_single(out, buf, group=axis.group)
    return _back(out, x)
