"""The device mesh and its collectives on torch.distributed: the port's
counterpart of nbody_tpu's 1-D ``jax.sharding.Mesh`` (axis "bodies") and
of the ``jax.lax`` collectives ``parallel/shard.py`` calls.

A rank is one process.  Every rank of a mesh runs the same code on its
own slab (SPMD); a collective is a call that every rank makes.  The
caller names the backend, and ``make_mesh`` checks it against the
machine:

  * ``"nccl"``: CUDA tensors, one GPU per rank (rank r on cuda:r);
  * ``"gloo"``: CPU tensors, or CUDA tensors of ranks that share one
    card.  gloo takes CUDA tensors in some collectives only (not in
    send/recv or all_to_all), so on a CUDA mesh every collective here
    is staged through pinned host buffers, and the staged bytes are
    counted apart.

A request the machine cannot serve (nccl with more ranks than GPUs, a
CUDA mesh without a GPU) raises; nothing carries on on the CPU.

``Mesh.stats`` counts, per collective, the calls and the bytes of its
result on this rank (all_gather: the gathered array; psum: the sum;
ppermute: both received halves; all_to_all: the received blocks), and
under "staged" the bytes copied between the card and the host and under
"staged_syncs" the copies to the host, each of which waits for the
card.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh of `size` ranks."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None     # None: the default group
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def staged(self) -> bool:
        """Collectives go through pinned host buffers (gloo on CUDA)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def check_backend(backend: str, device, world_size: int) -> torch.device:
    """The device a mesh of `world_size` ranks on `backend` would use
    ("cuda" when `device` is None); raises when this machine cannot
    serve the request."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device and none is "
                               "present; pass device='cpu' with backend "
                               "'gloo' to run on the CPU")
        if backend == "nccl" and torch.cuda.device_count() < world_size:
            raise RuntimeError(
                f"nccl needs one GPU per rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} GPUs; ranks that share a card "
                "take backend 'gloo'")
    elif dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl takes CUDA tensors only; a CPU mesh takes "
                             "backend 'gloo'")
    else:
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def make_mesh(n_devices: Optional[int], backend: str, device=None) -> Mesh:
    """This rank's mesh over the initialised default process group.

    n_devices: the mesh size, which must be the world size (None: the
    world size).  backend: the process group's backend, named by the
    caller.  device: "cuda" (the default) or "cpu"; with nccl rank r
    takes cuda:r, with gloo every rank takes the one card named (cuda:0
    unless an index is given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/launch.spawn starts one per rank)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, size):
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{size} ranks")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    dev = check_backend(backend, device, size)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, backend=backend)


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def axis_size(mesh: Mesh) -> int:
    return mesh.size


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _send(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x as the backend takes it: contiguous, bool as uint8, and on a
    staged mesh in a pinned host buffer."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if not mesh.staged:
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)                       # waits for the stream: a host sync
    mesh.stats["staged"] += _nbytes(x)
    mesh.stats["staged_syncs"] += 1
    return host


def _buffer(like: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """A receive buffer of `rows` rows shaped as `like` (pinned on a
    staged mesh, so the copy to the card runs asynchronously)."""
    return torch.empty((rows,) + tuple(like.shape[1:]), dtype=like.dtype,
                       device=like.device, pin_memory=mesh.staged)


def _count(kind: str, mesh: Mesh, *ys: torch.Tensor) -> None:
    mesh.stats[kind] += sum(_nbytes(y) for y in ys)
    mesh.stats[f"{kind}_calls"] += 1


def _recv(y: torch.Tensor, dtype: torch.dtype, mesh: Mesh) -> torch.Tensor:
    """A collective's result back on the mesh device, in `dtype`."""
    if mesh.staged:
        mesh.stats["staged"] += _nbytes(y)
        y = y.to(mesh.device, non_blocking=True)
    return y.to(dtype) if y.dtype != dtype else y


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x (same shape on every rank) concatenated along dim
    0 in rank order (jax.lax.all_gather, then the leading axes merged)."""
    dtype = x.dtype
    xs = _send(x, mesh)
    out = _buffer(xs, mesh.size * xs.shape[0], mesh)
    dist.all_gather(list(out.chunk(mesh.size)), xs, group=mesh.group)
    _count("all_gather", mesh, out)
    return _recv(out, dtype, mesh)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise sum of x over the ranks (jax.lax.psum)."""
    if x.dtype == torch.bool:
        raise TypeError("psum of bool: sum an integer count")
    out = _send(x, mesh).clone()
    dist.all_reduce(out, group=mesh.group)
    _count("psum", mesh, out)
    return _recv(out, x.dtype, mesh)


def ppermute_ring(to_right: torch.Tensor, to_left: torch.Tensor,
                  mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring pair of jax.lax.ppermute: every rank sends `to_right` to
    rank + 1 and `to_left` to rank - 1 (mod size), and gets (its left
    neighbour's to_right, its right neighbour's to_left)."""
    if mesh.size == 1:
        return to_right.clone(), to_left.clone()
    dtype = to_right.dtype
    r_send, l_send = _send(to_right, mesh), _send(to_left, mesh)
    from_left = _buffer(r_send, r_send.shape[0], mesh)
    from_right = _buffer(l_send, l_send.shape[0], mesh)
    right = (mesh.rank + 1) % mesh.size
    left = (mesh.rank - 1) % mesh.size
    # tags tell the two directions apart when both neighbours are one rank
    ops = [dist.P2POp(dist.isend, r_send, right, mesh.group, tag=0),
           dist.P2POp(dist.isend, l_send, left, mesh.group, tag=1),
           dist.P2POp(dist.irecv, from_left, left, mesh.group, tag=0),
           dist.P2POp(dist.irecv, from_right, right, mesh.group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("ppermute", mesh, from_left, from_right)
    return _recv(from_left, dtype, mesh), _recv(from_right, dtype, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [size * k, ...]: block i (rows i*k .. i*k + k - 1) goes to rank
    i; returns the blocks received, block j from rank j, concatenated
    (jax.lax.all_to_all with split_axis = concat_axis = 0, tiled)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split into {mesh.size} "
                         "blocks")
    dtype = x.dtype
    xs = _send(x, mesh)
    out = _buffer(xs, xs.shape[0], mesh)
    dist.all_to_all_single(out, xs, group=mesh.group)
    _count("all_to_all", mesh, out)
    return _recv(out, dtype, mesh)
