"""Process-group meshes over ciphertext batches — counterpart of
``hhe_tpu.parallel.mesh``.

The JAX package places one global array on every device from a single
controller and lets XLA propagate its sharding.  PyTorch is SPMD: one
process per device (``torch.cuda.set_device(local_rank)``), each holding
only its own shard, so the batch split and the gather back are explicit
here.  Axes, as in the JAX package:

- ``batch``: the ciphertext/sample batch, pure data parallel: each rank
  transciphers and evaluates its own samples with no communication, and
  ``gather_batch`` returns the whole batch to every rank;
- ``limb``: the RNS limbs.  Where the axis's d ranks divide a tensor's k
  limbs, rank r holds the r-th contiguous block of k/d (``limb_range``,
  ``shard_limbs``; ``gather_limbs`` joins them back), as a ``NamedSharding``
  places them; otherwise every rank keeps all k, as the JAX package does.
  Evaluating on a rank's limbs takes ``limb_shard.LimbView``, which does
  the collectives XLA inserts inside every key-switch and base conversion.

``make_mesh`` is ``jax.make_mesh``'s counterpart for any axis names (the
four-step NTT takes a one-axis ``("poly",)`` mesh).  A mesh spans every rank
of the default process group; without one, a one-rank group on an in-memory
store is made, so a single process needs no address.  CUDA ranks talk over
NCCL, CPU ranks (``device="cpu"``) over gloo.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..ops import bfv


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join a multi-process group (no-op for one process): rank
    ``process_id`` of ``num_processes``, rendezvous at ``host:port``.  On
    CUDA each process takes card ``process_id % cuda.device_count()``."""
    if not num_processes or num_processes <= 1:
        return
    dev = bfv.resolve_device(device)
    kwargs = {}
    if dev.type == "cuda":
        kwargs["device_id"] = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(kwargs["device_id"])
    addr = coordinator_address or ""
    dist.init_process_group(
        _backend(dev),
        init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )


def _ensure_group(device: torch.device) -> None:
    if not dist.is_initialized():
        kwargs = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(
            _backend(device), store=dist.HashStore(), rank=0, world_size=1, **kwargs
        )


class Mesh:
    """A named mesh of this process group's ranks: torch's ``DeviceMesh``,
    with ``shape`` the ``{axis: size}`` mapping of a JAX mesh and the device
    this rank computes on."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.shape))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None) -> Mesh:
    """A mesh of the given axis sizes over every rank of the process group
    (their product must be its size); ``device`` defaults to CUDA."""
    dev = bfv.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _ensure_group(dev)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {int(np.prod(shape))} ranks; the group has {world}")
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axis_names))
    return Mesh(dm, dev)


def make_hhe_mesh(
    n_devices: Optional[int] = None, limb_shards: int = 1, device=None
) -> Mesh:
    """Mesh with ("batch", "limb") axes over the group's ranks (one per
    device): ``shape == {"batch": n // limb_shards, "limb": limb_shards}``."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % limb_shards:
        raise ValueError(f"{limb_shards} limb shards do not divide {n} devices")
    return make_mesh((n // limb_shards, limb_shards), ("batch", "limb"), device)


def batch_sharding(mesh: Mesh):
    """Placements of a batched ciphertext [size, B, k, N] over the mesh axes
    (``torch.distributed.tensor`` placements, one per axis): samples split
    over ``batch``, limbs over ``limb`` (where the axis divides k;
    ``shard_ciphertext_batch`` keeps them whole otherwise, as the JAX
    package's ``P(None, "batch", "limb", None)`` placement does)."""
    return tuple(Shard(1) if a == "batch" else Shard(2) for a in mesh.axis_names)


def replicated(mesh: Mesh):
    return tuple(Replicate() for _ in mesh.axis_names)


def local_batch(arr, mesh: Mesh, axis: int = 0):
    """This rank's contiguous share of a batch that divides the ``batch``
    axis (rank r of d takes the r-th of d equal blocks, as a JAX sharding
    does)."""
    d, r = mesh.shape["batch"], mesh.rank("batch")
    n = arr.shape[axis]
    if n % d:
        raise ValueError(f"batch of {n} does not divide the mesh's {d} batch ranks; pad_batch it")
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(r * (n // d), (r + 1) * (n // d))
    return arr[tuple(idx)]


def limb_range(k: int, mesh: Mesh) -> range:
    """The limbs of a k-limb tensor that this rank holds: the r-th of d
    contiguous blocks when the mesh's ``limb`` axis (d ranks) divides k, all
    k otherwise (``hhe_tpu.parallel.mesh.shard_ciphertext_batch``'s rule)."""
    d = mesh.shape["limb"]
    if k % d:
        return range(k)
    r, w = mesh.rank("limb"), k // d
    return range(r * w, (r + 1) * w)


def _take_limbs(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    limbs = limb_range(data.shape[-2], mesh)
    return data[..., limbs.start : limbs.stop, :]


def shard_ciphertext_batch(ct: bfv.Ciphertext, mesh: Mesh) -> bfv.Ciphertext:
    """This rank's block of a batched ciphertext [size, B, k, N] on the
    mesh's device: its samples (``local_batch``) and its limbs
    (``limb_range``: all k where the ``limb`` axis does not divide them)."""
    data = ct.data
    if data.dim() != 4:
        raise ValueError(f"expected a batched ciphertext [size, B, k, N], got {tuple(data.shape)}")
    local = _take_limbs(local_batch(data, mesh, axis=1), mesh)
    return bfv.Ciphertext(local.to(mesh.device).contiguous())


def shard_limbs(ct: bfv.Ciphertext, mesh: Mesh) -> bfv.Ciphertext:
    """This rank's limbs (``limb_range``) of an unbatched ciphertext
    [size, k, N], such as the encrypted PASTA key: the placement
    ``P(None, "limb", None)`` of the JAX package's sharded keystream."""
    if ct.data.dim() != 3:
        raise ValueError(f"expected a ciphertext [size, k, N], got {tuple(ct.data.shape)}")
    return bfv.Ciphertext(_take_limbs(ct.data, mesh).to(mesh.device).contiguous())


def gather_limbs(x: torch.Tensor, mesh: Mesh, axis: int = -2) -> torch.Tensor:
    """Every limb on every rank: each ``limb`` rank's block of ``x`` along
    ``axis`` (a block ``limb_range`` split off), concatenated in rank
    order.  Only for split tensors: a whole one would come back d times."""
    parts = [torch.empty_like(x) for _ in range(mesh.shape["limb"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group("limb"))
    return torch.cat(parts, dim=axis)


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """The whole batch on every rank: each ``batch`` rank's share of ``x``
    along ``axis``, concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.shape["batch"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group("batch"))
    return torch.cat(parts, dim=axis)


def pad_batch(arr: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad a sample batch so it divides the mesh batch axis; returns
    (padded, original_len)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(arr, pad_widths, mode="edge"), n
