"""The data-parallel mesh and its collectives (ducosy_tpu/parallel/mesh.py).

The reference's only parallelism is nn.DataParallel over up to 8 GPUs
(modules/trainer.py:307,333-338); the JAX package carries it as a 1-D
``data`` mesh. Here a mesh is an ordered tuple of ``torch.device``s:

  - serving (``infer/engine.py``): one replica of each generator per mesh
    device, each chunk split into equal parts, one a device;
  - training (``train/step.py``, ``train/loop.py``): one process (rank) per
    device in a ``torch.distributed`` process group. Each rank loads its
    rows of every global batch (``process_row_slice``), gathers the loss
    inputs of the whole batch (``gather_batch``: the batch-wide terms, the
    Bessel std, the top-k edge mean, SSIM's clamp and the weighted means of
    a wrap-padded batch, are not means of per-rank losses) and all-reduces
    each optimizer's gradients as a mean (``all_reduce_mean``), the
    counterpart of XLA's ``psum`` under the sharded ``jit``.

The JAX package's (data, sp) mesh is not ported: its ``sp`` axis runs only
under the packed forward's ``trunk="xla"``, which the port does not have.
"""
from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# a collective that waits longer than this raises (NCCL's default)
PG_TIMEOUT = datetime.timedelta(minutes=10)
SP_REFUSAL = ("an 'sp' (row-sharding) axis is not ported: the JAX package "
              "runs it only under the packed forward's trunk='xla' "
              "(ROADMAP.md Queue 1, the 'sp' axis)")


def data_mesh(n_devices: int | None = None,
              devices: Sequence[str | torch.device] | None = None
              ) -> tuple[torch.device, ...]:
    """1-D mesh over the batch axis: the listed ``devices`` (a device may
    repeat, as JAX's virtual devices do: two replicas on one card), or the
    visible CUDA cards. ``n_devices`` takes the first n and raises when
    fewer exist; there is no fallback to fewer devices or to the CPU."""
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else n_devices
        if n < 1 or n > visible:
            raise ValueError(f"{n} CUDA cards asked for, {visible} visible")
        return tuple(torch.device("cuda", i) for i in range(n))
    if any(isinstance(d, (list, tuple)) for d in devices):
        raise NotImplementedError(SP_REFUSAL)
    devs = tuple(torch.device(d) for d in devices)
    n = len(devs) if n_devices is None else n_devices
    if n < 1 or n > len(devs):
        raise ValueError(f"{n} devices asked for, {len(devs)} listed")
    return devs[:n]


def process_row_slice(world: int, rank: int, global_batch: int) -> slice:
    """The rows of a global batch that ``rank`` of ``world`` owns on a 1-D
    mesh, one device a rank: each rank loads only these (HostLoader's
    ``shard``). The same rows and errors as the JAX function (mesh.py:80)."""
    if global_batch % world != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} data-axis devices")
    if not 0 <= rank < world:
        raise ValueError("this process has no devices in the mesh")
    rows = global_batch // world
    return slice(rank * rows, (rank + 1) * rows)


def world_size() -> int:
    """Ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(device_type: str = "cuda") -> torch.device | None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``): the multi-host counterpart of the JAX function. Returns
    this rank's device (``cuda:LOCAL_RANK``), or None in a single process,
    where it does nothing."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device(device_type, local) if device_type == "cuda" \
        else torch.device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(default_backend(device), init_method="env://",
                            timeout=PG_TIMEOUT)
    return device


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _comm_device() -> torch.device:
    """Where a collective's small host-made tensors live: NCCL takes CUDA
    tensors only, gloo takes either."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(batch: dict) -> dict:
    """This rank's rows of a global host batch (a dict of arrays or tensors
    with the batch axis first)."""
    return {k: v[process_row_slice(world_size(), rank(), len(v))]
            for k, v in batch.items()}


def replicate(state) -> None:
    """Broadcast rank 0's ``state`` (anything with ``state_dict`` and
    ``load_state_dict``: networks, optimizers, bookkeeping) to every rank,
    through the host."""
    def to_cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: to_cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(to_cpu(v) for v in obj)
        return obj

    box = [to_cpu(state.state_dict()) if rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    if rank() != 0:
        state.load_state_dict(box[0])


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over ranks of each tensor, in one collective on one
    flattened bucket (all of one dtype and device)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_sum(values: Sequence[float]) -> list[float]:
    """The sum over ranks of a few host numbers."""
    t = torch.tensor(list(values), dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t)
    return t.tolist()


def any_rank(flag: bool) -> bool:
    """True on every rank if ``flag`` is True on any."""
    return all_reduce_sum([float(flag)])[0] > 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class _Gather(torch.autograd.Function):
    """All ranks' rows of x, in rank order. The adjoint: the gradient of
    the gathered tensor summed over ranks, then this rank's rows. Every
    rank computes the same loss on the gathered batch, so each rank's
    parameter gradient is world x its true share, and the sum over ranks
    is world x the true gradient: ``all_reduce_mean`` of the parameter
    gradients is the global batch's gradient."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        lo = rank() * ctx.rows
        return grad[lo:lo + ctx.rows]


def gather_batch(*tensors):
    """The global batch of each tensor (None stays None), differentiable."""
    return tuple(None if t is None else _Gather.apply(t) for t in tensors)
