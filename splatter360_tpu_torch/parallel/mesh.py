"""The process group, the (data, face) rank grid and the collectives of
training and evaluation across cards.

Counterpart of splatter360_tpu/parallel/mesh.py. JAX runs one jitted program
over a device mesh and XLA inserts the gradient psum. The port runs one
process per card under torchrun:

    python -m torch.distributed.run --nproc_per_node=K -m splatter360_tpu_torch.main \
        configs/hm3d.yaml mode=train ...

A rank plays the part of a JAX process that owns one device, so a run on K
cards is JAX's multi-host mode with one device a host (the trainer's
docstring says how the data and the batch are split).

Backend: NCCL when every local rank has a card of its own; gloo when ranks
share cards (LOCAL_WORLD_SIZE > the visible cards: NCCL refuses two ranks on
one device) and on the CPU. Under gloo a collective on a CUDA tensor goes
through the host, a copy there and back. Both follow from the backend the
rule chose when the group started, never from an error.

The collectives take the shape the sharded renders need (render_sharding.py):
`Group` runs them across the ranks of a process group; `Emulated(k)` runs all
k ranks' parts in one process, one after another, through the same code, so
a test or chip_smoke.py can check the sharded renders without a second
process.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device


def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """NCCL when each local rank has a card of its own, else gloo."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def _torchrun_env() -> Optional[dict]:
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return dict(rank=rank, world=world, local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Start the process group from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return this
    rank's device: cuda:(LOCAL_RANK % cards) for a "cuda" request, the CPU
    for a "cpu" one. A run without that environment is untouched (world 1,
    no group, `device` as given). Idempotent: a group already started, by
    this function or by the caller, is kept."""
    dev = resolve_device(device)
    env = _torchrun_env()
    if env is None:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", env["local_rank"] % torch.cuda.device_count())
    if dist.is_initialized():
        return dev
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, env["local_world"], count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=env["rank"],
                            world_size=env["world"])
    if env["rank"] == 0:
        print(f"torch.distributed: {env['world']} ranks, backend {backend} "
              f"({env['local_world']} local ranks on {count} visible card(s)), rank 0 on {dev}",
              flush=True)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def face_mesh_split(batch_size: int, n_faces: int, n_devices: int):
    """(data, face) axis sizes for train.shard_faces: data = the largest
    divisor of the batch that fits (as data_mesh_size), face = the largest
    divisor of n_faces (v*6 an example) that fits the ranks left, since
    every rank's face slice must be equal. Warns when ranks are left idle."""
    b = max(int(batch_size), 1)
    n_data = max(d for d in range(1, max(n_devices, 1) + 1) if b % d == 0)
    rem = max(n_devices // n_data, 1)
    n_face = max(d for d in range(1, rem + 1) if n_faces % d == 0)
    if n_data * n_face < n_devices:
        warnings.warn(
            f"shard_faces: batch {b} x {n_faces} faces maps to a "
            f"{n_data}x{n_face} (data, face) mesh on {n_devices} devices "
            f"({n_devices - n_data * n_face} IDLE). Batch x face-count "
            f"divisibility sets the mesh.",
            stacklevel=2,
        )
    return n_data, n_face


def data_mesh_size(batch_size: int, n_devices: int) -> int:
    """The largest device count <= n_devices that divides the global batch;
    warns when it is smaller (devices idle)."""
    b = max(int(batch_size), 1)
    size = max(d for d in range(1, max(n_devices, 1) + 1) if b % d == 0)
    if size < n_devices:
        warnings.warn(
            f"global batch {b} is not divisible by {n_devices} devices: "
            f"training on a {size}-device data mesh ({n_devices - size} "
            f"devices IDLE). Set trainer.batch_size to a multiple of the "
            f"device count.",
            stacklevel=2,
        )
    return size


def local_batch_size(global_batch: int, n_proc: int) -> int:
    """Each of the `n_proc` loading ranks' equal slice of the global batch
    (trainer.batch_size is global, as in JAX)."""
    if global_batch % n_proc != 0:
        raise ValueError(
            f"trainer.batch_size={global_batch} must be divisible by the "
            f"process count {n_proc} (each host assembles an equal local "
            f"slice of the global batch)"
        )
    return global_batch // n_proc


class _Gather(torch.autograd.Function):
    """Each rank's part, concatenated along `dim` in rank order. Backward:
    with `replicated`, every rank holds the same cotangent of the whole (its
    loss is computed from the whole, alike on every rank) and keeps its own
    part's slice; otherwise each rank's cotangent covers parts of all ranks,
    and its part's gradient is their sum over the ranks: a sum
    reduce-scatter, the transpose JAX takes of its all_gather."""

    @staticmethod
    def forward(ctx, part, comm, dim, replicated):
        ctx.comm, ctx.dim, ctx.replicated = comm, dim, replicated
        return comm._all_gather(part, dim)

    @staticmethod
    def backward(ctx, grad):
        comm = ctx.comm
        if not ctx.replicated:
            grad = grad.contiguous().clone()
            comm._all_reduce(grad)
        return grad.chunk(comm.size, ctx.dim)[comm.index].contiguous(), None, None, None


class _SumGrads(torch.autograd.Function):
    """The identity on tensors every rank holds alike and renders a part of;
    their gradients are summed over the ranks (in one flat buffer), as
    shard_map's transpose psums a replicated input's cotangents."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.comm.all_reduce(list(grads)))


class Emulated:
    """`size` ranks run one after another in this process: their parts are
    joined by concatenation and autograd sums what they share."""

    def __init__(self, size: int = 1):
        self.size = size
        self.local_ranks = list(range(size))

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0,
               replicated: bool = False) -> torch.Tensor:
        return torch.cat(list(parts), dim) if len(parts) > 1 else parts[0]

    def shared(self, *xs: torch.Tensor):
        return xs

    # the callers sum over local_ranks themselves: nothing is left to add
    def all_reduce(self, tensors: list[torch.Tensor], mean: bool = False) -> list[torch.Tensor]:
        return tensors

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        pass

    def broadcast_object(self, obj, src: int = 0):
        return obj

    def barrier(self) -> None:
        pass


class Group:
    """The ranks of the process group `group` (None: the world); this
    process runs the part of its own rank in it."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.local_ranks = [self.index]
        # a CUDA tensor goes through the host under gloo
        self.via_host = dist.get_backend(group) == "gloo"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.via_host else t

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        h = self._host(t)
        dist.all_reduce(h, group=self.group)
        if h is not t:
            t.copy_(h)
        return t

    def _all_gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        h = self._host(part.detach().contiguous())
        out = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(out, h, group=self.group)
        return torch.cat(out, dim).to(part.device)

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0,
               replicated: bool = False) -> torch.Tensor:
        """The ranks' parts concatenated along `dim` (see _Gather for the
        two backward rules)."""
        (part,) = parts
        return _Gather.apply(part, self, dim, replicated)

    def shared(self, *xs: torch.Tensor):
        return _SumGrads.apply(self, *xs)

    def all_reduce(self, tensors: list[torch.Tensor], mean: bool = False) -> list[torch.Tensor]:
        """The sum (or mean) over the ranks of each tensor, through one flat
        buffer; new tensors, in its memory."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat)
        if mean:
            flat /= self.size
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                     tensors)]

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Group rank `src`'s values into every rank's `tensors`, in one
        flat buffer."""
        flat = self._host(torch.cat([t.detach().reshape(-1) for t in tensors]))
        dist.broadcast(flat, dist.get_global_rank(self.group, src) if self.group else src,
                       group=self.group)
        at = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

    def broadcast_object(self, obj, src: int = 0):
        """Group rank `src`'s picklable `obj` (a host batch) on every rank."""
        box = [obj]
        dist.broadcast_object_list(
            box, dist.get_global_rank(self.group, src) if self.group else src, group=self.group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


@dataclass(frozen=True)
class RankGrid:
    """The (data, face) rank grid, JAX's create_mesh_2d: rank r sits at data
    index r // n_face and face index r % n_face. `face` holds the ranks of
    this rank's data index (they render slices of the same examples'
    faces), `world` all ranks."""

    n_data: int
    n_face: int
    rank: int
    face: "Group | Emulated"
    world: "Group | Emulated"

    @property
    def data_index(self) -> int:
        return self.rank // self.n_face

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def share_batch(self, batch):
        """The batch of the face group's first rank on every rank of it
        (the prefetch thread reads the step from the StepTracker, so ranks
        that load alike can still draw different context gaps)."""
        return self.face.broadcast_object(batch) if self.n_face > 1 else batch


def create_rank_grid(n_data: int = 1, n_face: int = 1) -> RankGrid:
    """The grid over all ranks; every rank must call it alike (it makes one
    face process group a data index with dist.new_group). Without a process
    group it is one rank whose collectives are the identity; with one, the
    world's collectives run through it even at world size 1."""
    world = world_size()
    if n_data * n_face != world:
        raise ValueError(f"a {n_data}x{n_face} (data, face) grid needs {n_data * n_face} "
                         f"ranks, and the run has {world}: every rank must take part")
    if not dist.is_initialized():
        return RankGrid(1, 1, 0, Emulated(1), Emulated(1))
    r = rank()
    face = Emulated(1)
    if n_face > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_face, (d + 1) * n_face)))
            if d == r // n_face:
                face = Group(g)
    return RankGrid(n_data, n_face, r, face, Group())
