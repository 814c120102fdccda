"""The process-group mesh (port of openibl_tpu/parallel/mesh.py).

In the JAX package a mesh is a set of devices driven by one process. In the
port, as in the reference (``torch.distributed``, one process per GPU), a
mesh is a process group with one device per rank: where JAX shards over a
mesh's devices, the port shards over its ranks, and a rank's own sub-mesh
(``process_local_mesh``) is its one device. The backend follows the
device: NCCL on the card, gloo on the CPU. Nothing here falls back from one
to the other, or to a single process.

Launch with ``torchrun --nproc-per-node=N`` (or under Slurm) and call
``maybe_init_distributed()`` before ``get_mesh()``.
"""

import dataclasses
import datetime
import os
import subprocess

import torch
import torch.distributed as dist

from openibl_tpu_torch.utils import resolve_device

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its device, its rank, the world size
    and the process group (None for a single process without one)."""

    device: torch.device
    rank: int = 0
    size: int = 1
    group: object = None


def _slurm_master_addr(nodelist):
    """The first host of a Slurm node list (the reference's init_dist_slurm
    asks ``scontrol`` the same)."""
    try:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"cannot resolve SLURM_NODELIST={nodelist!r} "
                           f"with scontrol; set MASTER_ADDR") from e
    return out.stdout.split()[0]


def _launch_env():
    """(launcher, addr, port, rank, world size, local rank) from torchrun's
    or Slurm's environment (addr None for Slurm without MASTER_ADDR); None
    for a single-process launch. A partial environment raises."""
    env = os.environ
    slurm_tasks = env.get("SLURM_NTASKS")
    if env.get("RANK") or env.get("WORLD_SIZE") or (
            slurm_tasks is None and any(env.get(k) for k in _TORCHRUN)):
        missing = [k for k in _TORCHRUN if not env.get(k)]
        if missing:
            raise RuntimeError(
                f"partial torchrun environment ({'/'.join(missing)} "
                f"missing): refusing to degrade to single-process")
        rank = int(env["RANK"])
        return ("torchrun", env["MASTER_ADDR"], env["MASTER_PORT"], rank,
                int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank)))
    if slurm_tasks is None or slurm_tasks == "1":
        return None  # no launcher, or a 1-task Slurm allocation
    missing = [k for k in ("SLURM_PROCID", "SLURM_NODELIST", "MASTER_PORT")
               if not env.get(k)]
    if missing:
        raise RuntimeError(
            f"Slurm launch of {slurm_tasks} tasks without "
            f"{'/'.join(missing)}: refusing to degrade to single-process")
    rank = int(env["SLURM_PROCID"])
    return ("slurm", env.get("MASTER_ADDR"), env["MASTER_PORT"], rank,
            int(slurm_tasks), int(env.get("SLURM_LOCALID", rank)))


def world_size():
    """The number of processes the launcher started (1 without one), read
    from its environment without joining a group."""
    launch = _launch_env()
    return 1 if launch is None else launch[4]


def maybe_init_distributed(device="cuda"):
    """Join the process group of a torchrun or Slurm launch (the
    reference's init_dist / init_dist_slurm): NCCL for a CUDA ``device``,
    the rank's card ``cuda:LOCAL_RANK`` made current; gloo for the CPU.

    Does nothing without a launcher's environment, for a 1-task Slurm
    allocation, or when the group already exists. A partial environment or
    a failed rendezvous raises ``RuntimeError``: a run that silently fell
    back to one process would evaluate or train on a fraction of the data.
    ``OPENIBL_DIST_INIT_TIMEOUT`` (seconds) bounds the rendezvous."""
    if dist.is_initialized():
        return
    launch = _launch_env()
    if launch is None:
        return
    launcher, addr, port, rank, world, local_rank = launch
    addr = addr or _slurm_master_addr(os.environ["SLURM_NODELIST"])
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    timeout = os.environ.get("OPENIBL_DIST_INIT_TIMEOUT")
    try:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
            timeout=(datetime.timedelta(seconds=float(timeout)) if timeout
                     else None))
    except Exception as e:  # every failure of the rendezvous is fatal here
        raise RuntimeError(
            f"{launcher} launch detected (rank {rank} of {world} at "
            f"{addr}:{port}) but torch.distributed.init_process_group() "
            f"failed: refusing to degrade to single-process") from e


def get_mesh(n_devices=None, device="cuda"):
    """The mesh of this run: the process group's ranks, one device each
    (``cuda:LOCAL_RANK`` for ``device="cuda"``, the CPU only when asked).
    Without a process group it is a world-size-1 mesh. ``n_devices``, when
    given, must be the world size."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        rank, size, group = dist.get_rank(), dist.get_world_size(), \
            dist.group.WORLD
        if dist.get_backend() == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL process group cannot reach {device}")
    else:
        rank, size, group = 0, 1, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {size} "
            f"rank(s): launch one process per device "
            f"(torchrun --nproc-per-node={n_devices})")
    return Mesh(device, rank, size, group)


def run_device(device, mesh=None):
    """The device a run asked for (``utils.resolve_device``); with a mesh,
    its rank's device, which must be of the same type."""
    device = resolve_device(device)
    if mesh is None:
        return device
    if mesh.device.type != device.type:
        raise ValueError(f"the mesh's device {mesh.device} is not a "
                         f"{device.type} device as the run asked")
    return mesh.device


def process_local_mesh(mesh):
    """This rank's own sub-mesh: its device alone (rank 0 of 1, no group;
    None for no mesh). Phases that every rank runs whole take it."""
    return None if mesh is None else Mesh(mesh.device)


def pad_to_multiple(n, m):
    return -(-n // m) * m


def all_gather_rows(mesh, x):
    """Every rank's ``x`` (the same shape and dtype on each rank, on the
    mesh's device) concatenated along dim 0 in rank order. Exact for any
    dtype (indices gather as int64). Without a group, ``x`` itself."""
    if mesh.group is None:
        return x
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.chunk(mesh.size)), x.contiguous(),
                    group=mesh.group)
    return out
