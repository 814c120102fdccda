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

The JAX package's placement helpers (its ``parallel/mesh.py``) map to:

  * ``global_batch`` / ``shard_batch`` / ``data_sharding``: nothing. Each
    rank holds only its own rows of a batch (``data.sampler.shard_tuples``,
    ``slice_indices``);
  * ``globalize_tree`` / ``replicated``: ``broadcast_module``, rank 0's
    parameters and buffers to every rank, once after the model is built
    and again after a resume (``broadcast_tensors`` for other state, such
    as the SGD momentum);
  * ``local_view_tree`` / ``copy_tree``: nothing. A rank's tensors are its
    own;
  * the gradient psum XLA inserts into a sharded step: ``all_reduce_mean_``,
    one all-reduce over a flat buffer of the gradients, then a divide by
    the world size. Every loss is a mean over the tuple axis, and the
    ranks hold equal shares of the batch, so the mean of the ranks' means
    is the global mean.

``broadcast_object`` carries rank 0's host objects (the mined tuples),
``barrier`` orders a file write before its readers, ``check_replicated``
and ``check_same_on_every_rank`` raise where the ranks disagree. Without a
group (world size 1) each helper does nothing.

``Lockstep`` is what serving adds. One JAX process drives every device, so
a request reaches every shard of the index for free; here a request
reaches rank 0 alone, and the other ranks must take it up before any
collective of its search runs. Rank 0 leads: for each batch it sends a
small header (an op code, and the batch's size and k) over a gloo group of
its own whose timeout is a year, so a follower may wait for the next
request as long as the service stays idle; an NCCL collective left waiting
past the group's timeout is aborted by its watchdog. The batch's data
then goes over the mesh's own group.
"""

import dataclasses
import datetime
import itertools
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


class Lockstep:
    """The channel on which rank 0 of ``mesh`` tells the other ranks what
    to run next: ``send(op, *args)`` on rank 0, ``recv()`` (blocking,
    returns ``(op, *args)``) on the others. Each message is ``SIZE`` int64
    values, ``op`` first, over a gloo group made for it with ``TIMEOUT``
    (every rank of the default group must build a ``Lockstep`` together).
    Without followers (world size 1) there is no group and nothing is
    sent. The group lives as long as the default one."""

    SIZE = 4
    # gloo waits with this timeout on each receive; ~10 years overflow its
    # deadline arithmetic, a year does not
    TIMEOUT = datetime.timedelta(days=365)

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = None
        if mesh.group is not None and mesh.size > 1:
            self.group = dist.new_group(backend="gloo", timeout=self.TIMEOUT)

    def send(self, op, *args):
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 leads the lockstep")
        if self.group is None:
            return
        msg = torch.zeros(self.SIZE, dtype=torch.int64)
        msg[:1 + len(args)] = torch.tensor((op, *args), dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self.group)

    def recv(self):
        if self.mesh.rank == 0 or self.group is None:
            raise RuntimeError("rank 0 leads the lockstep; it receives "
                               "nothing")
        msg = torch.empty(self.SIZE, dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self.group)
        return tuple(msg.tolist())


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


def _group_size(mesh):
    """The world size of ``mesh``'s group, which must be the mesh's own: an
    all-reduce over another world size would sum the wrong shares."""
    size = dist.get_world_size(mesh.group)
    if size != mesh.size:
        raise RuntimeError(f"the mesh says {mesh.size} ranks, its process "
                           f"group has {size}")
    return size


def _by_dtype(tensors):
    """``tensors`` grouped by dtype (insertion order), for flat buffers."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def _flat(tensors):
    """One flat copy of same-dtype ``tensors`` in logical order (any
    memory format)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(tensors, flat):
    """Copy ``flat`` (``_flat``'s layout) back into ``tensors``."""
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def all_reduce_mean_(mesh, tensors):
    """Replace each of ``tensors`` (on the mesh's device) by its mean over
    the ranks, in place: one all-reduce (sum) of a flat buffer per dtype,
    then a divide by the world size. Every rank ends with the same bits.
    Without a group, nothing."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or not tensors:
        return
    size = _group_size(mesh)
    with torch.no_grad():
        for group in _by_dtype(tensors):
            flat = _flat(group)
            dist.all_reduce(flat, group=mesh.group)
            _unflat_(group, flat.div_(size))


def broadcast_tensors(mesh, tensors):
    """Rank 0's values of ``tensors`` on every rank, in place (one
    broadcast a dtype). Without a group, nothing."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or not tensors:
        return
    _group_size(mesh)
    with torch.no_grad():
        for group in _by_dtype(tensors):
            flat = _flat(group)
            dist.broadcast(flat, src=0, group=mesh.group)
            _unflat_(group, flat)


def broadcast_module(mesh, module):
    """Rank 0's parameters and buffers of ``module`` on every rank, in
    place (the JAX package's replicated placement). Returns ``module``."""
    broadcast_tensors(mesh, itertools.chain(module.parameters(),
                                            module.buffers()))
    return module


def broadcast_object(mesh, obj):
    """Rank 0's ``obj`` (any picklable host object) on every rank; ``obj``
    itself without a group."""
    if mesh is None or mesh.group is None:
        return obj
    _group_size(mesh)
    box = [obj]
    # NCCL stages the pickled bytes on the rank's card, gloo on the host
    dist.broadcast_object_list(
        box, src=0, group=mesh.group,
        device=mesh.device if dist.get_backend(mesh.group) == "nccl"
        else None)
    return box[0]


def barrier(mesh):
    """Wait for every rank of ``mesh`` (an all-reduce of one element on
    the mesh's device). Without a group, nothing."""
    if mesh is None or mesh.group is None:
        return
    all_reduce_mean_(mesh, [torch.zeros(1, device=mesh.device)])


def check_same_on_every_rank(mesh, value, what):
    """Raise on every rank unless the integer ``value`` is the same on each
    (e.g. a rank's step count, before the steps' collectives pair up)."""
    if mesh is None or mesh.group is None:
        return
    got = all_gather_rows(mesh, torch.tensor([int(value)],
                                             device=mesh.device)).tolist()
    if len(set(got)) != 1:
        raise RuntimeError(f"{what} differs across the ranks: {got}")


def check_replicated(mesh, tensors, what):
    """Raise on every rank unless ``tensors`` hold the same bits on each:
    rank 0's flat copy is broadcast and compared bit for bit."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None:
        return
    differ = torch.zeros(1, device=mesh.device)
    with torch.no_grad():
        for group in _by_dtype(tensors):
            flat = _flat(group)
            ref = flat.clone()
            dist.broadcast(ref, src=0, group=mesh.group)
            differ += not torch.equal(ref.view(torch.uint8),
                                      flat.view(torch.uint8))
    dist.all_reduce(differ, group=mesh.group)
    if differ.item():
        raise RuntimeError(f"{what} differs across the ranks")
