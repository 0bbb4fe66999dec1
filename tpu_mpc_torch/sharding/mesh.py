"""Sessions-axis sharding of the kernel launches (port of
tpu_mpc/sharding/mesh.py).

Signing sessions are independent, so a batch of them splits over devices
with no communication inside a kernel: only the protocol's own sums cross
sessions, and those run after the kernels, on the caller's device.  The
JAX package lays a 1-D mesh over the "sessions" axis and `device_put`s every
flattened kernel operand with a sessions sharding; XLA then runs each
kernel SPMD.  The port has no SPMD compiler, so the split happens in the
five kernel wrappers (core/pallas_rns.py: exp_call, fixed_call;
ec/pallas_ec.py: ladder_call, comb_call, affine_call), where every launch
already funnels and is counted.  Each wrapper calls `launch`: it cuts the
per-lane operands into one contiguous row block per mesh entry, copies the
shared operands to each entry's device once (cached, as XLA replicates an
unsharded operand), launches every piece under that device's guard before
it gathers any, and returns the pieces' outputs in order as one tensor on
the caller's device.  kernels.LAUNCHES counts one launch per piece.

The partition rule is the reference's: a batch B splits only when a mesh is
active and B % mesh.size == 0; otherwise the call runs whole on the
caller's device.  Entries may repeat a device (["cpu"] * 8, ["cuda:0"] * 4),
the counterpart of XLA's virtual host devices: the pieces then run in turn
on that device's current stream.  Operands on a card never run a piece on a
CPU entry, where it would take the plain version: launch raises instead.

A mesh over ranks (torch.distributed, one process per device, every rank
running the same host program): each rank launches only its own piece, and
one all-gather gives every rank the whole output, so the protocol goes on
identically everywhere.  Before each such launch the ranks all-gather one
int64 digest of the per-lane inputs; if any differ, every rank raises.

Usage:
    mesh = sessions_mesh()                     # every visible card, or the ranks
    with use_mesh(mesh):
        off = gg20.offline_stage(key, [0, 1], rng)     # K1-K5 run in pieces
"""

from __future__ import annotations

import contextlib
import os
import weakref
import zlib

import torch

from ..device import device_key, resolve_device

AXIS = "sessions"
DIST_ENV = "TPU_MPC_TORCH_DISTRIBUTED"


class Mesh:
    """A 1-D mesh over the sessions axis: `devices[i]` runs entry i's piece.

    Over ranks (`group` set), entry i is rank i, `rank` is this process's
    entry and `devices[rank]` its device; the other entries' devices are
    those ranks' own."""

    def __init__(self, devices, group=None, rank=None):
        self.devices = tuple(devices)
        self.group, self.rank = group, rank
        if not self.devices:
            raise ValueError("sessions_mesh: a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> torch.device | None:
        """This process's device in a mesh over ranks (None otherwise)."""
        return self.devices[self.rank] if self.group is not None else None

    def __repr__(self):
        ranks = f", rank {self.rank} of a process group" if self.group is not None else ""
        return f"Mesh({AXIS}: {[str(d) for d in self.devices]}{ranks})"

    def broadcast_bytes(self, raw: bytes) -> bytes:
        """Rank 0's `raw` on every rank (a mesh over ranks; every rank passes
        the same length)."""
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(self.local)
        torch.distributed.broadcast(t, 0, group=self.group)
        return bytes(t.cpu().numpy())


_ACTIVE: Mesh | None = None


def maybe_init_distributed() -> bool:
    """TPU_MPC_TORCH_DISTRIBUTED=1: bring up torch.distributed from the
    standard env (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, and LOCAL_RANK
    as torchrun sets it), NCCL with the card LOCAL_RANK on CUDA, gloo on the
    CPU, so that sessions_mesh() spans the ranks.  False without the env
    var; an init that fails raises."""
    if os.environ.get(DIST_ENV) != "1":
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        torch.distributed.init_process_group("nccl", init_method="env://")
    else:
        torch.distributed.init_process_group("gloo", init_method="env://")
    return True


def _rank_device() -> torch.device:
    """This rank's device: the current card under NCCL; the CPU under
    another backend, which a machine with a card refuses (its pieces would
    run the plain versions on the CPU)."""
    backend = torch.distributed.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if torch.cuda.is_available():
        raise RuntimeError(f"sessions_mesh: a {backend} process group on a machine with a "
                           "card would run every piece on the CPU; use nccl "
                           "(maybe_init_distributed() does)")
    return torch.device("cpu")


def sessions_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the sessions axis.

    devices: exactly these entries (repeats allowed), the first n_devices of
    them if given.  Without it: the ranks of torch.distributed's world once
    it is initialised (one entry a rank), else the first n_devices of the
    visible cards (all of them by default)."""
    if devices is not None:
        devs = [device_key(resolve_device(d)) for d in devices][:n_devices]
        return Mesh(devs)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        local = _rank_device()
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, world):
            raise ValueError(f"sessions_mesh: a mesh over ranks spans all {world} ranks, "
                             f"not {n_devices}")
        names = [None] * world
        dist.all_gather_object(names, str(local))
        return Mesh([torch.device(n) for n in names], group=dist.group.WORLD, rank=rank)
    resolve_device("cuda")
    n = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i) for i in range(n)][:n_devices])


def activate(mesh: Mesh) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def current_mesh() -> Mesh | None:
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = _ACTIVE
    activate(mesh)
    try:
        yield mesh
    finally:
        activate(prev)


def _splits(B: int) -> bool:
    mesh = _ACTIVE
    return mesh is not None and B % mesh.size == 0


def _blocks(mesh: Mesh, B: int):
    """(entry device, row slice) of each piece this process launches."""
    b = B // mesh.size
    own = [mesh.rank] if mesh.group is not None else range(mesh.size)
    return [(mesh.devices[i], slice(i * b, (i + 1) * b)) for i in own]


def _check_entries(mesh: Mesh, src: torch.device) -> None:
    """Operands on a card run their pieces on cards: a CPU entry would run
    the plain version there, and the gather would hide it."""
    if src.type == "cuda":
        own = [mesh.local] if mesh.group is not None else mesh.devices
        cpu = [str(dev) for dev in own if dev.type != "cuda"]
        if cpu:
            raise RuntimeError(f"sharding: operands on {src} but {mesh} would run pieces "
                               f"on {cpu}, in the plain version")


def shard_flat(x) -> list:
    """The pieces of a flattened [B, ...] operand that this process holds:
    one contiguous row block per mesh entry, each on its entry's device (over
    ranks, this rank's block only).  One piece, `x` unchanged, when no mesh
    is active, x is 0-d or B does not divide by the mesh size."""
    if x.dim() == 0 or not _splits(x.shape[0]):
        return [x]
    return [x[sl].to(dev) for dev, sl in _blocks(_ACTIVE, x.shape[0])]


def shard_leading(x, batch_shape: tuple) -> list:
    """shard_flat's rule on the first of `batch_shape`, the sessions axis of
    an un-flattened [S, n, ...] operand."""
    if not batch_shape or not _splits(batch_shape[0]):
        return [x]
    return [x[sl].to(dev) for dev, sl in _blocks(_ACTIVE, batch_shape[0])]


def gather(pieces: list, device) -> torch.Tensor:
    """The pieces' outputs, in entry order, as one tensor on `device`.  Over
    ranks every rank passes its own piece and gets the whole."""
    mesh = _ACTIVE
    if mesh is None or mesh.group is None:
        if len(pieces) == 1:
            return pieces[0].to(device)
        return torch.cat([p.to(device) for p in pieces])
    (mine,) = pieces
    mine = mine.contiguous()
    whole = mine.new_empty((mine.shape[0] * mesh.size,) + tuple(mine.shape[1:]))
    torch.distributed.all_gather_into_tensor(whole, mine, group=mesh.group)
    return whole.to(device)


_M31 = (1 << 31) - 1


def _digest(lanes, tag: str) -> int:
    """Sum over every element of (value mod 2^31 - 1) times a weight mod
    2^31 - 1 that depends on its position and tensor, plus the crc32 of the
    shapes and `tag`: cheap on the device, exact in int64."""
    acc = zlib.crc32(repr((tag, [tuple(t.shape) for t in lanes])).encode())
    for i, t in enumerate(lanes):
        v = t.reshape(-1).to(torch.int64) % _M31
        w = (torch.arange(v.numel(), dtype=torch.int64, device=v.device) * 0x2545F491
             + 0x9E3779B1 * (i + 1)) % _M31 + 1
        acc += int(((v * w) % _M31).sum().item())
    return acc % _M31


def _agree(mesh: Mesh, lanes, tag: str) -> None:
    """Every rank raises unless all ranks hold the same per-lane inputs."""
    mine = torch.tensor([_digest(lanes, tag)], dtype=torch.int64, device=mesh.local)
    every = mine.new_empty(mesh.size)
    torch.distributed.all_gather_into_tensor(every, mine, group=mesh.group)
    got = every.tolist()
    if len(set(got)) != 1:
        raise RuntimeError(
            f"sharding: the ranks hold different inputs for {tag} "
            f"({lanes[0].shape[0]} lanes; digests by rank {got}): every rank must run the "
            f"same host program on the same inputs")


# replicas of the shared operands: (id of the base tensor, device) -> copy
_REPLICAS: dict = {}


def _replicate(v, dev: torch.device):
    """A shared operand on `dev`: tensors copied once per base tensor and
    device (they are read-only), sequences element by element, anything
    else as it is."""
    if isinstance(v, (list, tuple)):
        return type(v)(_replicate(u, dev) for u in v)
    if not isinstance(v, torch.Tensor) or v.device == dev:
        return v
    base = v if v._base is None else v._base
    if not base.is_contiguous():
        return v.to(dev)
    key = (id(base), dev)
    rep = _REPLICAS.get(key)
    if rep is None:
        rep = _REPLICAS[key] = base.to(dev)
        weakref.finalize(base, _REPLICAS.pop, key, None)
    return rep.as_strided(v.shape, v.stride(), v.storage_offset() - base.storage_offset())


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def launch(fn, args: tuple, lanes: tuple):
    """fn(*args) with args[i], i in `lanes`, split along their first axis
    over the active mesh; the other args are shared by every piece.  The one
    helper the kernel wrappers call: without a split it is fn(*args) on the
    caller's device."""
    B = args[lanes[0]].shape[0]
    if any(args[i].shape[0] != B for i in lanes):
        raise ValueError(f"sharding: per-lane operands of {fn.__name__} differ in length: "
                         f"{[tuple(args[i].shape) for i in lanes]}")
    if B == 0 or not _splits(B):
        return fn(*args)
    mesh = _ACTIVE
    src = args[lanes[0]].device
    _check_entries(mesh, src)
    if mesh.group is not None:
        _agree(mesh, [args[i] for i in lanes], fn.__name__)
    split = {i: shard_flat(args[i]) for i in lanes}
    outs = []
    for j, (dev, _) in enumerate(_blocks(mesh, B)):
        piece = [split[i][j] if i in lanes else _replicate(a, dev)
                 for i, a in enumerate(args)]
        with _on(dev):
            outs.append(fn(*piece))
    return gather(outs, src)
