"""The data mesh over ``torch.distributed`` (port of ``bayesgm_tpu/parallel/mesh.py``).

JAX shards global arrays over a device mesh and GSPMD inserts the
collectives.  The port is SPMD: one process per rank, each holding its own
rows as local tensors, with explicit collectives.  A :class:`Mesh` wraps
the default process group, which the launcher initializes (the dry run,
the tests, the smoke script or ``torchrun``): ``make_mesh`` never does.

Rows split by rank as JAX shards them: rank ``r`` of ``W`` holds rows
``[r c, min((r + 1) c, n))`` with ``c = ceil(n / W)``, so a rank may hold
none (n = 5, W = 8).  Gathers pad each rank's block to ``c`` rows, as
``all_gather`` needs equal sizes, then cut to ``n``.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import io
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from bayesgm_torch.ops import rows as rows_mod


class Mesh:
    """A 1-D mesh over every rank of the default process group.

    ``axis_name`` and ``size`` are what the models read (JAX reads the
    mesh's axis name and its size); ``rank``, ``device``, ``group`` and
    ``device_mesh`` (the ``torch.distributed`` ``DeviceMesh``) serve the
    collectives.  Each rank's tensors live on ``device``."""

    def __init__(self, device_mesh, axis_name: str, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_name = axis_name
        self.group = device_mesh.get_group(axis_name)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = device
        self._seed_offsets = {}  # device -> int32 [0, rank], made once (a host copy waits)

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    def __repr__(self):
        return (f"Mesh({self.axis_name}={self.size}, rank={self.rank}, device={self.device}, "
                f"backend={dist.get_backend(self.group)})")

    # -- rows -------------------------------------------------------------

    def rows(self, n: int) -> "RowSplit":
        """This rank's block of ``n`` rows."""
        n = int(n)
        c = -(-n // self.size)
        return RowSplit(n, min(self.rank * c, n), min((self.rank + 1) * c, n), self)

    def rows_of(self, local: int) -> "RowSplit":
        """The split whose block on this rank holds ``local`` rows (the
        global count is all-reduced; one collective)."""
        count = torch.tensor([int(local)], dtype=torch.int64, device=self.device)
        self.all_reduce_(count)
        rows = self.rows(int(count.item()))
        if rows.local != int(local):
            raise ValueError(f"rank {self.rank} holds {local} rows, the split of {rows.n} rows "
                             f"over {self.size} ranks gives it {rows.local}")
        return rows

    # -- collectives ------------------------------------------------------

    def all_reduce_(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the ranks, in place."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def barrier(self):
        dist.barrier(group=self.group)

    def all_gather_padded(self, t, c: int, axis: int = 0):
        """Every rank's ``t`` (at most ``c`` rows on ``axis``), each padded
        with zeros to ``c`` rows, concatenated along ``axis`` in rank order."""
        t = t.detach().contiguous()
        pad = c - t.shape[axis]
        if pad:
            shape = list(t.shape)
            shape[axis] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=axis)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=axis)

    def mix_seed(self, seed):
        """A kernel seed (int32 ``[2]``) with the rank added to its second
        word, as JAX adds ``axis_index`` (``mesh.py:82-88``): every rank's
        kernel draws its own signs, and rank 0's seed is unchanged."""
        offset = self._seed_offsets.get(seed.device)
        if offset is None:
            offset = self._seed_offsets[seed.device] = torch.tensor(
                [0, self.rank], dtype=torch.int32, device=seed.device)
        return seed + offset


class RowSplit:
    """Rank ``mesh.rank``'s rows ``[lo, hi)`` of ``n`` split over ``mesh``.

    ``with rows.split():`` runs the port's per-row code on this block (see
    :mod:`bayesgm_torch.ops.rows`)."""

    __slots__ = ("n", "lo", "hi", "mesh")

    def __init__(self, n: int, lo: int, hi: int, mesh: Mesh):
        self.n, self.lo, self.hi, self.mesh = int(n), int(lo), int(hi), mesh

    def __repr__(self):
        return f"RowSplit(n={self.n}, rows=[{self.lo}, {self.hi}), rank={self.mesh.rank})"

    @property
    def local(self) -> int:
        return self.hi - self.lo

    @property
    def block(self) -> int:
        """Rows per rank before the cut at ``n``: ``ceil(n / W)``."""
        return -(-self.n // self.mesh.size)

    def split(self):
        return rows_mod.split(self)

    def take(self, t, axis: int = 0):
        """This rank's rows of a tensor holding all ``n`` on ``axis``."""
        if t.shape[axis] != self.n:
            raise ValueError(f"expected {self.n} rows on axis {axis}, got {tuple(t.shape)}")
        return t.narrow(axis, self.lo, self.local)

    def own(self, idx):
        """For global row indices ``idx`` (a CPU int64 tensor): ``(pos,
        local_idx)``, the positions in ``idx`` of this rank's rows and those
        rows' local indices."""
        mask = (idx >= self.lo) & (idx < self.hi)
        pos = torch.nonzero(mask).reshape(-1)
        return pos, idx[pos] - self.lo

    def all_sum(self, t):
        """``t`` summed over the ranks (a new tensor; differentiable: the
        gradient is summed over the ranks too, as each rank's loss is the
        part of a global sum that its rows give)."""
        return _AllSum.apply(t, self.mesh)

    def gather(self, t, axis: int = 0):
        """All ``n`` rows on every rank from each rank's ``t`` (this rank's
        block on ``axis``); differentiable, the gradient of each rank's rows
        summed over the ranks."""
        if t.shape[axis] != self.local:
            raise ValueError(f"expected this rank's {self.local} rows on axis {axis}, "
                             f"got {tuple(t.shape)}")
        return _GatherRows.apply(t, self, axis)


class MeshBatch:
    """A minibatch of global row indices over tables split by rank: this
    rank's ``pos`` (positions in the batch) and ``local_idx`` (rows of its
    block), both on the mesh's device.  ``take`` assembles the batch on
    every rank: each rank writes its own rows into a zero batch and one
    all-reduce sums them, which is exact since one rank gives each row."""

    __slots__ = ("rows", "size", "pos", "local_idx")

    def __init__(self, rows: RowSplit, size: int, pos, local_idx):
        self.rows, self.size, self.pos, self.local_idx = rows, int(size), pos, local_idx

    def take(self, *tables):
        """The batch's rows of each table (this rank's block of each), as
        contiguous tensors; one collective for all of them."""
        widths = [math.prod(t.shape[1:]) for t in tables]
        buf = torch.zeros((self.size, sum(widths)), dtype=tables[0].dtype,
                          device=tables[0].device)
        if self.local_idx.numel():
            buf[self.pos] = torch.cat([t[self.local_idx].reshape(-1, w)
                                       for t, w in zip(tables, widths)], dim=1)
        self.rows.mesh.all_reduce_(buf)
        out, at = [], 0
        for t, w in zip(tables, widths):
            out.append(buf[:, at:at + w].reshape((self.size,) + tuple(t.shape[1:])).contiguous())
            at += w
        return out


def mesh_batches(rows: RowSplit, batches) -> list:
    """A :class:`MeshBatch` for each minibatch of global row indices in
    ``batches`` (CPU int64 tensors, e.g. slices of an epoch's permutation);
    their positions and local indices reach the mesh's device in one copy
    (a copy from pageable host memory waits for the device's queue)."""
    owned = [rows.own(b) for b in batches]
    flat = torch.cat([t for pair in owned for t in pair]).to(rows.mesh.device)
    out, at = [], 0
    for b, (pos, _) in zip(batches, owned):
        k = pos.shape[0]
        out.append(MeshBatch(rows, b.shape[0], flat[at:at + k], flat[at + k:at + 2 * k]))
        at += 2 * k
    return out


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone()), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rows, axis):
        ctx.rows, ctx.axis = rows, axis
        full = rows.mesh.all_gather_padded(t, rows.block, axis)
        return full.narrow(axis, 0, rows.n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        rows, axis = ctx.rows, ctx.axis
        full = rows.mesh.all_reduce_(grad.contiguous().clone())
        return full.narrow(axis, rows.lo, rows.local), None, None


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone()), None


def sum_parts(t, mesh: Mesh):
    """The sum over the ranks of ``t``, a rank's part of a replicated
    target.  With the state entering through :func:`share_state`,
    ``sum_parts(local_part(share_state(theta)))`` gives every rank the full
    value and, under autograd, the full gradient with respect to ``theta``
    (forward all-reduce, backward identity; ``share_state``: forward
    identity, backward all-reduce).  Terms added outside count once."""
    return _Total.apply(t, mesh)


def share_state(t, mesh: Mesh):
    """``t``, a state replicated on every rank, entering a rank's part of
    a sum; see :func:`sum_parts`."""
    return _Shared.apply(t, mesh)


@contextlib.contextmanager
def rank0_output(mesh: Optional[Mesh]):
    """Run the block with this rank's standard output dropped unless it is
    rank 0 (or there is no mesh), so a mesh run prints once."""
    if mesh is None or mesh.rank == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def takes_mesh(method):
    """Decorate a method with a ``mesh`` argument: a ``mesh`` that is not a
    :class:`Mesh` (nor None) raises ``TypeError``, and the method runs
    under :func:`rank0_output` of its mesh."""
    sig = inspect.signature(method)

    @functools.wraps(method)
    def wrapped(*args, **kwargs):
        mesh = sig.bind(*args, **kwargs).arguments.get("mesh")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: expected a bayesgm_torch.parallel.Mesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        with rank0_output(mesh):
            return method(*args, **kwargs)

    return wrapped


def writes_files(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes a run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# The JAX names
# ---------------------------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device=None) -> Mesh:
    """A 1-D mesh named ``axis_name`` over the initialized default process
    group.  ``n_devices``, when given, must be the world size
    (``ValueError`` otherwise, as JAX raises when too few devices are
    visible).  Each rank's device is ``cuda:{local_rank % device_count}``
    (``LOCAL_RANK`` from the launcher, else the rank), or the CPU when
    ``device="cpu"``; a CUDA device without CUDA raises.  The mesh never
    moves to another backend or device by itself."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group); the launcher makes it")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh({n_devices}) but the process group has {world} rank(s); "
                         f"launch {n_devices} processes (e.g. python -m "
                         f"bayesgm_torch.parallel.dryrun --world {n_devices}).")
    rank = dist.get_rank()
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' for a mesh "
                               "of CPU processes (gloo)")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        dev = (torch.device("cuda", local_rank % torch.cuda.device_count()) if device is None
               or torch.device(device).index is None else torch.device(device))
        torch.cuda.set_device(dev)
        device_type = "cuda"
    else:
        dev = torch.device(device)
        if dev.type != "cpu":
            raise ValueError(f"make_mesh: unsupported device {device!r}")
        device_type = "cpu"
    device_mesh = DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis_name,))
    return Mesh(device_mesh, axis_name, dev)


class Sharding:
    """Where an array's axes go: ``spec[i]`` is the mesh axis that axis
    ``i`` splits over, or None (replicated)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self):
        return f"Sharding({self.spec})"


def data_sharding(mesh: Mesh, ndim: int = 2, axis_name: str = "data") -> Sharding:
    """Axis 0 split over the mesh, the other axes replicated."""
    return Sharding(mesh, (axis_name,) + (None,) * (ndim - 1))


def replicate(tree, mesh: Mesh):
    """``tree`` itself: in the SPMD port every rank holds its own copy of a
    replicated value, and keeping the copies equal is the caller's
    contract (the same inputs, the same generator stream)."""
    return tree


def shard_rows(arr, mesh: Mesh, axis_name: str = "data"):
    """This rank's rows of ``arr`` (all ``n`` rows, on every rank) as a
    tensor on the mesh's device, and the :class:`RowSplit` that gathers
    them back (``rows.gather(local)``)."""
    t = torch.as_tensor(arr, device=mesh.device)
    rows = mesh.rows(t.shape[0])
    return rows.take(t).contiguous(), rows


def rowwise_shard_map(fn, mesh: Mesh, n_row_args: int, axis_name: str = "data",
                      seed_arg: Optional[int] = None, pad_multiple: int = 1):
    """``fn`` run on each rank's rows, the rows gathered back.

    ``wrapped(*args)``: the first ``n_row_args`` arguments hold all ``n``
    rows on every rank; they are padded with zeros to a multiple of
    ``mesh.size * pad_multiple`` rows, so each rank's block is a multiple
    of ``pad_multiple``, and each rank calls ``fn`` on its block with the
    other arguments as given.  ``seed_arg`` names an int32 ``[2]`` kernel
    seed, which gets the rank added to its second word (world 1 is
    unchanged).  Every output carries the row axis and comes back with all
    ``n`` rows on every rank (a tensor or a tuple of them)."""
    chunk = mesh.size * max(1, int(pad_multiple))

    def wrapped(*args):
        row_args, rest = list(args[:n_row_args]), list(args[n_row_args:])
        n = row_args[0].shape[0]
        n_pad = -(-n // chunk) * chunk
        if n_pad != n:
            row_args = [torch.cat([a, a.new_zeros((n_pad - n,) + tuple(a.shape[1:]))])
                        for a in row_args]
        rows = mesh.rows(n_pad)
        local = [rows.take(a).contiguous() for a in row_args]
        if seed_arg is not None:
            i = seed_arg - n_row_args
            rest[i] = mesh.mix_seed(rest[i])
        out = fn(*local, *rest)
        single = torch.is_tensor(out)
        outs = [rows.gather(o)[:n] for o in ((out,) if single else out)]
        return outs[0] if single else tuple(outs)

    return wrapped


def replicated_shard_map(fn, mesh: Mesh):
    """``fn`` itself: every rank runs it on identical inputs and gets the
    identical result (JAX's replicated ``shard_map``, e.g. the per-minibatch
    latent update).  ``fn`` must be deterministic in its inputs."""
    return fn
