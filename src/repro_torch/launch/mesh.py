"""Meshes of ranks for the sharded TCQ pipeline and the sharded LM
(PyTorch counterpart of ``repro.launch.mesh``).

JAX runs one controller over a ``jax.sharding.Mesh`` of devices;
``torch.distributed`` runs one process per rank.  A :class:`Mesh` is this
rank's view of a ``DeviceMesh`` with axes ``("data", "model")`` or
``("pod", "data", "model")``: its coordinates, the process groups the TCQ
pipeline reduces over (``model``: the edge shards of one lane group;
``lanes``: pod x data, the ranks holding one model shard), the device it
computes on, and the collectives it needs.  The LM's spec functions
(``models/transformer.py::param_pspecs``, ``launch/shapes.py``) read only
``axis_names`` and ``shape``, so a plain stand-in with those two fields
serves them without a process group.  ``all_gather`` and ``psum`` are the
collectives the sharded LM trains through: autograd Functions whose
adjoints are a reduce-scatter and a psum.

The backend is always the caller's, never picked here:

* ``nccl``: one rank per card, collectives on CUDA tensors;
* ``gloo`` on the CPU: the CPU tests' worlds of several processes;
* ``gloo`` with CUDA compute: several ranks sharing one card (NCCL refuses
  two ranks on one device).  Gloo's CUDA support covers broadcast and
  all-reduce only, so such a mesh stages every collective operand through
  host memory (``Mesh.host_staged``); its times are not NCCL's.

The device is the rank's card over either backend, and a mesh raises
where there is none, unless the caller passes ``device="cpu"``.

Functions, not module state: importing this module starts no process group.
"""

from __future__ import annotations

import datetime
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
AXES_MULTI_POD = ("pod", "data", "model")
BACKENDS = ("nccl", "gloo")


def init_world(backend: str, *, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = 300.0) -> None:
    """Bring the default process group up, over ``backend``.

    With ``init_method``/``rank``/``world_size`` the caller names the
    rendezvous (``file://...`` in the tests and spawned worlds); otherwise
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
    when it is set, else a world of one rank over an in-process store.
    A group already up must use the same backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group is up over "
                             f"{dist.get_backend()!r}, not {backend!r}")
        return
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if init_method is not None or rank is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(world_size),
                                timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def _no_card(backend: str) -> RuntimeError:
    return RuntimeError(f"a {backend} mesh computes on CUDA unless told "
                        "otherwise and no CUDA device is available; pass "
                        "device='cpu' to run the plain versions")


def rank_device(backend: str, device=None) -> torch.device:
    """This rank's compute device: ``device`` when given, else the card
    ``LOCAL_RANK`` names (rank modulo the cards seen), over either
    backend.  Raises when there is no card: a mesh runs on the CPU only
    when the caller passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise _no_card(backend)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """This rank's view of a mesh of ranks (the default process group's
    world, laid out row-major over ``axis_names``)."""

    def __init__(self, shape, axis_names=AXES, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: bring the process group up first "
                               "(launch.mesh.init_world)")
        n = math.prod(int(s) for s in shape)
        if n != dist.get_world_size():
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                             f"{n} ranks; the world has "
                             f"{dist.get_world_size()}")
        self._place(shape, axis_names, dist.get_rank())
        shape, axis_names = self.shape, self.axis_names
        self.backend = dist.get_backend()
        self.device = rank_device(self.backend, device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl mesh computes on CUDA devices")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.host_staged = (self.backend == "gloo"
                            and self.device.type == "cuda")
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh(
            "cuda" if self.backend == "nccl" else "cpu",
            torch.arange(self.size).reshape(shape),
            mesh_dim_names=axis_names)
        self.model_group = self.device_mesh.get_group("model")
        self.data_group = self.device_mesh.get_group("data")
        self._groups = {"model": self.model_group, "data": self.data_group}
        if len(shape) == 2:
            self.lane_group = self.data_group
        else:
            # pod x data flattened: every rank joins the creation of every
            # lane group, in the same order
            grid = np.arange(self.size).reshape(self.lane_shards,
                                                self.model_shards)
            for mi in range(self.model_shards):
                group = dist.new_group(grid[:, mi].tolist())
                if mi == self.model_index:
                    self.lane_group = group

    def _place(self, shape, axis_names, rank: int) -> None:
        """Rank ``rank``'s coordinates in a mesh of ``shape``, and its
        zeroed byte counters."""
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if axis_names not in (AXES, AXES_MULTI_POD) or \
                len(shape) != len(axis_names):
            raise ValueError(f"mesh axes must be {AXES} or "
                             f"{AXES_MULTI_POD}, got {axis_names} for "
                             f"shape {shape}")
        self.shape, self.axis_names = shape, axis_names
        self.size, self.rank = math.prod(shape), int(rank)
        coords = np.unravel_index(self.rank, shape)
        self.coords = {a: int(c) for a, c in zip(axis_names, coords)}
        self.model_shards = shape[-1]
        self.lane_shards = self.size // self.model_shards
        self.model_index = int(coords[-1])
        self.lane_index = int(np.ravel_multi_index(coords[:-1], shape[:-1]))
        # bytes of the operands this rank handed to each data collective
        # that ran (a group of one runs none): measured, beside the
        # pipeline's analytic ``collective_bytes`` of the degree combine
        self.sent_bytes = {"all_reduce": 0, "all_gather": 0,
                           "reduce_scatter": 0}
        # bytes of the full tensors the sharded LM assembled because a
        # leaf's JAX layout does not match a local computation (GSPMD's
        # gathers: Mamba's in_proj, a head-splitting column block, ...)
        self.layout_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank}, {self.backend} on {self.device})")

    def group(self, axes):
        """The process group over ``axes``: one axis name, or a tuple of
        them (the dp axes, pod x data: the lane group)."""
        if isinstance(axes, tuple):
            if len(axes) == 1:
                axes = axes[0]
            elif axes == dp_axes(self):
                return self.lane_group
            else:
                raise ValueError(f"no group over {axes}")
        if axes in self._groups:
            return self._groups[axes]
        return self.device_mesh.get_group(axes)

    # ------------------------------------------------------- collectives
    # The seam between the bookkeeping and the transport: the size of a
    # group, the line that counts each data collective's operand bytes,
    # and the call that moves them.  ``ShapeMesh`` overrides the three.
    def group_size(self, group) -> int:
        """The number of ranks in ``group`` (the world when None)."""
        return dist.get_world_size(group)

    def _note(self, kind: str, x: torch.Tensor, group) -> None:
        """Count the operand ``x`` this rank hands to a ``kind``
        collective over ``group``."""
        self.sent_bytes[kind] += x.nbytes

    def _move(self, call: str, *args, **kwargs) -> None:
        """Run the ``torch.distributed`` collective ``call``."""
        getattr(dist, call)(*args, **kwargs)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return (t.cpu() if self.host_staged else t).contiguous()

    def gather_dim(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        """Concatenate every group member's ``t`` along ``dim``, in group
        rank order, bit for bit in any dtype (16-bit floats and bools
        travel as bytes: gloo moves neither 16-bit integers nor, in every
        build, bfloat16)."""
        if self.group_size(group) == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        if t.dtype in (torch.bfloat16, torch.float16, torch.bool):
            out = self.all_gather(x.reshape(-1).view(torch.uint8), group)
            out = out.view(t.dtype).reshape((-1,) + tuple(x.shape[1:]))
        else:
            out = self.all_gather(x, group)
        return out.movedim(0, dim)

    def all_reduce(self, t: torch.Tensor, op, group=None) -> torch.Tensor:
        """Elementwise reduction of ``t`` over ``group`` (the world when
        None); returns the result on ``t``'s device."""
        if self.group_size(group) == 1:
            return t
        x = self._wire(t).clone()
        self._note("all_reduce", x, group)
        self._move("all_reduce", x, op=op, group=group)
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """Concatenate every group member's ``t`` along dim 0, in group
        rank order."""
        n = self.group_size(group)
        if n == 1:
            return t
        x = self._wire(t)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._note("all_gather", x, group)
        self._move("all_gather_into_tensor", out, x, group=group)
        return out.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, group) -> torch.Tensor:
        """Sum ``t`` over ``group`` and keep this member's 1/n of dim 0
        (JAX's ``psum_scatter(scatter_dimension=0, tiled=True)``)."""
        n = self.group_size(group)
        if n == 1:
            return t
        x = self._wire(t)
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        self._note("reduce_scatter", x, group)
        self._move("reduce_scatter_tensor", out, x, group=group)
        return out.to(t.device)

    def scatter_dim(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        """Sum ``t`` over ``group`` and keep this member's block of ``dim``
        (the inverse layout of :meth:`gather_dim`), summed in float32 and
        returned in ``t``'s dtype."""
        if self.group_size(group) == 1:
            return t
        x = t.movedim(dim, 0).to(torch.float32).contiguous()
        return self.reduce_scatter(x, group).movedim(0, dim).to(t.dtype)

    def sum_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over the ranks of the mesh axes ``axes`` (names):
        one all-reduce over the world, the dp axes' group or one axis's,
        else one per axis.  Axes of one rank are skipped."""
        sizes = dict(zip(self.axis_names, self.shape))
        axes = tuple(a for a in self.axis_names if a in axes and sizes[a] > 1)
        if not axes:
            return t
        wide = tuple(a for a in self.axis_names if sizes[a] > 1)
        if axes == wide:
            return self.all_reduce(t, dist.ReduceOp.SUM)
        dp = tuple(a for a in dp_axes(self) if sizes[a] > 1)
        if axes == dp:
            return self.all_reduce(t, dist.ReduceOp.SUM, self.lane_group)
        for a in axes:
            t = self.all_reduce(t, dist.ReduceOp.SUM, self.group(a))
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device="cpu" if self.backend == "gloo"
                         else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def clock(self) -> float:
        """Rank 0's ``time.perf_counter()``, the same value on every rank:
        whatever steers the replicated host control by the clock (a
        deadline, an arrival, a shed) reads it here, so every rank takes
        the same decision and the collectives stay matched."""
        now = time.perf_counter()
        if self.size == 1:
            return now
        t = torch.tensor([now], dtype=torch.float64,
                         device="cpu" if self.backend == "gloo"
                         else self.device)
        dist.broadcast(t, src=0)
        return float(t.item())


class _ShapeGroup:
    """A group of a :class:`ShapeMesh`: its members' global ranks."""

    def __init__(self, ranks, devices_per_node: int):
        self.ranks = tuple(int(r) for r in ranks)
        self.crosses_node = len({r // devices_per_node
                                 for r in self.ranks}) > 1


class ShapeMesh(Mesh):
    """Rank ``rank`` of a mesh of ``shape`` with no process group, for a
    dry run on ``meta`` tensors (``launch/dryrun.py``): the coordinates,
    groups and collectives of a live :class:`Mesh`, whose collectives
    return ``meta`` tensors of the right shapes and move nothing.  Each
    data collective is counted by the lines that count a live mesh's
    ``sent_bytes`` and ``layout_bytes``, and recorded in ``ops`` as a
    ``launch.analysis.CollectiveOp``: its kind, operand bytes, group size
    and whether the group spans more than one node of
    ``devices_per_node`` ranks (consecutive ranks share a node).  The
    control reads ``any`` and ``clock`` go to ``control_ops`` instead, as
    ``sent_bytes`` does not count them."""

    def __init__(self, shape, axis_names=AXES, *, rank: int = 0,
                 devices_per_node: int = 8):
        from repro_torch.launch.analysis import CollectiveOp

        if not 0 <= int(rank) < math.prod(shape):
            raise ValueError(f"rank {rank} is outside a mesh of "
                             f"{math.prod(shape)} ranks")
        self._place(shape, axis_names, rank)
        self._op = CollectiveOp
        self.backend = "shape"
        self.device = torch.device("meta")
        self.host_staged = False
        self.device_mesh = None
        self.ops = []
        self.control_ops = []
        shape, axis_names = self.shape, self.axis_names
        grid = np.arange(self.size).reshape(shape)

        def along(axis: int):
            at = [self.coords[a] for a in axis_names]
            at[axis] = slice(None)
            return _ShapeGroup(grid[tuple(at)].ravel(), devices_per_node)

        self._groups = {a: along(i) for i, a in enumerate(axis_names)}
        self._world = _ShapeGroup(range(self.size), devices_per_node)
        self.model_group = self._groups["model"]
        self.data_group = self._groups["data"]
        self.lane_group = (self.data_group if len(shape) == 2 else
                           _ShapeGroup(grid[..., self.model_index].ravel(),
                                       devices_per_node))

    def group_size(self, group) -> int:
        return len((self._world if group is None else group).ranks)

    def _note(self, kind: str, x: torch.Tensor, group) -> None:
        super()._note(kind, x, group)
        g = self._world if group is None else group
        self.ops.append(self._op(kind.replace("_", "-"), int(x.nbytes),
                                 len(g.ranks), g.crosses_node))

    def _move(self, call: str, *args, **kwargs) -> None:
        """Nothing moves: the outputs are ``meta`` tensors already."""

    def any(self, flag: bool) -> bool:
        self.control_ops.append(self._op("all-reduce", 4, self.size,
                                         self._world.crosses_node))
        return bool(flag)

    def clock(self) -> float:
        self.control_ops.append(self._op("broadcast", 8, self.size,
                                         self._world.crosses_node))
        return time.perf_counter()


# ------------------------------------------- differentiable collectives
# The sharded LM trains with each rank differentiating its share of the
# loss: the global loss divided by the ranks that compute the same rows
# (``models/transformer.py::loss_fn``), so that the gradient of a leaf is
# the sum over ranks of what each rank's backward gives it.  Under that
# convention every collective's adjoint is its transpose, whatever
# consumes its result: an all-gather's is a reduce-scatter, a sum's is a
# sum, and a replicated activation carries a partial gradient that no
# operator needs to sum on the way back (Megatron's "f" entry operator is
# the identity both ways).  The sums over replicas happen once, on the
# leaves (``launch/steps.py``).  Both operators are the identity on a group
# of one rank, so the unit mesh computes what the mesh-free model does.
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, group, dim, layout):
        ctx.mesh, ctx.group, ctx.dim, ctx.layout = mesh, group, dim, layout
        out = mesh.gather_dim(t, group, dim)
        if layout:
            mesh.layout_bytes += out.nbytes
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.layout:
            ctx.mesh.layout_bytes += g.nbytes
        return (ctx.mesh.scatter_dim(g, ctx.group, ctx.dim), None, None,
                None, None)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce(t, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_reduce(g.contiguous(), dist.ReduceOp.SUM,
                                    ctx.group), None, None)


def all_gather(t: torch.Tensor, mesh: Mesh, group, dim: int, *,
               layout: bool = False) -> torch.Tensor:
    """Every member's ``t`` of ``group`` concatenated along ``dim``
    (``Mesh.gather_dim``), differentiable: the gradient is summed over the
    group and each member keeps its block (a reduce-scatter, in float32).
    ``layout``: the gather assembles a leaf whose layout does not match the
    local computation; its bytes, and its gradient's, go to
    ``mesh.layout_bytes``."""
    if mesh.group_size(group) == 1:
        return t
    return _AllGather.apply(t, mesh, group, dim, layout)


def psum(t: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """``t`` summed over ``group`` (JAX's ``psum``), differentiable: the
    gradient is summed over the group too."""
    if mesh.group_size(group) == 1:
        return t
    return _Sum.apply(t, mesh, group)


def mesh_shard_counts(mesh) -> Tuple[int, int]:
    """(lane_shards, model_shards) of a mesh: lanes shard over pod x data,
    edges over model."""
    return mesh.lane_shards, mesh.model_shards


def dp_axes(mesh) -> tuple:
    """Mesh axes carrying the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    """The number of ranks over ``axes`` (names of ``mesh``'s axes)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         device=None) -> Mesh:
    """The production layouts over a world the launcher already brought
    up: 16 x 16 ranks (data, model), or 2 x 16 x 16 (pod, data, model)
    with ``pod`` outermost.  Raises unless the world has that many ranks."""
    init_world(backend)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return Mesh(shape, AXES_MULTI_POD if multi_pod else AXES, device=device)


def make_host_mesh(model: int = 1, *, device=None) -> Mesh:
    """(world / model, model) mesh over the ranks of this world, bringing
    the process group up first (``torchrun``'s environment, else a world
    of one rank): over ``gloo`` when ``device`` is the CPU, else over
    ``nccl`` on the rank's card (raising without one).  Ranks sharing one
    card bring a gloo group up themselves (:func:`init_world`) and build
    their :class:`Mesh`."""
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if not cpu and not torch.cuda.is_available():
        raise _no_card(backend)
    init_world(backend)
    world = dist.get_world_size()
    if world % int(model):
        raise ValueError(f"model={model} does not divide the world's "
                         f"{world} ranks")
    return Mesh((world // int(model), int(model)), AXES, device=device)
