"""One rank's share of a sharded LM: the JAX ``NamedSharding`` block of a
leaf, and the tensor-parallel context the model's layers compute in.

A *spec* is a tuple with one entry per dimension, entry by entry the JAX
``PartitionSpec``: ``None``, a mesh axis name, or a tuple of names (the dp
axes, pod x data).  A rank's *block* of a leaf is the block JAX places on
the device at that rank's mesh coordinates: contiguous, split row-major
over the entry's axes (pod outermost).  ``repro_torch.launch.mesh.Mesh``
gives the coordinates and the process groups; a stand-in with
``axis_names`` and ``shape`` serves the block arithmetic alone.

:class:`TP` is what the layers see of the ``model`` axis.  Each layer
reads from its parameters' local shapes whether a leaf is split over
``model`` (its block is smaller than the config's dimension) and sums its
partial products with :meth:`TP.reduce`; :data:`NO_TP` (one shard) makes
every method the identity, so the mesh-free path computes what it always
has.  The collectives are differentiable (``launch/mesh.py``): a sharded
model trains through the same layers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import all_gather, psum


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_coords(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """{axis: index} of ``rank`` (default: the mesh's own) on ``mesh``."""
    if rank is None and hasattr(mesh, "coords"):
        return dict(mesh.coords)
    rank = mesh.rank if rank is None else rank
    return {a: int(c) for a, c in zip(mesh.axis_names,
                                      np.unravel_index(rank, mesh.shape))}


def shard_slices(shape, spec, mesh, coords: Dict[str, int]) -> tuple:
    """The slice of each dimension that the rank at ``coords`` holds."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = []
    for i, dim in enumerate(shape):
        axes = _axes(spec[i] if i < len(spec) else None)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {axes} ({n} ranks)")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        blk = dim // n
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def block(t, spec, mesh, coords: Dict[str, int]):
    """The rank's block of one full leaf: a copy, so the full leaf can go."""
    sl = shard_slices(tuple(t.shape), spec, mesh, coords)
    return t[sl].clone()


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's block (all-gathers over each
    sharded dimension's group; differentiable, ``launch.mesh.all_gather``)."""
    for i, entry in enumerate(spec):
        if entry is not None:
            t = all_gather(t, mesh, mesh.group(entry), i)
    return t


def replicated_axes(spec, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` (of more than one rank) that a leaf of
    ``spec`` is not split over: it has a replica on each of their ranks."""
    named = {a for entry in spec for a in _axes(entry)}
    return tuple(a for a, n in zip(mesh.axis_names, mesh.shape)
                 if a not in named and n > 1)


class TP:
    """This rank's view of the ``model`` axis during a sharded forward:
    ``m`` shards, this rank's index ``r``, and the collectives over them.
    ``seq_split``: the self-attention cache is split by sequence over
    ``model`` (each rank holds a block of positions).  ``batch_rows``:
    (start, stop) of this rank's rows of the global batch when the batch
    is split over the dp axes, else None."""

    def __init__(self, mesh=None, seq_split: bool = False,
                 batch_rows: Optional[Tuple[int, int]] = None):
        self.mesh = mesh
        self.m = mesh.model_shards if mesh is not None else 1
        self.r = mesh.model_index if mesh is not None else 0
        self.seq_split = seq_split and self.m > 1
        self.batch_rows = batch_rows

    def offset(self, n_local: int, n_global: int) -> int:
        """First global index of this rank's block of a dimension of
        ``n_global`` whose local block is ``n_local`` (0 when whole)."""
        return self.r * n_local if n_local < n_global else 0

    def reduce(self, t: torch.Tensor, split: bool = True) -> torch.Tensor:
        """Sum partial products over ``model`` (in float32, rounded once to
        ``t``'s dtype), when ``split`` says the reduction was split; the
        gradient is summed over ``model`` too (``launch.mesh.psum``)."""
        if self.m == 1 or not split:
            return t
        out = psum(t.to(torch.float32), self.mesh, self.mesh.model_group)
        return out.to(t.dtype)

    def gather(self, t: torch.Tensor, dim: int,
               layout: bool = False) -> torch.Tensor:
        """Every model shard's ``t`` concatenated along ``dim``; its
        gradient is reduce-scattered back (``launch.mesh.all_gather``).
        ``layout``: the gather exists because a leaf's layout does not match
        the local computation (GSPMD's reshard); its bytes, both ways, go to
        ``layout_bytes``."""
        if self.m == 1:
            return t
        return all_gather(t, self.mesh, self.mesh.model_group, dim,
                          layout=layout)

    def full(self, t: torch.Tensor, dim: int, n_global: int) -> torch.Tensor:
        """``t`` whole along ``dim``: gathered (a layout gather) when this
        rank holds only its block."""
        return t if t.shape[dim] == n_global else self.gather(t, dim, True)


NO_TP = TP()
