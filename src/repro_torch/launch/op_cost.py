"""Per-device cost of one eager step: FLOPs, HBM bytes, kernel charges and
collectives (the PyTorch counterpart of ``repro.launch.hlo_cost``).

The JAX package reads the cost of a cell off XLA's post-partitioning HLO.
The port runs eager and has no HLO to read, so it counts what a step
dispatches while it runs, on ``meta`` tensors over a
``launch.mesh.ShapeMesh`` (``launch/dryrun.py``):

* **FLOPs** of the matrix products and attention, from
  ``torch.utils.flop_counter.FlopCounterMode`` (``hlo_cost.py`` too counts
  ``dot`` FLOPs alone);
* **HBM bytes**: each aten op reads its tensor inputs once and writes its
  outputs once, which is what an eager kernel does; views and aliases
  (``view``, ``transpose``, ``expand``, ``detach``, ...) and ``empty`` move
  nothing, as ``hlo_cost.py``'s ``_FREE_OPS`` (``bitcast``, ``tuple``,
  ...) move nothing;
* **kernel charges**: a hand-written kernel is no aten op; its dispatcher's
  ``meta`` branch calls :func:`charge_kernel` with the bytes of its inputs
  read once and its outputs written once (the bytes behind the kernel's
  roofline bound), counted under the kernel's name and in the HBM bytes;
* **collectives**: the ``CollectiveOp``s the mesh recorded meanwhile.

A loop that runs n times is counted n times because it runs, which is what
``hlo_cost.py``'s trip-count walk recovers for HLO.

    with OpCost(mesh) as cost:
        step(...)
    cost.flops, cost.bytes, cost.kernels, cost.collectives
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_ACTIVE: List["OpCost"] = []
# ops that allocate or alias and run no kernel
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_unsafe_view", "set_", "resize_"}
# in-place ops that overwrite their output without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_"}


def charge_kernel(name: str, nbytes: int) -> None:
    """Charge one call of the kernel ``name`` ``nbytes`` bytes on every
    active :class:`OpCost` (with none active, nothing happens)."""
    for cost in _ACTIVE:
        cost.kernels[name]["calls"] += 1
        cost.kernels[name]["bytes"] += int(nbytes)


def tensor_bytes(*tensors) -> int:
    """The bytes of ``tensors`` (each element once)."""
    return sum(int(t.nbytes) for t in tensors)


class _Bytes(TorchDispatchMode):
    """Counts each dispatched aten op's input and output bytes."""

    def __init__(self, owner: "OpCost"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _FREE or func.is_view:
            return out
        nbytes = 0
        schema = func._schema.arguments
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                written = (i < len(schema) and schema[i].alias_info
                           is not None and schema[i].alias_info.is_write)
                if not (written and name in _WRITE_ONLY):
                    nbytes += int(a.nbytes)
            elif isinstance(a, (list, tuple)):
                nbytes += tensor_bytes(*[x for x in a
                                         if isinstance(x, torch.Tensor)])
        for k, v in kwargs.items():
            if isinstance(v, torch.Tensor) and k != "out":
                nbytes += int(v.nbytes)
        leaves, _ = tree_flatten(out)
        nbytes += tensor_bytes(*[x for x in leaves
                                 if isinstance(x, torch.Tensor)])
        by = self.owner.by_op[name]
        by["calls"] += 1
        by["bytes"] += nbytes
        self.owner.op_bytes += nbytes
        return out


class OpCost:
    """Context manager counting one region's per-device cost; ``mesh`` (a
    ``ShapeMesh``, optional) gives the collectives recorded inside it."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.op_bytes = 0
        self.by_op: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "bytes": 0})
        self.kernels: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "bytes": 0})
        self.flops = 0
        self._flop = None
        self._bytes = None
        self._mark = (0, 0, 0)
        self._layout_end = None

    def __enter__(self) -> "OpCost":
        from torch.utils.flop_counter import FlopCounterMode

        ops = getattr(self.mesh, "ops", [])
        ctl = getattr(self.mesh, "control_ops", [])
        self._mark = (len(ops), len(ctl),
                      getattr(self.mesh, "layout_bytes", 0))
        self._flop = FlopCounterMode(display=False)
        self._flop.__enter__()
        self._bytes = _Bytes(self)
        self._bytes.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        self.flops = int(self._flop.get_total_flops())
        self._layout_end = getattr(self.mesh, "layout_bytes", 0)

    @property
    def bytes(self) -> int:
        """HBM bytes: every counted op's and every kernel charge's."""
        return self.op_bytes + sum(k["bytes"] for k in self.kernels.values())

    @property
    def collectives(self) -> list:
        """The data collectives the mesh ran inside the region."""
        return list(getattr(self.mesh, "ops", [])[self._mark[0]:])

    @property
    def sent_bytes(self) -> Dict[str, int]:
        """Operand bytes handed to each kind of data collective inside the
        region, keyed as ``Mesh.sent_bytes``."""
        out = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
        for op in self.collectives:
            out[op.kind.replace("-", "_")] += op.operand_bytes
        return out

    @property
    def layout_bytes(self) -> int:
        """``Mesh.layout_bytes`` added inside the region."""
        return (self._layout_end or 0) - self._mark[2]

    @property
    def control(self) -> list:
        """The control reads (``any``, ``clock``) inside the region."""
        return list(getattr(self.mesh, "control_ops", [])[self._mark[1]:])

    def top_ops(self, n: int = 8) -> list:
        """The ``n`` aten ops that moved the most bytes."""
        return sorted(({"op": k, **v} for k, v in self.by_op.items()),
                      key=lambda r: -r["bytes"])[:n]
