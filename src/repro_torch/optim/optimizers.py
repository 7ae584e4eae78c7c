"""Optimizers: AdamW and Adafactor (factored second moment).

PyTorch port of ``repro.optim.optimizers``: the same formulas, in the same
float32 order, on the port's nested dicts of tensors (a model's
``params.tree()``), and the same state trees -- AdamW ``{"m", "v",
"step"}``, Adafactor ``{"f": {leaf: {"vr", "vc"} or {"v"}}, "step"}`` --
so a checkpoint's keys are the JAX package's.  ``update(grads, state,
params)`` returns (updates, new state), as the JAX optimizers do; the
caller adds the updates.  Adafactor is what the 398B-class configs name
(float32 Adam moments would not fit their memory plan); ``state_dtype``
keeps AdamW's moments in bf16 above 5e10 parameters.

On a mesh the parameters, gradients and state are this rank's blocks
(``launch/mesh.py::Mesh``; ``pspecs`` the parameters' specs) and ``init``
and ``update`` take ``mesh=`` and ``pspecs=``.  AdamW is elementwise and
needs no collective.  Adafactor decides which leaves are factored by
their global shapes, and takes its means (the row and column means of
g^2, the mean of the row statistic, the update's RMS) over each whole
leaf: a mean over a dimension split over more than one rank is the sum of
the blocks' sums over its group, over the global count.
``state_specs`` gives the specs of a state tree ``init`` made, and is the
one the port uses (the Trainer, checkpoints, ``reshard``).
``state_pspecs`` and ``opt_state_pspecs`` repeat the JAX package's rule,
for parity with it only: it decides by a spec's length, so it differs
where a dimension of 1 keeps a leaf of two or more dimensions unfactored,
and must not be used on a state tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist


def _map(fn: Callable, params: Dict[str, Any], *others):
    """``fn(leaf, *matching subtrees of others)`` over the dict structure
    of ``params`` (a state tree's leaf may itself be a dict)."""
    return {k: (_map(fn, v, *(o[k] for o in others)) if isinstance(v, dict)
                else fn(v, *(o[k] for o in others)))
            for k, v in params.items()}


def _pick(tree, i: int):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _device(params) -> torch.device:
    for v in params.values():
        return _device(v) if isinstance(v, dict) else v.device
    return torch.device("cpu")


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class _Leaf:
    """One leaf's layout on a mesh: its global shape, and for each dimension
    the group of more than one rank that splits it (else None)."""

    def __init__(self, p: torch.Tensor, spec, mesh):
        self.mesh = mesh
        self.shape, self.groups = tuple(p.shape), [None] * p.dim()
        if mesh is None:
            return
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        shape = list(p.shape)
        for i, entry in enumerate(spec or ()):
            n = 1
            for a in _entry_axes(entry):
                n *= sizes[a]
            shape[i] *= n
            if n > 1:
                self.groups[i] = mesh.group(entry)
        self.shape = tuple(shape)

    def mean(self, x: torch.Tensor, dim: int, of: int,
             keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)``, ``dim`` of ``x`` being the leaf's dimension
        ``of``: over the whole leaf when that dimension is split."""
        group = self.groups[of]
        if group is None:
            return x.mean(dim, keepdim=keepdim)
        s = self.mesh.all_reduce(x.sum(dim, keepdim=keepdim),
                                 dist.ReduceOp.SUM, group)
        return s / self.shape[of]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """``torch.mean(x)`` over the whole leaf."""
        groups = [g for g in self.groups if g is not None]
        if not groups:
            return torch.mean(x)
        s = x.sum()
        for g in groups:
            s = self.mesh.all_reduce(s, dist.ReduceOp.SUM, g)
        return s / math.prod(self.shape)


def _layouts(params, mesh, pspecs):
    """Each parameter's ``_Leaf`` (global shapes; no groups off a mesh)."""
    if mesh is None:
        return _map(lambda p: _Leaf(p, None, None), params)
    return _map(lambda p, sp: _Leaf(p, sp, mesh), params, pspecs)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Optional[str] = None  # None => follow param dtype

    def _sdtype(self, p):
        return getattr(torch, self.state_dtype) if self.state_dtype \
            else p.dtype

    def init(self, params, mesh=None, pspecs=None):
        """Zero moments shaped like ``params`` (blocks or not: AdamW is
        elementwise, so ``mesh`` and ``pspecs`` change nothing)."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=self._sdtype(p),
                               device=p.device)

        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params, mesh=None, pspecs=None):
        step = state["step"] + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(self.b1, t)
        c2 = 1.0 - torch.pow(self.b2, t)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m1 = self.b1 * m.to(torch.float32) + (1 - self.b1) * gf
            v1 = self.b2 * v.to(torch.float32) + (1 - self.b2) * gf * gf
            u = (m1 / c1) / (torch.sqrt(v1 / c2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return ((-self.lr * u).to(p.dtype), m1.to(m.dtype),
                    v1.to(v.dtype))

        out = _map(lambda p, g, m, v: upd(g, m, v, p), params, grads,
                   state["m"], state["v"])
        updates, m, v = (_pick(out, i) for i in range(3))
        return updates, {"m": m, "v": v, "step": step}

    def state_pspecs(self, param_pspecs):
        """The JAX package's state specs (each moment the parameter's), for
        parity with it; a state tree's specs are ``state_specs``'."""
        return {"m": param_pspecs, "v": param_pspecs, "step": ()}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8       # beta2 = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape):
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(self, params, mesh=None, pspecs=None):
        """The second-moment statistics of ``params`` (this rank's blocks
        on ``mesh``, factored by the leaves' global shapes)."""
        def make(p, leaf):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)

            if self._factored(leaf.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"f": _map(make, params, _layouts(params, mesh, pspecs)),
                "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params, mesh=None, pspecs=None):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - torch.pow(t, -self.decay)

        def upd(p, g, f, leaf):
            gf = g.to(torch.float32)
            g2 = gf * gf + self.eps
            if self._factored(leaf.shape):
                vr = beta2 * f["vr"] + (1 - beta2) * leaf.mean(g2, -1, -1)
                vc = beta2 * f["vc"] + (1 - beta2) * leaf.mean(g2, -2, -2)
                del g2
                # vr's last dimension is the leaf's second-to-last
                vr_hat = vr / torch.clamp(leaf.mean(vr, -1, -2, True),
                                          min=self.eps)
                u = (gf * torch.rsqrt(vr_hat + self.eps)[..., None]
                     * torch.rsqrt(vc + self.eps)[..., None, :])
                nf = {"vr": vr, "vc": vc}
            else:
                v = beta2 * f["v"] + (1 - beta2) * g2
                u = gf * torch.rsqrt(v + self.eps)
                nf = {"v": v}
            del gf
            # update clipping (Shazeer & Stern eq. 9)
            rms = torch.sqrt(leaf.mean_all(u * u) + 1e-30)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            return (-self.lr * u).to(p.dtype), nf

        out = _map(upd, params, grads, state["f"],
                   _layouts(params, mesh, pspecs))
        updates, nf = (_pick(out, i) for i in range(2))
        return updates, {"f": nf, "step": step}

    def state_pspecs(self, param_pspecs):
        """The JAX package's state specs, for parity with it: vr drops the
        parameter spec's last entry, vc its second-to-last; a spec of fewer
        than two entries is an unfactored leaf's (decided by the spec's
        length, as JAX decides it).  ``init`` decides by the leaf's shape,
        so on a state tree use ``state_specs``."""
        def leaf_spec(ps):
            parts = list(ps)
            if len(parts) >= 2:
                return {"vr": tuple(parts[:-1]),
                        "vc": tuple(parts[:-2] + parts[-1:])}
            return {"v": tuple(ps)}

        return {"f": _map(leaf_spec, param_pspecs), "step": ()}


def opt_state_pspecs(opt, param_pspecs):
    """``opt.state_pspecs``, as the JAX package names it (parity only)."""
    return opt.state_pspecs(param_pspecs)


_STATE_SPEC = {"v": lambda sp: tuple(sp), "vr": lambda sp: tuple(sp[:-1]),
               "vc": lambda sp: tuple(sp[:-2]) + tuple(sp[-1:])}


def state_specs(state, param_pspecs):
    """The spec of every leaf of ``state``, a tree ``init`` made: a moment
    (AdamW's "m" and "v", Adafactor's unfactored "v") has its parameter's
    spec, "vr" drops its last entry, "vc" its second-to-last, "step" is
    replicated."""
    if "f" not in state:
        return {"m": param_pspecs, "v": param_pspecs, "step": ()}
    return {"f": _map(lambda sp, f: {k: _STATE_SPEC[k](sp) for k in f},
                      param_pspecs, state["f"]),
            "step": ()}


def make_optimizer(cfg, lr: float = 3e-4):
    """The config's optimizer: Adafactor where it names one, else AdamW
    (bf16 moments above 5e10 parameters), as the JAX package chooses."""
    if cfg.optimizer == "adafactor":
        return Adafactor(lr=lr)
    state_dtype = "float32"
    if cfg.param_count() > 5e10:
        state_dtype = "bfloat16"  # memory plan for 100B-class AdamW configs
    return AdamW(lr=lr, state_dtype=state_dtype)
