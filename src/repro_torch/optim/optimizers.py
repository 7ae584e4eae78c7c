"""Optimizers: AdamW and Adafactor (factored second moment).

PyTorch port of ``repro.optim.optimizers``: the same formulas, in the same
float32 order, on the port's nested dicts of tensors (a model's
``params.tree()``), and the same state trees -- AdamW ``{"m", "v",
"step"}``, Adafactor ``{"f": {leaf: {"vr", "vc"} or {"v"}}, "step"}`` --
so a checkpoint's keys are the JAX package's.  ``update(grads, state,
params)`` returns (updates, new state), as the JAX optimizers do; the
caller adds the updates.  Adafactor is what the 398B-class configs name
(float32 Adam moments would not fit their memory plan); ``state_dtype``
keeps AdamW's moments in bf16 above 5e10 parameters.  The sharding specs
(``state_pspecs``, ``opt_state_pspecs``) wait for ROADMAP A11c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch


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

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=self._sdtype(p),
                               device=p.device)

        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
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


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8       # beta2 = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape):
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(self, params):
        def make(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)

            if self._factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"f": _map(make, params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - torch.pow(t, -self.decay)

        def upd(p, g, f):
            gf = g.to(torch.float32)
            g2 = gf * gf + self.eps
            if self._factored(p.shape):
                vr = beta2 * f["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * f["vc"] + (1 - beta2) * g2.mean(-2)
                del g2
                vr_hat = vr / torch.clamp(vr.mean(-1, keepdim=True),
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
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            return (-self.lr * u).to(p.dtype), nf

        out = _map(upd, params, grads, state["f"])
        updates, nf = (_pick(out, i) for i in range(2))
        return updates, {"f": nf, "step": step}


def make_optimizer(cfg, lr: float = 3e-4):
    """The config's optimizer: Adafactor where it names one, else AdamW
    (bf16 moments above 5e10 parameters), as the JAX package chooses."""
    if cfg.optimizer == "adafactor":
        return Adafactor(lr=lr)
    state_dtype = "float32"
    if cfg.param_count() > 5e10:
        state_dtype = "bfloat16"  # memory plan for 100B-class AdamW configs
    return AdamW(lr=lr, state_dtype=state_dtype)
