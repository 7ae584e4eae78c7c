"""Mixture-of-Experts FFN: top-k routing with capacity, sort-based dispatch.

PyTorch counterpart of ``repro.models.moe``.  Tokens are sorted by their
expert and gathered into a dense [E, C, d] buffer; tokens beyond an
expert's capacity C are dropped (they go to a sentinel row and their gate
weight is zeroed), as in Switch/GShard.  The steps follow the JAX
functions one for one:

  * top-k through a stable descending sort, so ties go to the lower
    expert index as ``lax.top_k`` breaks them;
  * ``cap = int(max(1, round(t*k*cf/E)))`` with Python's ``round`` (half
    to even);
  * a stable argsort of the flat expert ids and a left-sided
    ``searchsorted`` for each expert's first slot;
  * the combine a scatter-add (``index_add_``) in the activation dtype.
    On CUDA ``index_add_`` adds in no fixed order, so the card agrees with
    the CPU to rounding, not bit for bit.

With ``cfg.moe_grouped_dispatch`` and B > 1 each batch element is its own
routing group and ``aux`` is the mean over groups.

Expert parallelism (``tp``, ``models/sharding.py``): a rank holds a
contiguous block of the experts.  Every rank routes every token with the
replicated router (the same gates, dispatch, capacity and aux), runs only
its own experts' slots, adds their rows into [T, d] and sums the partial
outputs over ``model``; the shared expert shards like the dense FFN.  In
the backward pass the router, replicated over ``model``, gets each rank's
share of the gradient (its experts' gates, and its share of the aux), which
the train step sums over ``model``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.launch.mesh import all_gather
from repro_torch.models.layers import activation
from repro_torch.models.mlp import mlp
from repro_torch.models.sharding import NO_TP, TP


def _expert_ffn(we: dict, xe: torch.Tensor, cfg) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d] through the per-expert (gated) FFN."""
    if cfg.glu:
        g = activation(torch.bmm(xe, we["wg"]), cfg.act)
        return torch.bmm(g * torch.bmm(xe, we["wu"]), we["wd"])
    return torch.bmm(activation(torch.bmm(xe, we["wu"]), cfg.act), we["wd"])


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for a routing group of ``tokens`` tokens."""
    m = cfg.moe
    return int(max(1, round(tokens * m.top_k * m.capacity_factor
                            / m.num_experts)))


def moe_ffn(p: dict, x: torch.Tensor, cfg,
            tp: TP = NO_TP) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d].  Returns (out [B, S, d], aux f32 scalar).  When x is
    this rank's block of the batch's rows (``tp.batch_rows``), aux is its
    share over the dp ranks, which ``loss_fn`` sums (trap 3: an aux of the
    whole batch, routed as one group on every dp rank, enters the loss
    once): the global aux over their number, or, routing each row as its
    own group, this rank's groups' aux over the global batch."""
    if not cfg.moe_grouped_dispatch and tp.batch_rows is not None:
        # one routing group over the global batch: route every rank's rows
        # (the capacity counts them all), keep this rank's
        a0, a1 = tp.batch_rows
        xg = all_gather(x, tp.mesh, tp.mesh.lane_group, 0)
        out, aux = _moe_tokens(p, xg, cfg, tp)
        out = out[a0:a1]
    elif cfg.moe_grouped_dispatch and x.shape[0] > 1:
        outs, auxs = zip(*(_moe_tokens(p, x[i:i + 1], cfg, tp)
                           for i in range(x.shape[0])))
        out, aux = torch.cat(outs, 0), torch.stack(auxs).mean()
    else:
        out, aux = _moe_tokens(p, x, cfg, tp)
    if tp.batch_rows is not None:
        aux = aux / tp.mesh.lane_shards
    return out, aux


def route(p: dict, xt: torch.Tensor, cfg):
    """Router of ``t`` tokens xt [t, d]: (gate [t, k] f32, renormalised;
    choice [t, k] int64; probs [t, E] f32)."""
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate, choice = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, choice, probs


def dispatch(choice: torch.Tensor, cap: int, n_experts: int):
    """Sort the (token, k) pairs by expert: (slot [t*k] — the pair's row
    in the [E*cap] expert buffer, or the sentinel ``E*cap`` when its
    expert is full —, keep [t*k] bool, token [t*k], order [t*k]), all in
    expert-sorted order."""
    t, k = choice.shape
    dev = choice.device
    flat_e = choice.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    start = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos = torch.arange(t * k, device=dev) - start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos,
                       torch.full_like(se, n_experts * cap))
    return slot, keep, st, order


def _moe_tokens(p: dict, x: torch.Tensor, cfg,
                tp: TP = NO_TP) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.num_experts
    xt = x.reshape(t, d)
    gate, choice, probs = route(p, xt, cfg)

    # load-balancing auxiliary loss (Switch eq. 4)
    one_hot = choice[:, :1] == torch.arange(e, device=x.device)  # no sync
    density = one_hot.to(torch.float32).mean(0)
    aux = e * torch.sum(density * probs.mean(0))

    cap = capacity(t, cfg)
    slot, keep, st, order = dispatch(choice, cap, e)
    sg = gate.reshape(-1)[order]

    # scatter token ids into expert slots (empty slots read a zero row)
    src = torch.full((e * cap + 1,), t, dtype=torch.int64, device=x.device)
    src[slot] = st
    xz = torch.cat([xt, xt.new_zeros((1, d))])
    # this rank's experts [e0, e0 + e_loc) (all of them off a mesh)
    e_loc = p["experts"]["wu"].shape[0]
    e0 = tp.offset(e_loc, e)
    rows = src[e0 * cap:(e0 + e_loc) * cap]
    ye = _expert_ffn(p["experts"], xz[rows].reshape(e_loc, cap, d), cfg)
    ye = ye.reshape(e_loc * cap, d)
    if e_loc < e:       # other ranks' slots read zero rows
        ye = torch.cat([ye.new_zeros((e0 * cap, d)), ye, ye.new_zeros(
            ((e - e0 - e_loc) * cap, d))])

    # combine: each kept (token, k) pair reads its expert's row
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    w = torch.where(keep, sg, torch.zeros_like(sg)).to(ye.dtype)
    out_flat = ye[slot] * w[:, None]
    out = tp.reduce(ye.new_zeros((t, d)).index_add_(0, st, out_flat),
                    e_loc < e)
    if m.shared_expert:
        out = out + mlp(p["shared"], xt, cfg, tp)
    return out.reshape(b, s, d), aux
