"""RWKV6 ("Finch") time-mix: gated linear recurrence with data-dependent
per-channel decay (arXiv:2404.05892), in chunked matmul form.

PyTorch counterpart of ``repro.models.rwkv``.  State recurrence (per head,
hd x hd state S):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora_w(x_t))) in (0,1) per channel.

Each chunk of ``chunk`` tokens computes its intra-chunk terms in the
pairwise-exact form of the JAX function: masked pairs are set to -inf
before ``exp``, so every exponent that reaches ``exp`` is <= 0.  The
chunks run in a Python loop carrying S in float32; the last chunk is
padded.  Prefill uses chunk 64, a decode step chunk 1 (the exact
recurrence).

On a mesh (``tp``, ``models/sharding.py``) a rank holds a block of the
heads: ``wr``/``wk``/``wv``/``wg``, ``w0``, ``dec_b``, ``ln_x`` ("qdim")
and ``u`` ("heads") are local, its wkv state is its heads' (the group norm
is per head), ``wo`` is row-parallel with a sum over ``model``, and the
LoRA ``mix_a``/``dec_a`` and the shift state are replicated.  ``mix_b``'s
column block would give each rank only its columns of the five mixed
inputs, which every projection needs whole: it is gathered first.  Where
the heads do not split over ``model`` but ``d`` does, every "qdim" leaf is
gathered and the mix runs whole on each rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import group_rmsnorm
from repro_torch.models.sharding import NO_TP, TP

# "qdim" leaves of the time mix and the dimension of their column block
_QDIM = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w0": 0, "dec_b": 1,
         "ln_x": 0}


def _ddlerp(p, x, prev):
    """Data-dependent token-shift interpolation for the 5 streams
    (r, k, v, w, g)."""
    xx = prev - x
    base = x + xx * p["mu_x"]
    lora = torch.tanh(base @ p["mix_a"])               # [B,S,5*L]
    lora = lora.reshape(*lora.shape[:-1], 5, -1)       # [B,S,5,L]
    adj = torch.einsum("bsfl,fld->bsfd", lora, p["mix_b"])
    mixed = x[..., None, :] + xx[..., None, :] * (p["mu"] + adj)
    return mixed.unbind(-2)                            # r, k, v, w, g


def _chunk(S, rc, kc, vc, lw, u):
    """One chunk: S [B,H,hd,hd] f32; rc/kc/vc/lw [B,c,H,hd] f32; u [H,hd].
    Returns (S', y [B,c,H,hd])."""
    c = rc.shape[1]
    cl = torch.cumsum(lw, dim=1)                # inclusive cumulative logw
    cl_ex = cl - lw                             # exclusive
    # inter-chunk: y_t += (r_t * exp(cl_ex_t)) @ S   (cl_ex <= 0)
    y = torch.einsum("bchi,bhij->bchj", rc * torch.exp(cl_ex), S)
    # intra-chunk, strictly causal s < t:
    #   A[t,s] = sum_i r[t,i] k[s,i] exp(cl_ex[t,i] - cl[s,i])
    if c > 1:
        mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                     device=rc.device), -1)
        clx_h = cl_ex.permute(0, 2, 1, 3)                    # [B,H,c,hd]
        cl_h = cl.permute(0, 2, 1, 3)
        expo = clx_h[:, :, :, None, :] - cl_h[:, :, None, :, :]
        expo = expo.masked_fill(~mask[None, None, :, :, None], float("-inf"))
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc.permute(0, 2, 1, 3),
                           kc.permute(0, 2, 1, 3), torch.exp(expo))
        del expo
        y = y + torch.einsum("bhts,bshj->bthj", att, vc)
    # bonus current-token term: y_t += sum_i r[t,i] u[i] k[t,i] v[t,:]
    bonus = torch.einsum("bchi,hi,bchi->bch", rc, u, kc)
    y = y + bonus[..., None] * vc
    # state update: S' = diag(prod w) S + sum_s diag(exp(cl_end-cl_s)) k v
    cl_end = cl[:, -1][:, :, :, None]                        # [B,H,hd,1]
    k_tail = kc * torch.exp(cl[:, -1][:, None] - cl)
    S = torch.exp(cl_end) * S + torch.einsum("bchi,bchj->bhij", k_tail, vc)
    return S, y


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg, state: Tuple,
                  chunk: int = 64, tp: TP = NO_TP):
    """x: [B,S,d].  state: (wkv [B,H,hd,hd] (the rank's heads on a mesh),
    shift [B,d]).  Returns (out [B,S,d], (wkv' in wkv's dtype, shift'
    [B,d]))."""
    b, s, d_model = x.shape
    hd = cfg.rwkv.head_dim
    p = dict(p, mix_b=tp.full(p["mix_b"], 2, d_model))
    if p["u"].shape[0] * hd == d_model and p["wr"].shape[1] < d_model:
        p.update({k: tp.full(p[k], dim, d_model)
                  for k, dim in _QDIM.items()})
    h = p["u"].shape[0]
    d = h * hd                                   # this rank's channels
    wkv0, shift = state
    prev = torch.cat([shift[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, prev)

    f32 = torch.float32
    r = (xr @ p["wr"]).reshape(b, s, h, hd).to(f32)
    k = (xk @ p["wk"]).reshape(b, s, h, hd).to(f32)
    v = (xv @ p["wv"]).reshape(b, s, h, hd).to(f32)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay, log-space: logw in (-inf, 0)
    dec = p["w0"] + torch.tanh(xw @ p["dec_a"]) @ p["dec_b"]
    logw = -torch.exp(dec.to(f32)).reshape(b, s, h, hd)
    u = p["u"].to(f32)                                       # [H, hd]

    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    S = wkv0.to(f32)
    ys = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        S, y = _chunk(S, r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :s]
    y = group_rmsnorm(y, p["ln_x"].reshape(h, hd)).reshape(b, s, d)
    out = tp.reduce((y.to(x.dtype) * g) @ p["wo"], d < d_model)
    return out, (S.to(wkv0.dtype), x[:, -1, :])


def rwkv_time_mix_step(p: dict, x: torch.Tensor, cfg, state: Tuple):
    """Single-token decode step (exact recurrence). x: [B,1,d]."""
    return rwkv_time_mix(p, x, cfg, state, chunk=1)
