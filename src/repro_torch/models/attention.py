"""GQA attention: train/prefill (dense, or chunked online softmax for long
KV) and decode (cached KV).

PyTorch counterpart of ``repro.models.attention``: grouped KV (any
ratio), sliding window, attention-logit softcap, QKV bias, (M-)RoPE,
bidirectional self-attention (the whisper encoder) and cross-attention to
encoder states (the whisper decoder).

Masks are built from sequence ranks, never from per-batch position
tensors, so the mask is a batch-free [1, Sq, Sk] bias; RoPE uses the real
position tensors.  The arithmetic follows the JAX functions step for step:
scores and softmax in float32 (the JAX einsums' ``preferred_element_type``
is a float32 product of the inputs, here the inputs cast to float32), the
same max, exp, sum and division, so the two packages agree to float32
rounding.  No fused attention operator is used.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.sharding import NO_TP, TP

NEG_INF = -2.0e38


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _mask_bias(q_rank, k_rank, causal: bool, window: Optional[int],
               k_valid=None):
    """[1, Sq, Sk] additive bias in f32 from sequence ranks [1, S]."""
    d = q_rank[:, :, None] - k_rank[:, None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def _attend_dense(q, k, v, bias, scale, cap, scores_f32: bool = True):
    """q: [B,Sq,H,hd]; k/v: [B,Sk,KV,hd]; bias: [1,Sq,Sk].

    scores_f32=False keeps scores and weights in bf16 between the f32
    reductions, as the JAX option does."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, sq, kv, rep, hd)
    sdt = torch.float32 if scores_f32 else torch.bfloat16
    f32 = torch.float32
    logits = torch.einsum("bqkrh,bskh->bkrqs", qg.to(f32), k.to(f32)) * scale
    logits = (softcap(logits, cap) + bias[:, None, None, :, :]).to(sdt)
    m = torch.amax(logits.to(f32), dim=-1, keepdim=True)
    p = torch.exp(logits.to(f32) - m).to(sdt)
    den = torch.sum(p.to(f32), dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bskh->bqkrh", p.to(f32), v.to(f32))
    out = out / den.reshape(b, kv, rep, sq, 1).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _attend_partial(q, k, v, q_rank, k_rank, causal, window, scale, cap,
                    chunk: int = 1024, k_valid=None):
    """Online softmax over KV chunks, O(S·chunk) memory for long prefill.
    q_rank: [1, Sq]; k_rank: [1, Sk]; k_valid: [1, Sk] or None.  Returns
    the unnormalised state (m [B,KV,rep,Sq], l [B,KV,rep,Sq], acc
    [B,KV,rep,Sq,hd]) in float32: the running max, the sum of exponentials
    and the weighted values."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kv = k.shape[2]
    rep = h // kv
    f32 = torch.float32
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    valid = (k_valid if k_valid is not None
             else torch.ones((1, sk), dtype=torch.bool, device=k.device))
    if pad:             # padded keys: zero, rank -1, never valid
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_rank = torch.nn.functional.pad(k_rank, (0, pad), value=-1)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    qg = q.reshape(b, sq, kv, rep, hd).to(f32)

    m = torch.full((b, kv, rep, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kv, rep, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, kv, rep, sq, hd), dtype=f32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        bias = _mask_bias(q_rank, k_rank[:, sl], causal, window,
                          valid[:, sl])                       # [1,Sq,C]
        logits = torch.einsum("bqkrh,bckh->bkrqc", qg,
                              k[:, sl].to(f32)) * scale
        logits = softcap(logits, cap) + bias[:, None, None, :, :]
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrqc,bckh->bkrqh", p, v[:, sl].to(f32))
        m = m_new
    return m, l, acc


def _normalised(l, acc, dtype):
    """[B,Sq,H,hd] in ``dtype`` from an online-softmax state."""
    b, kv, rep, sq, hd = acc.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * rep, hd).to(dtype)


def _attend_chunked(q, k, v, q_rank, k_rank, causal, window, scale, cap,
                    chunk: int = 1024, k_valid=None):
    """Online softmax over KV chunks (``_attend_partial``), normalised."""
    _, l, acc = _attend_partial(q, k, v, q_rank, k_rank, causal, window,
                                scale, cap, chunk, k_valid)
    return _normalised(l, acc, q.dtype)


def _kv_for_heads(k, v, k0: int, h0: int, h_loc: int, rep: int):
    """Keys and values for q heads [h0, h0 + h_loc), from k/v holding kv
    heads [k0, ...): a contiguous run of kv heads when the q heads cover
    whole groups (or lie in one group), else one kv head per q head."""
    if h0 % rep == 0 and h_loc % rep == 0:
        a, n = h0 // rep - k0, h_loc // rep
    elif rep % h_loc == 0 and h0 % h_loc == 0:
        a, n = h0 // rep - k0, 1
    else:
        idx = torch.arange(h0, h0 + h_loc, device=k.device) // rep - k0
        return k[:, :, idx], v[:, :, idx]
    if a == 0 and n == k.shape[2]:
        return k, v
    return k[:, :, a:a + n], v[:, :, a:a + n]


def _attend_split(tp: TP, q, k, v, q_rank, k_rank, k_valid, causal, window,
                  scale, cap):
    """Split-sequence attention: each model shard holds a block of the
    keys; every rank attends all heads of ``q`` over its block, and the
    partial (max, sum of exponentials, weighted values) of all blocks are
    merged by log-sum-exp.  Returns [B,Sq,H,hd] in q's dtype."""
    chunk = k.shape[1] if q.shape[1] == 1 else 1024
    m, l, acc = _attend_partial(q, k, v, q_rank, k_rank, causal, window,
                                scale, cap, chunk, k_valid)
    m, l, acc = (tp.gather(t[None], 0) for t in (m, l, acc))
    top = m.amax(0)
    w = torch.exp(m - top)                          # [m, B,KV,rep,Sq]
    return _normalised((l * w).sum(0), (acc * w[..., None]).sum(0),
                       q.dtype)


def attention(p: dict, x: torch.Tensor, cfg, spec, positions,
              *, causal: bool = True, cache: Optional[dict] = None,
              cache_index=None, kv_source: Optional[torch.Tensor] = None,
              tp: TP = NO_TP):
    """Attention sublayer (projections + rope + attend + out-proj).

    Self-attention: cache {"k", "v"} [B, S_max, KV, hd] for prefill and
    decode.  The new keys and values are written into it in place at
    ``cache_index`` (clamped so the write fits, as
    ``lax.dynamic_update_slice`` clamps), and the attention reads the whole
    cache with the unwritten tail masked.

    Cross-attention: keys and values from ``kv_source`` (encoder states
    [B, S_enc, d]), written in place into ``cache`` {"xk", "xv"} when one
    is given (prefill); or, without ``kv_source``, read from that cache
    (decode).  No RoPE, every key visible.  Returns out [B, S, d].

    On a mesh (``tp``): ``wq`` is column-parallel by heads, ``wk``/``wv``
    replicated, ``wo`` row-parallel with a sum over ``model``; a rank's q
    heads [r H/m, (r+1) H/m) read kv head j // (H/KV).  (Trap 1 of
    training on a mesh: ``wk``/``wv`` are replicated over ``model`` but a
    rank uses only the kv heads its q heads read, so each rank's gradient
    of them is partial.  The train step sums every leaf replicated over
    ``model`` over it, which is right for all of them here: a rank
    differentiates its share of the loss, so even a norm scale used
    before the split gets a partial gradient, ``launch/mesh.py``.)  A column block
    that splits a head is gathered first.  The cache is the rank's block:
    split by kv heads (local attention), whole, or, with
    ``tp.seq_split``, by sequence.  Then a prefill from position 0 writes
    the rank's block of positions and attends its heads over the prompt;
    any other call (decode) writes the new keys into the block that holds
    them, gathers the q heads and merges every block's partial attention
    (``_attend_split``).
    """
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    b, s, _ = x.shape
    scale = hd ** -0.5
    rep = h // kvh

    if p["wq"].shape[1] < h * hd and h % tp.m:      # a block splits a head
        p = dict(p, wq=tp.full(p["wq"], 1, h * hd),
                 wo=tp.full(p["wo"], 0, h * hd))
        if "bq" in p:
            p["bq"] = tp.full(p["bq"], 0, h * hd)
    h_loc = p["wq"].shape[1] // hd                  # this rank's q heads
    h0 = tp.offset(h_loc, h)

    q = _split_heads(x @ p["wq"], h_loc, hd)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, h_loc, hd)
    cross = kv_source is not None or (cache is not None and "xk" in cache)
    if cross and kv_source is None:
        k, v = cache["xk"], cache["xv"]
    else:
        src = kv_source if cross else x
        k = _split_heads(src @ p["wk"], kvh, hd)
        v = _split_heads(src @ p["wv"], kvh, hd)
        if "bk" in p:
            k = k + p["bk"].reshape(1, 1, kvh, hd)
            v = v + p["bv"].reshape(1, 1, kvh, hd)
        if not cross and cfg.pos in ("rope", "mrope"):
            q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    dev = x.device
    k0 = 0                                # first kv head that k/v hold
    split = False
    n_keys = None                 # the keys the algorithm is chosen for
    if cross and cache is not None and kv_source is not None:
        kv_loc = cache["xk"].shape[2]
        c0 = tp.offset(kv_loc, kvh)
        if tuple(cache["xk"].shape) != (b, k.shape[1], kv_loc, hd):
            raise ValueError(f"encoder keys {tuple(k.shape)} do not fit a "
                             f"cross cache of {tuple(cache['xk'].shape)}")
        cache["xk"].copy_(k[:, :, c0:c0 + kv_loc])
        cache["xv"].copy_(v[:, :, c0:c0 + kv_loc])
    elif cross and cache is not None:
        k0 = tp.offset(k.shape[2], kvh)
    elif cache is not None:
        s_loc, kv_loc = cache["k"].shape[1], cache["k"].shape[2]
        s_max = s_loc * tp.m if tp.seq_split else s_loc
        if s > s_max:
            raise ValueError(f"{s} tokens do not fit a cache of {s_max}")
        ci = int(cache_index)
        at = min(max(ci, 0), s_max - s)
        p0 = tp.r * s_loc if tp.seq_split else 0    # the block's position
        lo, hi = max(at, p0), min(at + s, p0 + s_loc)
        kc0 = tp.offset(kv_loc, kvh)
        if lo < hi:
            cache["k"][:, lo - p0:hi - p0] = k[:, lo - at:hi - at,
                                               kc0:kc0 + kv_loc].to(
                cache["k"].dtype)
            cache["v"][:, lo - p0:hi - p0] = v[:, lo - at:hi - at,
                                               kc0:kc0 + kv_loc].to(
                cache["v"].dtype)
        if not tp.seq_split:
            k, v, k0 = cache["k"], cache["v"], kc0
        elif s > 1 and ci == 0:
            # a prefill from position 0: the prompt is every key there is;
            # the same algorithm as over the whole cache (its tail masked)
            cache, n_keys = None, s_max
        else:
            k, v, split = cache["k"], cache["v"], True

    # ---- batch-free sequence-rank masks ----
    sk = k.shape[1]
    k_rank = torch.arange(sk, dtype=torch.int32, device=dev)[None]
    k_valid, window = None, spec.window
    if cross:
        q_rank = torch.zeros((1, s), dtype=torch.int32, device=dev)
        causal, window = False, None
    elif cache is not None:
        q_rank = (ci + torch.arange(s, dtype=torch.int32, device=dev))[None]
        k_rank = k_rank + p0
        k_valid = k_rank <= ci + s - 1
    else:
        q_rank = torch.arange(s, dtype=torch.int32, device=dev)[None]

    if split:
        qa = tp.gather(q, 2) if h_loc < h else q
        out = _attend_split(tp, qa, k, v, q_rank, k_rank, k_valid, causal,
                            window, scale, cfg.attn_softcap)[:, :,
                                                             h0:h0 + h_loc]
    else:
        k, v = _kv_for_heads(k, v, k0, h0, h_loc, rep)
        if (n_keys or sk) > cfg.attn_chunk_threshold and s > 1:
            out = _attend_chunked(q, k, v, q_rank, k_rank, causal, window,
                                  scale, cfg.attn_softcap, k_valid=k_valid)
        else:
            bias = _mask_bias(q_rank, k_rank, causal, window, k_valid)
            out = _attend_dense(q, k, v, bias, scale, cfg.attn_softcap,
                                scores_f32=cfg.attn_scores_f32)

    out = out.reshape(b, s, h_loc * hd) @ p["wo"]
    return tp.reduce(out, h_loc < h)
