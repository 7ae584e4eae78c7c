"""Model assembly: parameter and cache templates, the model module and its
forward pass (PyTorch counterpart of ``repro.models.transformer``).

  * ``param_template`` declares each parameter's shape, logical axes and
    init kind; ``init_params`` realises it on a device from a
    ``torch.Generator``, and ``params_from_reference`` loads the JAX
    package's ``init_params`` tree into the same layout.
  * layers are grouped by the smallest repeating pattern period and
    parameters are stacked over groups ([groups, ...]); the forward pass
    is a Python loop over groups and sub-layers.
  * caches (attention KV, Mamba ssm+conv, RWKV wkv+shifts, the whisper
    decoder's cross KV) are dicts of tensors stacked the same way, and are
    updated in place.

Modes: "train" (full causal, no cache; each sub-layer under
``torch.utils.checkpoint``, the JAX package's remat), "prefill" (fills a
cache from position 0), "decode" (tokens or embeddings against a cache at
``cache_index``).

Every family of the JAX package is served and trained: dense, MoE (with
the shared expert), Mamba hybrids with their experts, RWKV6, the whisper
encoder-decoder and ``input_mode="embeds"`` backbones.  ``loss_fn`` is the
causal LM loss the train step (``launch/steps.py::build_train_step``)
differentiates; the parameters are frozen until ``requires_grad_(True)``,
which the train step sets.  Sharding (``param_pspecs``, ``cache_pspecs``)
waits for ROADMAP A11b.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.otcd import resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import norm, softcap
from repro_torch.models.mlp import mlp, rwkv_channel_mix
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rwkv import rwkv_time_mix
from repro_torch.models.ssm import mamba_mix


class P(NamedTuple):
    """Parameter leaf spec: shape, logical axes (one per dim), init kind."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"


# --------------------------------------------------------------------- specs
def _norm_t(cfg) -> Dict[str, P]:
    t = {"scale": P((cfg.d_model,), (None,), "zeros")}
    if cfg.norm == "layernorm":
        t["scale"] = P((cfg.d_model,), (None,), "ones")
        t["bias"] = P((cfg.d_model,), (None,), "zeros")
    return t


def _attn_t(cfg, cross: bool = False) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": P((d, h * hd), ("embed", "qdim")),
        "wk": P((d, kv * hd), ("embed", "kvdim")),
        "wv": P((d, kv * hd), ("embed", "kvdim")),
        "wo": P((h * hd, d), ("qdim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = P((h * hd,), ("qdim",), "zeros")
        t["bk"] = P((kv * hd,), ("kvdim",), "zeros")
        t["bv"] = P((kv * hd,), ("kvdim",), "zeros")
    return t


def _mlp_t(cfg) -> Dict[str, P]:
    d, f = cfg.d_model, cfg.d_ff
    t = {"wu": P((d, f), ("embed", "ff")),
         "wd": P((f, d), ("ff", "embed"))}
    if cfg.glu:
        t["wg"] = P((d, f), ("embed", "ff"))
    return t


def _moe_t(cfg) -> Dict[str, Any]:
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert, m.num_experts
    experts = {"wu": P((e, d, fe), ("experts", "embed", "eff")),
               "wd": P((e, fe, d), ("experts", "eff", "embed"))}
    if cfg.glu:
        experts["wg"] = P((e, d, fe), ("experts", "embed", "eff"))
    t: Dict[str, Any] = {"router": P((d, e), (None, None)),
                         "experts": experts}
    if m.shared_expert:
        t["shared"] = _mlp_t(cfg)
    return t


def _mamba_t(cfg) -> Dict[str, P]:
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    ds = m.d_state
    dtr = max(1, di // 16)
    return {
        "in_proj": P((d, 2 * di), ("embed", "mamba2x")),
        "conv_w": P((m.d_conv, di), (None, "mamba")),
        "conv_b": P((di,), ("mamba",), "zeros"),
        "x_dbc": P((di, dtr + 2 * ds), ("mamba", None)),
        "dt_proj": P((dtr, di), (None, "mamba")),
        "dt_bias": P((di,), ("mamba",), "dtbias"),
        "A_log": P((di, ds), ("mamba", None), "alog"),
        "D": P((di,), ("mamba",), "ones"),
        "out_proj": P((di, d), ("mamba", "embed")),
    }


def _rwkv_t(cfg) -> Dict[str, P]:
    r = cfg.rwkv
    d = cfg.d_model
    h = d // r.head_dim
    return {
        "mu_x": P((d,), (None,), "zeros"),
        "mu": P((5, d), (None, None), "zeros"),
        "mix_a": P((d, 5 * r.mix_lora), ("embed", None), "small"),
        "mix_b": P((5, r.mix_lora, d), (None, None, "qdim"), "small"),
        "wr": P((d, d), ("embed", "qdim")),
        "wk": P((d, d), ("embed", "qdim")),
        "wv": P((d, d), ("embed", "qdim")),
        "wg": P((d, d), ("embed", "qdim")),
        "wo": P((d, d), ("qdim", "embed")),
        "w0": P((d,), ("qdim",), "zeros"),
        "dec_a": P((d, r.decay_lora), ("embed", None), "small"),
        "dec_b": P((r.decay_lora, d), (None, "qdim"), "small"),
        "u": P((h, r.head_dim), ("heads", None), "small"),
        "ln_x": P((d,), ("qdim",), "ones"),
    }


_MIXER_T = {"attn": _attn_t, "mamba": _mamba_t, "rwkv": _rwkv_t}


def _sublayer_t(cfg, spec: LayerSpec, cross: bool) -> Dict[str, Any]:
    t: Dict[str, Any] = {"ln1": _norm_t(cfg),
                         "mixer": _MIXER_T[spec.mixer](cfg)}
    if cross:
        t["xln"] = _norm_t(cfg)
        t["xattn"] = _attn_t(cfg, cross=True)
    t["ln2"] = _norm_t(cfg)
    if spec.mixer == "rwkv":
        d, f = cfg.d_model, cfg.d_ff
        t["mlp"] = {"mu_k": P((d,), (None,), "zeros"),
                    "mu_r": P((d,), (None,), "zeros"),
                    "wu": P((d, f), ("embed", "ff")),
                    "wr": P((d, d), ("embed", "qdim")),
                    "wd": P((f, d), ("ff", "embed"))}
    elif spec.mlp == "moe":
        t["mlp"] = _moe_t(cfg)
    else:
        t["mlp"] = _mlp_t(cfg)
    if cfg.post_norms:
        t["pn1"] = _norm_t(cfg)
        t["pn2"] = _norm_t(cfg)
    return t


def _map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _groups(cfg) -> Tuple[int, list]:
    period = cfg.scan_period()
    return cfg.n_layers // period, cfg.layer_specs()[:period]


def _stacked(n: int, tree: Dict[str, Any]) -> Dict[str, Any]:
    return _map(lambda p: P((n,) + p.shape, (None,) + p.axes, p.init), tree)


ENC_SPEC = LayerSpec(mixer="attn", mlp="dense")


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    t: Dict[str, Any] = {}
    if cfg.input_mode == "tokens" or cfg.encoder_layers:
        t["embed"] = {"tok": P((cfg.padded_vocab, d), ("vocab", "embed"),
                               "embed")}
    if cfg.pos == "learned":
        t.setdefault("embed", {})["pos"] = P((cfg.max_seq, d),
                                             ("seq", "qdim"), "embed")
    groups, specs = _groups(cfg)
    cross = cfg.encoder_layers > 0
    t["dec"] = {f"sub{i}": _stacked(groups, _sublayer_t(cfg, spec, cross))
                for i, spec in enumerate(specs)}
    if cfg.encoder_layers:
        t["enc"] = {"sub0": _stacked(cfg.encoder_layers,
                                     _sublayer_t(cfg, ENC_SPEC, False))}
        t["enc_norm"] = _norm_t(cfg)
    t["final_norm"] = _norm_t(cfg)
    if not cfg.tie_embeddings:
        t["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    return t


# ----------------------------------------------------------------- realize
def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters with the JAX package's init kinds and scales.
    ``generator`` must live on ``device``; the numbers differ from JAX's
    (tests load JAX's weights with ``params_from_reference`` instead)."""
    dt = _dtype(cfg)

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        if p.init == "alog":
            a = torch.arange(1, p.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(a).expand(p.shape).to(dt).contiguous()
        if p.init == "dtbias":
            return torch.full(p.shape, math.log(math.e - 1), dtype=dt,
                              device=device)
        scale = 0.006 if p.init == "small" else 0.02
        if p.init == "embed":
            scale = 1.0 / math.sqrt(cfg.d_model)
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)

    return _map(make, param_template(cfg))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: a dict becomes a child
    ``ParamTree``, a tensor an ``nn.Parameter`` (frozen until
    ``requires_grad_(True)``); ``tree[key]`` reads either, ``select(i)``
    gives the plain nested dict of the leaves' views ``leaf[i]`` (one
    layer group) and ``tree()`` the nested dict of the parameters
    themselves (what the optimizers and checkpoints walk)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def select(self, index) -> Dict[str, Any]:
        out = {k: m.select(index) for k, m in self._modules.items()}
        out.update({k: p[index] for k, p in self._parameters.items()})
        return out

    def tree(self) -> Dict[str, Any]:
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


class Transformer(nn.Module):
    """The decoder of one ``ModelConfig``: parameters as a ``ParamTree``
    (``self.params``, laid out as ``param_template``) and the forward
    pass.  ``device=None`` is CUDA, and raises where there is none; the
    parameters are ``params`` (a nested dict of tensors, as
    ``init_params`` returns) or drawn from ``generator`` (default: seed 0
    on the device)."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "Transformer")
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, self.device)
        self.params = ParamTree(_map(lambda t: t.to(self.device), params))

    def forward(self, batch: dict, mode: str = "train",
                cache: Optional[dict] = None):
        """batch: {"tokens" [B,S] int, or "embeds" [B,S,d] for an
        ``input_mode="embeds"`` model; optional "enc_embeds" [B,S_enc,d]
        (the encoder's input), "positions" [B,S] (or [3,B,S] for M-RoPE),
        "cache_index" (decode)}.  Returns (hidden [B,S,d], aux, cache):
        aux is the MoE load-balancing loss summed over layers (f32
        scalar); the cache given, updated in place, or None without one.
        ``mode`` names the JAX mode: "decode" reads the cross KV from the
        cache; "train" recomputes each sub-layer in the backward pass,
        which changes no number; otherwise the cache alone decides."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg, params = self.cfg, self.params
        groups, specs = _groups(cfg)
        remat = mode == "train"
        enc_out = None
        if cfg.encoder_layers and "enc_embeds" in batch:
            enc_out = run_encoder(cfg, params, batch["enc_embeds"],
                                  remat=remat)
        if cfg.input_mode == "embeds" and "embeds" in batch:
            b, s = batch["embeds"].shape[:2]
            dev = batch["embeds"].device
        else:
            b, s = batch["tokens"].shape
            dev = batch["tokens"].device
        positions = _positions(batch, s, b, dev)
        x = _embed_in(cfg, params, batch, positions)
        cache_index = None
        if cache is not None:
            cache_index = batch.get("cache_index", 0)
        x, aux = _stack_forward(
            cfg, params["dec"], x, positions, groups=groups, specs=specs,
            causal=True, cache=cache, cache_index=cache_index,
            enc_out=enc_out, decode=(mode == "decode"), remat=remat)
        x = norm(x, params["final_norm"], cfg.norm)
        return x, aux, cache

    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg, params = self.cfg, self.params
        if cfg.tie_embeddings:
            w = params["embed"]["tok"].T
        else:
            w = params["lm_head"]
        logits = hidden @ w.to(hidden.dtype)
        logits = softcap(logits, cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:  # mask the TP-padding columns
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits


def loss_fn(model: Transformer, batch: dict):
    """Causal LM loss of ``model`` on ``batch`` (its forward's inputs plus
    "labels" [B, S]; labels < 0 are masked): the mean token NLL from an
    f32 logsumexp, plus 0.01 x the MoE load-balancing aux.  Returns (loss,
    {"nll", "aux", "tokens"}), f32 scalars, as ``repro.models.transformer
    .loss_fn``."""
    hidden, aux, _ = model(batch, mode="train")
    logits = model.logits_from_hidden(hidden).to(torch.float32)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).to(torch.int64)
                        [..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom + 0.01 * aux
    return loss, {"nll": nll.sum() / denom, "aux": aux,
                  "tokens": mask.sum()}


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None) -> Transformer:
    """A model holding the JAX package's parameters: ``tree`` is the JAX
    ``init_params`` tree as numpy arrays, groups stacked as [groups, ...].
    Every leaf of the template must be there, with its shape."""
    tmpl = param_template(cfg)

    def load(t, ref, path):
        if set(t) != set(ref):
            raise ValueError(f"{path or 'params'}: keys {sorted(ref)} != "
                             f"template {sorted(t)}")
        out = {}
        for k, p in t.items():
            if isinstance(p, dict):
                out[k] = load(p, ref[k], f"{path}/{k}")
                continue
            arr = np.array(ref[k])                   # a writable copy
            if arr.dtype.name == "bfloat16":   # ml_dtypes, as JAX gives it
                a = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                a = torch.from_numpy(arr)
            if tuple(a.shape) != p.shape:
                raise ValueError(f"{path}/{k}: shape {tuple(a.shape)} != "
                                 f"template {p.shape}")
            out[k] = a.to(_dtype(cfg))
        return out

    return Transformer(cfg, load(tmpl, tree, ""), device=device)


# -------------------------------------------------------------------- cache
def cache_template(cfg: ModelConfig, batch: int, s_max: int,
                   s_enc: Optional[int] = None) -> Dict[str, Any]:
    """Shape/axes template for decode caches (same P-leaf formalism);
    ``s_enc`` (encoder-decoder models) sizes the cross KV."""
    groups, specs = _groups(cfg)
    hd = cfg.resolved_head_dim
    kv = cfg.n_kv_heads
    d = cfg.d_model
    t: Dict[str, Any] = {}
    for i, spec in enumerate(specs):
        sub: Dict[str, P] = {}
        if spec.mixer == "attn":
            sub["k"] = sub["v"] = P(
                (groups, batch, s_max, kv, hd),
                (None, "batch", "cache_seq", "kvheads", None))
        elif spec.mixer == "mamba":
            m = cfg.mamba
            di = m.d_inner(d)
            sub["ssm"] = P((groups, batch, di, m.d_state),
                           (None, "batch", "mamba", None))
            sub["conv"] = P((groups, batch, m.d_conv - 1, di),
                            (None, "batch", None, "mamba"))
        elif spec.mixer == "rwkv":
            r = cfg.rwkv
            sub["wkv"] = P((groups, batch, d // r.head_dim, r.head_dim,
                            r.head_dim), (None, "batch", "heads", None, None))
            sub["shift_att"] = sub["shift_ffn"] = P(
                (groups, batch, d), (None, "batch", None))
        if cfg.encoder_layers and s_enc:
            sub["xk"] = sub["xv"] = P(
                (groups, batch, s_enc, kv, hd),
                (None, "batch", None, "kvheads", None))
        t[f"sub{i}"] = sub
    return t


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None, *,
               s_enc: Optional[int] = None) -> Dict[str, Any]:
    """A zeroed decode cache in the config's dtype; CUDA by default.  An
    encoder-decoder model needs ``s_enc`` (the encoder length) to decode."""
    dev = resolve_device(device, "init_cache")
    return _map(lambda p: torch.zeros(p.shape, dtype=_dtype(cfg),
                                      device=dev),
                cache_template(cfg, batch, s_max, s_enc))


# ------------------------------------------------------------------ forward
def _zero_state(cfg, spec: LayerSpec, x):
    """The mixer's state when there is no cache (train): zeros, the
    recurrent state in float32 as the JAX package starts it."""
    b, dev = x.shape[0], x.device
    if spec.mixer == "mamba":
        m = cfg.mamba
        di = m.d_inner(cfg.d_model)
        return (torch.zeros((b, di, m.d_state), dtype=torch.float32,
                            device=dev),
                torch.zeros((b, m.d_conv - 1, di), dtype=x.dtype,
                            device=dev))
    hd = cfg.rwkv.head_dim
    return (torch.zeros((b, cfg.d_model // hd, hd, hd), dtype=torch.float32,
                        device=dev),
            torch.zeros((b, cfg.d_model), dtype=x.dtype, device=dev))


def _run_sublayer(cfg, spec: LayerSpec, p, x, positions, *, causal, cache,
                  cache_index, enc_out, decode):
    """One decoder (or encoder) layer.  ``cache`` (this layer's views into
    the stacked cache, or None) is updated in place; a recurrent state is
    stored in the cache's dtype, as the JAX package casts it.  Returns
    (x, aux of this layer's MoE or None)."""
    h = norm(x, p["ln1"], cfg.norm)
    if spec.mixer == "attn":
        kv = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        out = attention(p["mixer"], h, cfg, spec, positions, causal=causal,
                        cache=kv, cache_index=cache_index)
    else:
        names = (("ssm", "conv") if spec.mixer == "mamba"
                 else ("wkv", "shift_att"))
        state = (_zero_state(cfg, spec, x) if cache is None
                 else tuple(cache[n] for n in names))
        if spec.mixer == "mamba":
            out, new = mamba_mix(p["mixer"], h, cfg, state)
        else:   # one token: the exact step, equal to a padded 64-chunk
            out, new = rwkv_time_mix(p["mixer"], h, cfg, state,
                                     chunk=1 if h.shape[1] == 1 else 64)
        if cache is not None:
            cache[names[0]].copy_(new[0].to(x.dtype))
            cache[names[1]].copy_(new[1])
    if cfg.post_norms:
        out = norm(out, p["pn1"], cfg.norm)
    x = x + out

    if "xattn" in p and (enc_out is not None or decode):
        hx = norm(x, p["xln"], cfg.norm)
        # decode reads the cross KV cached at prefill; prefill computes it
        # (and writes it into the cache when there is one)
        xc = None
        if cache is not None and "xk" in cache:
            xc = {"xk": cache["xk"], "xv": cache["xv"]}
        if enc_out is None and xc is None:
            raise ValueError("decoding an encoder-decoder model needs the "
                             "cross KV: init_cache(..., s_enc=)")
        out = attention(p["xattn"], hx, cfg, spec, positions, causal=False,
                        cache=xc,
                        kv_source=None if decode and xc else enc_out)
        x = x + out

    h2 = norm(x, p["ln2"], cfg.norm)
    aux = None
    if spec.mixer == "rwkv":
        shift = (cache["shift_ffn"] if cache is not None else
                 torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                             device=x.device))
        out, sh2 = rwkv_channel_mix(p["mlp"], h2, shift, cfg)
        if cache is not None:
            cache["shift_ffn"].copy_(sh2)
    elif spec.mlp == "moe":
        out, aux = moe_ffn(p["mlp"], h2, cfg)
    else:
        out = mlp(p["mlp"], h2, cfg)
    if cfg.post_norms:
        out = norm(out, p["pn2"], cfg.norm)
    return x + out, aux


def _stack_forward(cfg, stack_params: ParamTree, x, positions, *, groups,
                   specs, causal, cache=None, cache_index=None,
                   enc_out=None, decode=False, remat=False):
    """Loop over layer groups and their sub-layers; ``cache`` (stacked
    over groups) is updated in place.  ``remat`` runs each sub-layer under
    ``torch.utils.checkpoint``: only its input is kept for the backward
    pass, which runs it again.  (The JAX package remats each layer group;
    one sub-layer at a time is what lets a full-width Mamba layer, whose
    scan keeps several [B, S, d_inner * d_state] float32 tensors, train on
    one card.)  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(groups):
        gp = stack_params.select(g)
        for i, spec in enumerate(specs):
            sub_c = None
            if cache is not None:
                sub_c = {k: t[g] for k, t in cache[f"sub{i}"].items()}
            kw = dict(causal=causal, cache=sub_c, cache_index=cache_index,
                      enc_out=enc_out, decode=decode)
            if remat:
                x, a = checkpoint(_run_sublayer, cfg, spec, gp[f"sub{i}"],
                                  x, positions, use_reentrant=False, **kw)
            else:
                x, a = _run_sublayer(cfg, spec, gp[f"sub{i}"], x, positions,
                                     **kw)
            if a is not None:
                aux = aux + a
    return x, aux


def run_encoder(cfg, params, enc_embeds, *, remat: bool = False):
    """The bidirectional encoder stack over ``enc_embeds`` [B,S_enc,d],
    then ``enc_norm`` (no positional term, as in the JAX package)."""
    b, s, _ = enc_embeds.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=enc_embeds.device)[None].expand(b, s)
    x, _ = _stack_forward(cfg, params["enc"], enc_embeds.to(_dtype(cfg)),
                          pos, groups=cfg.encoder_layers, specs=[ENC_SPEC],
                          causal=False, remat=remat)
    return norm(x, params["enc_norm"], cfg.norm)


def _embed_in(cfg, params, batch, positions):
    if cfg.input_mode == "embeds" and "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = params["embed"]["tok"][batch["tokens"]]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.pos == "learned":
        pos = positions if positions.dim() == 2 else positions[0]
        x = x + params["embed"]["pos"][pos]
    return x


def _positions(batch, s, b, device):
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)
