"""Model assembly: parameter and cache templates, the model module and its
forward pass (PyTorch counterpart of ``repro.models.transformer``).

  * ``param_template`` declares each parameter's shape, logical axes and
    init kind; ``init_params`` realises it on a device from a
    ``torch.Generator``, and ``params_from_reference`` loads the JAX
    package's ``init_params`` tree into the same layout.
  * layers are grouped by the smallest repeating pattern period and
    parameters are stacked over groups ([groups, ...]); the forward pass
    is a Python loop over groups and sub-layers.
  * caches (attention KV, Mamba ssm+conv) are dicts of tensors stacked the
    same way, and are updated in place.

Modes: "train" (full causal, no cache), "prefill" (fills a cache from
position 0), "decode" (tokens against a cache at ``cache_index``).

This slice serves dense and Mamba-hybrid decoders (Jamba without
experts).  The other families raise ``NotImplementedError`` naming the
ROADMAP item that will port them; none is computed differently.  Sharding
(``param_pspecs``, ``cache_pspecs``) and training (``loss_fn``) are not
ported yet (ROADMAP A11, A12).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.otcd import resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import norm, softcap
from repro_torch.models.mlp import mlp
from repro_torch.models.ssm import mamba_mix


class P(NamedTuple):
    """Parameter leaf spec: shape, logical axes (one per dim), init kind."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family this slice of the port does not serve."""
    for present, what in ((cfg.moe is not None, "MoE FFN (models/moe.py)"),
                          (cfg.rwkv is not None, "RWKV (models/rwkv.py)"),
                          (cfg.encoder_layers > 0,
                           "encoder-decoder (whisper)"),
                          (cfg.input_mode == "embeds",
                           "input_mode='embeds' (VLM/audio)")):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: the {what} is not ported yet (ROADMAP A12)")


# --------------------------------------------------------------------- specs
def _norm_t(cfg) -> Dict[str, P]:
    t = {"scale": P((cfg.d_model,), (None,), "zeros")}
    if cfg.norm == "layernorm":
        t["scale"] = P((cfg.d_model,), (None,), "ones")
        t["bias"] = P((cfg.d_model,), (None,), "zeros")
    return t


def _attn_t(cfg) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": P((d, h * hd), ("embed", "qdim")),
        "wk": P((d, kv * hd), ("embed", "kvdim")),
        "wv": P((d, kv * hd), ("embed", "kvdim")),
        "wo": P((h * hd, d), ("qdim", "embed")),
    }
    if cfg.qkv_bias:
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


def _sublayer_t(cfg, spec: LayerSpec) -> Dict[str, Any]:
    t: Dict[str, Any] = {"ln1": _norm_t(cfg)}
    t["mixer"] = _attn_t(cfg) if spec.mixer == "attn" else _mamba_t(cfg)
    t["ln2"] = _norm_t(cfg)
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


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d = cfg.d_model
    t: Dict[str, Any] = {"embed": {"tok": P((cfg.padded_vocab, d),
                                            ("vocab", "embed"), "embed")}}
    if cfg.pos == "learned":
        t["embed"]["pos"] = P((cfg.max_seq, d), ("seq", "qdim"), "embed")
    groups, specs = _groups(cfg)
    t["dec"] = {f"sub{i}": _map(
        lambda p: P((groups,) + p.shape, (None,) + p.axes, p.init),
        _sublayer_t(cfg, spec)) for i, spec in enumerate(specs)}
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
        scale = 1.0 / math.sqrt(cfg.d_model) if p.init == "embed" else 0.02
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)

    return _map(make, param_template(cfg))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: a dict becomes a child
    ``ParamTree``, a tensor a frozen ``nn.Parameter``; ``tree[key]`` reads
    either, and ``select(i)`` gives the plain nested dict of the leaves'
    views ``leaf[i]`` (one layer group)."""

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
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device, "Transformer")
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, self.device)
        self.params = ParamTree(_map(lambda t: t.to(self.device), params))

    def forward(self, batch: dict, mode: str = "train",
                cache: Optional[dict] = None):
        """batch: {"tokens" [B,S] int, optional "positions" [B,S] (or
        [3,B,S] for M-RoPE), "cache_index" (decode)}.  Returns (hidden
        [B,S,d], aux, cache): aux is 0 (no MoE in this slice); the cache
        given, updated in place, or None without one.  ``mode`` names the
        JAX mode; here the cache alone decides (no remat, no cross
        attention in this slice)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg, params = self.cfg, self.params
        groups, specs = _groups(cfg)
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = _positions(batch, s, b, tokens.device)
        x = _embed_in(cfg, params, tokens, positions)
        cache_index = None
        if cache is not None:
            cache_index = batch.get("cache_index", 0)
        x, aux = _stack_forward(
            cfg, params["dec"], x, positions, groups=groups, specs=specs,
            cache=cache, cache_index=cache_index)
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
            a = torch.from_numpy(np.array(ref[k]))   # a writable copy
            if tuple(a.shape) != p.shape:
                raise ValueError(f"{path}/{k}: shape {tuple(a.shape)} != "
                                 f"template {p.shape}")
            out[k] = a.to(_dtype(cfg))
        return out

    return Transformer(cfg, load(tmpl, tree, ""), device=device)


# -------------------------------------------------------------------- cache
def cache_template(cfg: ModelConfig, batch: int,
                   s_max: int) -> Dict[str, Any]:
    """Shape/axes template for decode caches (same P-leaf formalism)."""
    check_supported(cfg)
    groups, specs = _groups(cfg)
    hd = cfg.resolved_head_dim
    kv = cfg.n_kv_heads
    t: Dict[str, Any] = {}
    for i, spec in enumerate(specs):
        if spec.mixer == "attn":
            kvp = P((groups, batch, s_max, kv, hd),
                    (None, "batch", "cache_seq", "kvheads", None))
            t[f"sub{i}"] = {"k": kvp, "v": kvp}
        else:
            m = cfg.mamba
            di = m.d_inner(cfg.d_model)
            t[f"sub{i}"] = {
                "ssm": P((groups, batch, di, m.d_state),
                         (None, "batch", "mamba", None)),
                "conv": P((groups, batch, m.d_conv - 1, di),
                          (None, "batch", None, "mamba"))}
    return t


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device=None) -> Dict[str, Any]:
    """A zeroed decode cache in the config's dtype; CUDA by default."""
    dev = resolve_device(device, "init_cache")
    return _map(lambda p: torch.zeros(p.shape, dtype=_dtype(cfg),
                                      device=dev),
                cache_template(cfg, batch, s_max))


# ------------------------------------------------------------------ forward
def _run_sublayer(cfg, spec: LayerSpec, p, x, positions, *, cache,
                  cache_index):
    """One decoder layer.  ``cache`` (this layer's views into the stacked
    cache, or None) is updated in place."""
    h = norm(x, p["ln1"], cfg.norm)
    if spec.mixer == "attn":
        out = attention(p["mixer"], h, cfg, spec, positions, cache=cache,
                        cache_index=cache_index)
    else:
        if cache is not None:
            state = (cache["ssm"], cache["conv"])
        else:
            m = cfg.mamba
            di = m.d_inner(cfg.d_model)
            b = x.shape[0]
            state = (torch.zeros((b, di, m.d_state), dtype=torch.float32,
                                 device=x.device),
                     torch.zeros((b, m.d_conv - 1, di), dtype=x.dtype,
                                 device=x.device))
        out, (s1, c1) = mamba_mix(p["mixer"], h, cfg, state)
        if cache is not None:
            cache["ssm"].copy_(s1.to(x.dtype))
            cache["conv"].copy_(c1)
    if cfg.post_norms:
        out = norm(out, p["pn1"], cfg.norm)
    x = x + out

    h2 = norm(x, p["ln2"], cfg.norm)
    out = mlp(p["mlp"], h2, cfg)
    if cfg.post_norms:
        out = norm(out, p["pn2"], cfg.norm)
    return x + out


def _stack_forward(cfg, stack_params: ParamTree, x, positions, *, groups,
                   specs, cache=None, cache_index=None):
    """Loop over layer groups and their sub-layers; ``cache`` (stacked
    over groups) is updated in place.  Returns (x, aux)."""
    for g in range(groups):
        gp = stack_params.select(g)
        for i, spec in enumerate(specs):
            sub_c = None
            if cache is not None:
                sub_c = {k: t[g] for k, t in cache[f"sub{i}"].items()}
            x = _run_sublayer(cfg, spec, gp[f"sub{i}"], x, positions,
                              cache=sub_c, cache_index=cache_index)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _embed_in(cfg, params, tokens, positions):
    x = params["embed"]["tok"][tokens]
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
