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
which the train step sets.

Sharding: ``param_pspecs`` and ``cache_pspecs`` map each leaf's logical
axes to mesh axes by ``SHARDING_RULES``, as the JAX functions do (the
``embed`` rows over ``data``, FSDP; heads, FFN, experts, Mamba channels,
vocabulary and the attention cache's sequence over ``model``).
``Transformer(cfg, ..., mesh=)`` holds only its rank's blocks of them
(``shard_tree``; ``unshard_tree`` gathers the full leaves back) and
serves on them: each sub-layer's ``embed`` dimensions are gathered over
``data`` before use, and the layers compute tensor- and expert-parallel
over ``model`` (``models/sharding.py``).  Its forward takes the rank's
rows of the batch and a cache from ``init_cache(..., mesh=)``; the steps
(``launch/steps.py``) slice the rows and gather the results.  It trains
too: ``loss_fn`` takes the global batch on every rank and differentiates
this rank's share of the global loss through the differentiable
collectives (``launch/mesh.py``); under remat each sub-layer gathers its
``embed`` blocks again in the backward pass.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.otcd import resolve_device
from repro_torch.launch.mesh import _axsize, all_gather, dp_axes
from repro_torch.models.attention import attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import norm, softcap
from repro_torch.models.mlp import mlp, rwkv_channel_mix
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rwkv import rwkv_time_mix
from repro_torch.models.sharding import (NO_TP, TP, block, gather_leaf,
                                         mesh_coords, shard_slices)
from repro_torch.models.ssm import mamba_mix


class P(NamedTuple):
    """Parameter leaf spec: shape, logical axes (one per dim), init kind."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"


# logical axis -> mesh axis (None = replicate).  "embed" rows are the FSDP
# dimension; "model-ish" axes are tensor/expert parallel.
SHARDING_RULES: Dict[Optional[str], Optional[str]] = {
    "embed": "data",
    "vocab": "model",
    "qdim": "model",
    # KV projections stay replicated across TP: GQA ratios (kv=1..8) rarely
    # divide the model axis, and sharding flattened kv*head_dim would split
    # head_dim itself.  They are tiny and still FSDP-sharded on "embed".
    "kvdim": None,
    "heads": "model",
    "ff": "model",
    "eff": None,
    "experts": "model",
    "mamba": "model",
    "mamba2x": "model",
    "seq": None,
    "batch": "data",
    "cache_seq": "model",
    None: None,
}


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


def _map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over two nested dicts of one structure."""
    return {k: _map2(fn, v, other[k]) if isinstance(v, dict)
            else fn(v, other[k]) for k, v in tree.items()}


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


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def param_pspecs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Each parameter leaf's spec on ``mesh`` (anything with
    ``axis_names`` and ``shape``): its logical axes through
    ``SHARDING_RULES``, a dimension sharded only where it splits evenly
    (and is > 1), and no mesh axis used twice in one leaf (a later use is
    dropped), as ``repro.models.transformer.param_pspecs``."""
    sizes = _sizes(mesh)

    def spec(p: P):
        parts = []
        for dim, ax in zip(p.shape, p.axes):
            mesh_ax = SHARDING_RULES.get(ax)
            if mesh_ax is not None and dim % sizes[mesh_ax] == 0 and dim > 1:
                parts.append(mesh_ax)
            else:
                parts.append(None)
        seen, clean = set(), []
        for a in parts:
            if a is not None and a in seen:
                clean.append(None)
            else:
                clean.append(a)
                seen.add(a)
        return tuple(clean)

    return _map(spec, param_template(cfg))


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, s_max: int,
                 s_enc: Optional[int] = None) -> Dict[str, Any]:
    """Each cache leaf's spec, as ``repro.models.transformer.cache_pspecs``:
    the parameter rules plus ``kvheads`` on ``model``, a mesh axis taken
    by the first dimension that can use it."""
    sizes = _sizes(mesh)
    rules = dict(SHARDING_RULES)
    rules["kvheads"] = "model"

    def spec(p: P):
        parts, seen = [], set()
        for dim, ax in zip(p.shape, p.axes):
            mesh_ax = rules.get(ax)
            if (mesh_ax is not None and mesh_ax not in seen
                    and dim % sizes[mesh_ax] == 0 and dim > 1):
                parts.append(mesh_ax)
                seen.add(mesh_ax)
            else:
                parts.append(None)
        return tuple(parts)

    return _map(spec, cache_template(cfg, batch, s_max, s_enc))


def shard_tree(tree: Dict[str, Any], specs: Dict[str, Any], mesh,
               rank: Optional[int] = None) -> Dict[str, Any]:
    """Each leaf's block at ``rank``'s coordinates (default: the mesh's own
    rank), copied out of the full leaf: exactly the block JAX's
    ``NamedSharding(mesh, spec)`` puts on that device."""
    coords = mesh_coords(mesh, rank)
    return _map2(lambda t, sp: block(t, sp, mesh, coords), tree, specs)


def unshard_tree(tree: Dict[str, Any], specs: Dict[str, Any],
                 mesh) -> Dict[str, Any]:
    """The full leaves, gathered from every rank's blocks (every rank gets
    them; for tests and checkpoints)."""
    return _map2(lambda t, sp: gather_leaf(t, sp, mesh), tree, specs)


# ----------------------------------------------------------------- realize
def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, mesh=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's init kinds and scales.
    ``generator`` must live on ``device``; the numbers differ from JAX's
    (tests load JAX's weights with ``params_from_reference`` instead).
    With ``mesh``, each leaf is drawn whole in the same order from the
    same generator and only the rank's block is kept, so the blocks equal
    ``shard_tree`` of the unsharded draw and one full leaf is the most
    that is held beside them."""
    dt = _dtype(cfg)
    coords = mesh_coords(mesh) if mesh is not None else None

    def make(p: P, spec):
        sl = (shard_slices(p.shape, spec, mesh, coords) if mesh is not None
              else tuple(slice(0, n) for n in p.shape))
        shape = tuple(x.stop - x.start for x in sl)
        if p.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if p.init == "alog":
            a = torch.arange(1, p.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(a)[sl[-1]].expand(shape).to(dt).contiguous()
        if p.init == "dtbias":
            return torch.full(shape, math.log(math.e - 1), dtype=dt,
                              device=device)
        scale = 0.006 if p.init == "small" else 0.02
        if p.init == "embed":
            scale = 1.0 / math.sqrt(cfg.d_model)
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        if mesh is None:
            return w.mul_(scale).to(dt)
        out = (w[sl] * scale).to(dt)
        del w
        return out

    tmpl = param_template(cfg)
    specs = (param_pspecs(cfg, mesh) if mesh is not None
             else _map(lambda p: None, tmpl))
    return _map2(make, tmpl, specs)


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
    on the device).

    With ``mesh`` (``launch/mesh.py::Mesh``) the model holds only this
    rank's block of each leaf (``param_pspecs``; ``params`` are the full
    leaves, cut here) on the mesh's device, and serves sharded: the
    forward takes this rank's rows of the batch and a cache from
    ``init_cache(..., mesh=)``; ``logits_from_hidden`` gives its block of
    the vocabulary."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.pspecs = None
        if mesh is None:
            self.device = resolve_device(device, "Transformer")
        else:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"a model on {mesh} computes on "
                                 f"{mesh.device}, not {device}")
            self.device = mesh.device
            self.pspecs = param_pspecs(cfg, mesh)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, self.device, mesh)
        elif mesh is not None:
            params = shard_tree(params, self.pspecs, mesh)
        self.params = ParamTree(_map(lambda t: t.to(self.device), params))

    def _whole(self, tree, specs) -> Dict[str, Any]:
        """A parameter subtree with its ``embed`` dimensions gathered over
        ``data`` (FSDP): each leaf as the layers compute on it, split over
        ``model`` at most.  Off a mesh, the tree itself."""
        if self.mesh is None:
            return tree
        mesh = self.mesh

        def fsdp(t, spec):
            for i, a in enumerate(spec):
                if a == "data":
                    t = all_gather(t, mesh, mesh.data_group, i)
            return t

        return _map2(fsdp, tree, specs)

    def forward(self, batch: dict, mode: str = "train",
                cache: Optional[dict] = None,
                rows: Optional[Tuple[int, int]] = None):
        """batch: {"tokens" [B,S] int, or "embeds" [B,S,d] for an
        ``input_mode="embeds"`` model; optional "enc_embeds" [B,S_enc,d]
        (the encoder's input), "positions" [B,S] (or [3,B,S] for M-RoPE),
        "cache_index" (decode)}.  Returns (hidden [B,S,d], aux, cache):
        aux is the MoE load-balancing loss summed over layers (f32
        scalar); the cache given, updated in place, or None without one.
        ``mode`` names the JAX mode: "decode" reads the cross KV from the
        cache; "train" recomputes each sub-layer in the backward pass,
        which changes no number; otherwise the cache alone decides.  On a
        mesh, B is this rank's rows (``rows_of`` slices them) and the cache
        is ``init_cache(..., mesh=)``'s; to train, ``rows`` is their global
        (start, stop) when they are a block of the batch (then ``aux`` is
        this rank's share of it over the dp axes, see ``models/moe.py``)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        groups, specs = _groups(cfg)
        remat = mode == "train"
        tp, cache_rows = NO_TP, None
        if self.mesh is not None:
            if remat:
                tp = TP(self.mesh, batch_rows=rows)
            else:
                tp, cache_rows = self._layout(batch, cache)
        top = self._top("embed", "final_norm", "enc_norm")
        enc_out = None
        if cfg.encoder_layers and "enc_embeds" in batch:
            enc_out = run_encoder(cfg, self.params, batch["enc_embeds"],
                                  remat=remat, tp=tp,
                                  whole=self._sub_whole("enc"),
                                  enc_norm=top["enc_norm"])
        if cfg.input_mode == "embeds" and "embeds" in batch:
            b, s = batch["embeds"].shape[:2]
            dev = batch["embeds"].device
        else:
            b, s = batch["tokens"].shape
            dev = batch["tokens"].device
        positions = _positions(batch, s, b, dev)
        x = _embed_in(cfg, top, batch, positions, tp)
        cache_index = None
        if cache is not None:
            cache_index = batch.get("cache_index", 0)
        x, aux = _stack_forward(
            cfg, self.params["dec"], x, positions, groups=groups,
            specs=specs, causal=True, cache=cache, cache_index=cache_index,
            enc_out=enc_out, decode=(mode == "decode"), remat=remat, tp=tp,
            whole=self._sub_whole("dec"), rows=cache_rows)
        x = norm(x, top["final_norm"], cfg.norm)
        return x, aux, cache

    def _top(self, *keys) -> Dict[str, Any]:
        """The named top-level parameters (embedding, head, norms) as plain
        dicts, gathered over ``data`` on a mesh."""
        tree = {k: self.params[k].tree() if isinstance(self.params[k],
                                                       ParamTree)
                else self.params[k] for k in keys if k in self.params}
        if self.mesh is None:
            return tree
        return self._whole(tree, {k: self.pspecs[k] for k in tree})

    def _sub_whole(self, stack: str):
        """(group params, i) -> sub-layer i's parameters gathered over
        ``data`` (the group axis of the stacked specs dropped)."""
        if self.mesh is None:
            return lambda gp, i: gp[f"sub{i}"]
        specs = _map(lambda sp: sp[1:], self.pspecs[stack])
        return lambda gp, i: self._whole(gp[f"sub{i}"], specs[f"sub{i}"])

    def rows_of(self, batch: dict) -> Tuple[dict, Optional[Tuple[int, int]]]:
        """(this rank's rows of the global ``batch``, their global (start,
        stop)) on a mesh: a block over the dp axes where the batch is > 1
        and splits evenly over them (the JAX steps' ``_bspec``; M-RoPE
        positions [3, B, S] are cut along B); else every row and None."""
        mesh = self.mesh
        if mesh is None:
            return batch, None
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        b, n = x.shape[0], _axsize(mesh, dp_axes(mesh))
        if b <= 1 or b % n or n == 1:
            return batch, None
        lo, hi = mesh.lane_index * (b // n), (mesh.lane_index + 1) * (b // n)

        def cut(k, t):
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                return t
            if k == "positions" and t.dim() == 3:      # M-RoPE [3, B, S]
                return t[:, lo:hi]
            return t[lo:hi]

        return {k: cut(k, t) for k, t in batch.items()}, (lo, hi)

    def _layout(self, batch: dict, cache) -> Tuple[TP, Optional[tuple]]:
        """The model axis's context for one sharded forward (the cache's
        sequence split or not) and where this rank's rows of the batch
        sit in its cache block: (rows the batch has, rows the cache
        block has) as global (start, stop), and the global batch."""
        mesh = self.mesh
        if not isinstance(cache, ShardedCache):
            raise ValueError("a sharded model serves a cache from "
                             "init_cache(..., mesh=)")
        seq_split = any(sp["k"][2] == "model"
                        for sp in cache.specs.values() if "k" in sp)
        sub = next(iter(cache.specs))
        leaf = next(iter(cache.specs[sub]))
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        b_loc, b_c = x.shape[0], cache[sub][leaf].shape[1]
        a0 = mesh.lane_index * b_loc if b_loc < cache.batch else 0
        c0 = (mesh.coords["data"] * b_c
              if cache.specs[sub][leaf][1] == "data" else 0)
        rows = ((a0, a0 + b_loc), (c0, c0 + b_c), cache.batch)
        return TP(mesh, seq_split, rows[0] if b_loc < cache.batch
                  else None), rows

    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits [..., padded_vocab] (on a mesh, this rank's block of the
        vocabulary; ``vocab_offset`` says where it starts), the padding
        columns masked."""
        cfg = self.cfg
        top = self._top("embed", "lm_head")
        if cfg.tie_embeddings:
            w = top["embed"]["tok"].T
        else:
            w = top["lm_head"]
        logits = hidden @ w.to(hidden.dtype)
        logits = softcap(logits, cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab:  # mask the TP-padding columns
            v0 = self.vocab_offset(logits.shape[-1])
            pad = torch.arange(v0, v0 + logits.shape[-1],
                               device=logits.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def vocab_offset(self, v_loc: int) -> int:
        """The first vocabulary id of this rank's block of ``v_loc``."""
        return TP(self.mesh).offset(v_loc, self.cfg.padded_vocab) \
            if self.mesh is not None else 0


def loss_fn(model: Transformer, batch: dict):
    """Causal LM loss of ``model`` on ``batch`` (its forward's inputs plus
    "labels" [B, S]; labels < 0 are masked): the mean token NLL from an
    f32 logsumexp, plus 0.01 x the MoE load-balancing aux.  Returns (loss,
    {"nll", "aux", "tokens"}), f32 scalars, as ``repro.models.transformer
    .loss_fn``.  On a mesh of several ranks every rank passes the global
    batch and gets the global values (``_sharded_loss``)."""
    if model.mesh is not None and model.mesh.size > 1:
        return _sharded_loss(model, batch)
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


def _sharded_loss(model: Transformer, batch: dict):
    """``loss_fn`` on a mesh.  The value is the global loss; its gradient
    is that of this rank's share of it, so that each leaf's gradient
    summed over the ranks (``launch/steps.py``) is the global one
    (``launch/mesh.py`` on the convention):

    * trap 3: the NLL is divided by the global count of unmasked labels
      (summed over the dp axes), the aux (``models/moe.py``) is the rank's
      share of it over the dp axes, and both are divided by the ranks that
      compute the same rows: the ``model`` shards, times the dp ranks when
      the rows are not split.  MoE's aux over the whole batch thus enters
      the loss once, not once per dp rank;
    * a vocabulary split over ``model``: the logsumexp takes the max and
      the sum of exponentials over every block, and the gold logit comes
      from the block that holds it, summed over ``model``."""
    cfg, mesh = model.cfg, model.mesh
    local, rows = model.rows_of(batch)
    hidden, aux, _ = model(local, mode="train", rows=rows)
    logits = model.logits_from_hidden(hidden).to(torch.float32)
    labels = local["labels"].to(torch.int64)
    mask = (labels >= 0).to(torch.float32)
    v_loc = logits.shape[-1]
    if v_loc < cfg.padded_vocab:
        tp = TP(mesh)
        top = mesh.all_reduce(logits.detach().amax(-1, keepdim=True),
                              dist.ReduceOp.MAX,
                              mesh.model_group)
        lse = torch.log(tp.reduce(torch.exp(logits - top).sum(-1))) \
            + top[..., 0]
        idx = labels.clamp(min=0) - model.vocab_offset(v_loc)
        here = (idx >= 0) & (idx < v_loc)
        gold = torch.gather(logits, -1, idx.clamp(0, v_loc - 1)[..., None])
        gold = tp.reduce(torch.where(here, gold[..., 0],
                                     torch.zeros((), device=gold.device)))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[
            ..., 0]
    nll = ((lse - gold) * mask).sum()
    count = mask.sum()
    if rows is not None:
        count = mesh.all_reduce(count, dist.ReduceOp.SUM,
                                mesh.lane_group)
    denom = torch.clamp(count, min=1.0)
    share = nll / denom + 0.01 * aux
    replicas = mesh.model_shards * (1 if rows is not None
                                    else mesh.lane_shards)
    parts = torch.stack([nll / denom, aux]).detach()
    if rows is not None:
        parts = mesh.all_reduce(parts, dist.ReduceOp.SUM,
                                mesh.lane_group)
    total = parts[0] + 0.01 * parts[1]
    mine = share / replicas
    return mine + (total - mine).detach(), {
        "nll": parts[0], "aux": parts[1], "tokens": count}


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None, mesh=None) -> Transformer:
    """A model holding the JAX package's parameters: ``tree`` is the JAX
    ``init_params`` tree as numpy arrays, groups stacked as [groups, ...].
    Every leaf of the template must be there, with its shape.  With
    ``mesh``, the model holds this rank's blocks of them."""
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

    return Transformer(cfg, load(tmpl, tree, ""), device=device, mesh=mesh)


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


class ShardedCache(dict):
    """A decode cache on a mesh: this rank's block of each leaf (the dict
    itself), the leaves' specs (``cache_pspecs``) and the global sizes
    they were cut from."""

    def __init__(self, tree: dict, specs: dict, batch: int, s_max: int,
                 s_enc: Optional[int]):
        super().__init__(tree)
        self.specs, self.batch, self.s_max, self.s_enc = (specs, batch,
                                                          s_max, s_enc)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None, *,
               s_enc: Optional[int] = None, mesh=None) -> Dict[str, Any]:
    """A zeroed decode cache in the config's dtype; CUDA by default.  An
    encoder-decoder model needs ``s_enc`` (the encoder length) to decode.
    With ``mesh``, a ``ShardedCache`` of this rank's blocks (of the global
    ``batch`` and ``s_max``) on the mesh's device."""
    tmpl = cache_template(cfg, batch, s_max, s_enc)
    if mesh is None:
        dev = resolve_device(device, "init_cache")
        return _map(lambda p: torch.zeros(p.shape, dtype=_dtype(cfg),
                                          device=dev), tmpl)
    specs = cache_pspecs(cfg, mesh, batch, s_max, s_enc)
    coords = mesh_coords(mesh)

    def zeros(p: P, spec):
        sl = shard_slices(p.shape, spec, mesh, coords)
        return torch.zeros(tuple(x.stop - x.start for x in sl),
                           dtype=_dtype(cfg), device=mesh.device)

    return ShardedCache(_map2(zeros, tmpl, specs), specs, batch, s_max,
                        s_enc)


# ------------------------------------------------------------------ forward
def _zero_state(cfg, spec: LayerSpec, x, p=None):
    """The mixer's state when there is no cache (train): zeros, the
    recurrent state in float32 as the JAX package starts it (``p``, the
    sub-layer's parameters, sizes a rank's channels or heads)."""
    b, dev = x.shape[0], x.device
    if spec.mixer == "mamba":
        m = cfg.mamba
        di = (p["mixer"]["conv_w"].shape[1] if p is not None
              else m.d_inner(cfg.d_model))
        return (torch.zeros((b, di, m.d_state), dtype=torch.float32,
                            device=dev),
                torch.zeros((b, m.d_conv - 1, di), dtype=x.dtype,
                            device=dev))
    hd = cfg.rwkv.head_dim
    h = p["mixer"]["u"].shape[0] if p is not None else cfg.d_model // hd
    return (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev),
            torch.zeros((b, cfg.d_model), dtype=x.dtype, device=dev))


def _run_sublayer(cfg, spec: LayerSpec, p, x, positions, *, causal, cache,
                  cache_index, enc_out, decode, tp: TP = NO_TP):
    """One decoder (or encoder) layer.  ``cache`` (this layer's views into
    the stacked cache, or None) is updated in place; a recurrent state is
    stored in the cache's dtype, as the JAX package casts it.  Returns
    (x, aux of this layer's MoE or None)."""
    h = norm(x, p["ln1"], cfg.norm)
    if spec.mixer == "attn":
        kv = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        out = attention(p["mixer"], h, cfg, spec, positions, causal=causal,
                        cache=kv, cache_index=cache_index, tp=tp)
    else:
        names = (("ssm", "conv") if spec.mixer == "mamba"
                 else ("wkv", "shift_att"))
        state = (_zero_state(cfg, spec, x, p) if cache is None
                 else tuple(cache[n] for n in names))
        if spec.mixer == "mamba":
            out, new = mamba_mix(p["mixer"], h, cfg, state, tp)
        else:   # one token: the exact step, equal to a padded 64-chunk
            out, new = rwkv_time_mix(p["mixer"], h, cfg, state,
                                     chunk=1 if h.shape[1] == 1 else 64,
                                     tp=tp)
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
                        kv_source=None if decode and xc else enc_out, tp=tp)
        x = x + out

    h2 = norm(x, p["ln2"], cfg.norm)
    aux = None
    if spec.mixer == "rwkv":
        shift = (cache["shift_ffn"] if cache is not None else
                 torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                             device=x.device))
        out, sh2 = rwkv_channel_mix(p["mlp"], h2, shift, cfg, tp)
        if cache is not None:
            cache["shift_ffn"].copy_(sh2)
    elif spec.mlp == "moe":
        out, aux = moe_ffn(p["mlp"], h2, cfg, tp)
    else:
        out = mlp(p["mlp"], h2, cfg, tp)
    if cfg.post_norms:
        out = norm(out, p["pn2"], cfg.norm)
    return x + out, aux


def _gathered_sublayer(whole, gp, i: int, cfg, spec: LayerSpec, x,
                       positions, **kw):
    """Sub-layer ``i`` of a layer group on its parameters as ``whole``
    gathers them (over ``data`` on a mesh): under remat the gathered
    weights are freed after the forward and gathered again for the
    backward pass, as the JAX package's remat recomputes them."""
    return _run_sublayer(cfg, spec, whole(gp, i), x, positions, **kw)


def _cache_rows(cache: dict, g: int, rows, tp: TP):
    """Sub-layer caches of group ``g`` holding the batch's rows: views of
    the cache block where it holds exactly those rows (always, on a
    (data, model) mesh); else (pod x data, where the batch and the cache
    split differently) copies, taken from the block or gathered over
    ``data``, and a write-back that gathers the new rows over pod x data
    into the block, as GSPMD would reshard them."""
    views = {k: t[g] for k, t in cache.items()}
    if rows is None:
        return views, None
    (a0, a1), (c0, c1), b = rows
    if (a0, a1) == (c0, c1):
        return views, None
    mesh = tp.mesh
    tmp = {k: mesh.gather_dim(t, mesh.data_group, 0)[a0:a1].clone()
           for k, t in views.items()}
    mesh.layout_bytes += sum(t.nbytes for t in tmp.values())

    def write_back():
        for k, t in tmp.items():
            full = t if a1 - a0 == b else mesh.gather_dim(
                t, mesh.lane_group, 0)
            views[k].copy_(full[c0:c1])

    return tmp, write_back


def _stack_forward(cfg, stack_params: ParamTree, x, positions, *, groups,
                   specs, causal, cache=None, cache_index=None,
                   enc_out=None, decode=False, remat=False, tp: TP = NO_TP,
                   whole=None, rows=None):
    """Loop over layer groups and their sub-layers; ``cache`` (stacked
    over groups) is updated in place.  ``remat`` runs each sub-layer under
    ``torch.utils.checkpoint``: only its input is kept for the backward
    pass, which runs it again.  (The JAX package remats each layer group;
    one sub-layer at a time is what lets a full-width Mamba layer, whose
    scan keeps several [B, S, d_inner * d_state] float32 tensors, train on
    one card.)  On a mesh, ``whole(group params, i)`` gathers sub-layer
    i's parameters over ``data`` (inside the remat) and ``rows`` places the
    batch's rows in the cache block (``Transformer._layout``).  Returns
    (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    whole = whole or (lambda gp, i: gp[f"sub{i}"])
    for g in range(groups):
        gp = stack_params.select(g)
        for i, spec in enumerate(specs):
            sub_c, write_back = None, None
            if cache is not None:
                sub_c, write_back = _cache_rows(cache[f"sub{i}"], g, rows,
                                                tp)
            kw = dict(causal=causal, cache=sub_c, cache_index=cache_index,
                      enc_out=enc_out, decode=decode, tp=tp)
            if remat:
                x, a = checkpoint(_gathered_sublayer, whole, gp, i, cfg, spec,
                                  x, positions, use_reentrant=False, **kw)
            else:
                x, a = _gathered_sublayer(whole, gp, i, cfg, spec, x,
                                          positions, **kw)
            if write_back is not None:
                write_back()
            if a is not None:
                aux = aux + a
    return x, aux


def run_encoder(cfg, params, enc_embeds, *, remat: bool = False,
                tp: TP = NO_TP, whole=None, enc_norm=None):
    """The bidirectional encoder stack over ``enc_embeds`` [B,S_enc,d],
    then ``enc_norm`` (no positional term, as in the JAX package)."""
    b, s, _ = enc_embeds.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=enc_embeds.device)[None].expand(b, s)
    x, _ = _stack_forward(cfg, params["enc"], enc_embeds.to(_dtype(cfg)),
                          pos, groups=cfg.encoder_layers, specs=[ENC_SPEC],
                          causal=False, remat=remat, tp=tp, whole=whole)
    return norm(x, params["enc_norm"] if enc_norm is None else enc_norm,
                cfg.norm)


def _embed_in(cfg, params, batch, positions, tp: TP = NO_TP):
    """The input embeddings.  On a mesh the token table is the rank's
    block of the vocabulary: ids outside it give zero rows and the
    blocks' rows are summed over ``model``; the learned position table's
    column block is looked up and gathered."""
    if cfg.input_mode == "embeds" and "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        tok = params["embed"]["tok"]
        v_loc = tok.shape[0]
        if v_loc == cfg.padded_vocab:
            x = tok[batch["tokens"]]
        else:
            idx = batch["tokens"] - tp.offset(v_loc, cfg.padded_vocab)
            ok = (idx >= 0) & (idx < v_loc)
            x = torch.where(ok[..., None], tok[idx.clamp(0, v_loc - 1)],
                            torch.zeros((), dtype=tok.dtype,
                                        device=tok.device))
            x = tp.reduce(x)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.pos == "learned":
        pos = positions if positions.dim() == 2 else positions[0]
        x = x + tp.full(params["embed"]["pos"][pos], -1, cfg.d_model)
    return x


def _positions(batch, s, b, device):
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)
