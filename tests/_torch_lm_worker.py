"""Rank programs for the gloo worlds of ``tests/test_torch_sharded_lm.py``
(run by ``repro_torch.launch.world.run_world``; each returns plain numpy
values)."""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import AXES, AXES_MULTI_POD, Mesh
from repro_torch.launch.steps import (decode_logits, prefill_step,
                                     serve_step, vocab_argmax)
from repro_torch.models import transformer as T


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def greedy(model, cache, batch: dict, s: int, feeds: list):
    """prefill_step, then one serve_step per entry of ``feeds`` (None:
    feed the greedy token back; else an embedding [B, 1, d]).  Returns
    (last prefill logits, tokens [B, 1 + len(feeds)])."""
    last, cache = prefill_step(model, batch, cache)
    tok = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    toks = [tok]
    for i, e in enumerate(feeds):
        step = {"tokens": tok} if e is None else {"embeds": e}
        tok, cache = serve_step(model, cache, {**step, "cache_index": s + i})
        toks.append(tok)
    return last, torch.cat(toks, 1)


def extend(model, cache, tokens, at: int):
    """A multi-token forward at cache position ``at`` (a prefill that
    continues a cache): its logits over the whole vocabulary, gathered
    over ``model`` on a mesh."""
    with torch.inference_mode():
        hidden, _, _ = model({"tokens": tokens, "cache_index": at},
                             mode="prefill", cache=cache)
        logits = model.logits_from_hidden(hidden)
    if model.mesh is not None:
        logits = model.mesh.gather_dim(logits, model.mesh.model_group, -1)
    return logits


def _as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def serve(shape, cases) -> dict:
    """Each case (a config, the JAX package's parameters as numpy,
    its prompt, feeds, cache size) served on the (data, model) or (pod,
    data, model) mesh ``shape``: the global last prefill logits, the
    greedy tokens, the full cache (``unshard_tree``) and the bytes this
    rank handed to the collectives and gathered for layouts."""
    mesh = Mesh(shape, AXES if len(shape) == 2 else AXES_MULTI_POD,
                device="cpu")
    out = {"rank": mesh.rank}
    for c in cases:
        cfg = c["cfg"]
        before = sum(mesh.sent_bytes.values()), mesh.layout_bytes
        model = T.params_from_reference(cfg, c["params"], mesh=mesh)
        batch = _as_torch(c["batch"])
        cache = T.init_cache(cfg, c["b"], c["s_max"], s_enc=c["s_enc"],
                             mesh=mesh)
        feeds = [None if e is None else torch.from_numpy(e)
                 for e in c["feeds"]]
        last, toks = greedy(model, cache, batch, c["s"], feeds)
        ext = None
        if c.get("extend") is not None:
            ext = extend(model, cache, torch.from_numpy(c["extend"]),
                         c["s"] + len(feeds)).numpy()
        out[c["arch"]] = {
            "extend": ext,
            "last": last.numpy(), "tokens": toks.numpy(),
            "cache": _np_tree(T.unshard_tree(cache, cache.specs, mesh)),
            "sent": sum(mesh.sent_bytes.values()) - before[0],
            "layout": mesh.layout_bytes - before[1],
            "held": sum(p.numel() for p in model.parameters()),
        }
    return out


def logit_steps(model, cache, batch: dict, s: int, toks) -> list:
    """prefill_step, then ``decode_logits`` fed each of ``toks`` [B, n] in
    turn: each step's logits [B, 1, padded_vocab]."""
    prefill_step(model, batch, cache)
    return [decode_logits(model, cache, {"tokens": toks[:, i:i + 1],
                                         "cache_index": s + i})[0]
            for i in range(toks.shape[1])]


def vocab_mesh(arch: str, over: dict, prompt, n_dec: int) -> dict:
    """A seeded smoke ``arch`` (with ``over``) on a (1, 2) mesh: its last
    prefill logits and greedy tokens from ``prompt``, then each decode
    step's logits fed those tokens, and the shape of its ``lm_head``."""
    from repro_torch.configs import get_smoke_config

    mesh = Mesh((1, 2), device="cpu")
    cfg = get_smoke_config(arch).scaled(**over)
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          mesh=mesh)
    b, s = prompt.shape
    cache = T.init_cache(cfg, b, s + n_dec, mesh=mesh)
    batch = {"tokens": torch.from_numpy(prompt)}
    last, toks = greedy(model, cache, batch, s, [None] * n_dec)
    steps = logit_steps(model, cache, batch, s, toks[:, :-1])
    return {"last": last.numpy(), "tokens": toks.numpy(),
            "steps": [x.numpy() for x in steps],
            "lm_head": tuple(model.params.tree()["lm_head"].shape)}


TIE_LOGITS = [[0., 1., 9., 3., 4., 2., 9., 1.],
              [0., 1., 2., 3., 4., 7., 1., 7.],
              [5., 1., 2., 3., 4., 2., 1., 6.],
              [1., 2.0078125, 0., 0., 2.0078125, 0., 0., 2.]]


def tie_break() -> dict:
    """Greedy ids over ``TIE_LOGITS``, a vocabulary of 8 split over the
    two ranks of a (1, 2) mesh, in float32 and in bfloat16: row 0 ties
    across the blocks (ids 2 and 6), row 1 ties inside block 1 (ids 5
    and 7) above block 0, row 2 has its max alone in block 1, row 3 ties
    across the blocks (ids 1 and 4) just above 2.0."""
    mesh = Mesh((1, 2), device="cpu")
    full = torch.tensor(TIE_LOGITS)
    local = full[:, 4 * mesh.model_index:4 * mesh.model_index + 4]
    return {str(dt): vocab_argmax(local.to(dt), mesh,
                                  4 * mesh.model_index).tolist()
            for dt in (torch.float32, torch.bfloat16)}
