"""Steps of the LM substrate: train (gradient accumulation + optimizer),
prefill a cache, then decode greedily.

PyTorch counterparts of the inner ``step`` functions of
``repro.launch.steps.build_train_step``, ``build_prefill_step`` and
``build_serve_step``.  They run on the model's device (CUDA unless the
model was made elsewhere).  A model built on a mesh
(``Transformer(cfg, mesh=)``, its cache from ``init_cache(..., mesh=)``)
serves and trains sharded: every rank passes the global batch, takes its
rows (over the dp axes where the batch splits evenly and is > 1, as the
JAX steps' ``_bspec``) and gets the global result back.  The train step
updates the model's parameters in place, as the serving steps (under
``torch.inference_mode()``) update the cache in place, where the JAX steps
return new (donated) trees.  The batches are the JAX package's
(``repro.launch.shapes.batch_specs``): "tokens" [B, S], or "embeds"
[B, S, d] for an ``input_mode="embeds"`` model; "enc_embeds" [B, S_enc, d]
for an encoder-decoder model; "positions" [3, B, S] for M-RoPE; "labels"
[B, S] to train.

    model = Transformer(cfg)                      # on CUDA by default
    step, opt = build_train_step(cfg)
    opt_state = opt.init(model.params.tree())
    opt_state, metrics = step(model, opt_state, batch)
    # sharded: model = Transformer(cfg, mesh=mesh)
    #          opt_state = opt.init(model.params.tree(), mesh=mesh,
    #                               pspecs=model.pspecs)

    cache = init_cache(cfg, batch=2, s_max=4096)
    # sharded: model = Transformer(cfg, mesh=mesh)
    #          cache = init_cache(cfg, 2, 4096, mesh=mesh)
    logits, cache = prefill_step(model, {"tokens": prompt}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for i in range(prompt.shape[1], prompt.shape[1] + n_new):
        tok, cache = serve_step(model, cache, {"tokens": tok,
                                               "cache_index": i})
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.sharding import TP, replicated_axes
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.optim import make_optimizer


def _split_micro(batch: dict, n_micro: int) -> list:
    """``n_micro`` microbatches of ``batch``, split along the batch axis
    as ``repro.launch.steps._split_micro`` splits it (M-RoPE positions
    [3, B, S] along their second axis; a scalar goes to every one)."""
    def split(x):
        if x.dim() == 0:
            return x.expand(n_micro)
        if x.shape[0] == 3 and x.dim() == 3:  # mrope positions (3,B,S)
            return x.reshape(3, n_micro, -1, *x.shape[2:]).transpose(0, 1)
        return x.reshape(n_micro, -1, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def _leaves(tree: dict) -> list:
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _leaves_like(tree: dict, other: dict) -> list:
    """``other``'s leaves in the order ``_leaves(tree)`` lists ``tree``'s
    (matched by key: ``params.tree()`` lists sub-dicts first)."""
    return [x for k, v in tree.items()
            for x in (_leaves_like(v, other[k]) if isinstance(v, dict)
                      else [other[k]])]


def _like(tree: dict, leaves) -> dict:
    """A nested dict shaped like ``tree`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return build(tree)


def grads_of(model: Transformer, batch: dict, n_micro: int = 1):
    """(loss, gradients): ``loss_fn``'s value and its gradient with respect
    to every parameter of ``model`` (a list in ``params.tree()`` leaf
    order), over ``n_micro`` microbatches summed in float32 and divided by
    ``n_micro`` (with one, in the parameters' dtype).  The parameters are
    made trainable (``requires_grad_``) on first use.

    On a mesh every rank passes the global batch.  A rank's backward gives
    each leaf the gradient of its share of the loss; a leaf sharded over an
    axis has its sum over that axis from the reduce-scatters of its gathers
    (FSDP over ``data``, layouts over ``model``), and a leaf replicated
    over an axis (trap 2: no ``embed`` dimension, replicated over pod x
    data; trap 1: every leaf replicated over ``model``) is summed over it
    here, never both.  The result is each leaf's global gradient, in this
    rank's block."""
    model.requires_grad_(True)
    params = model.params.tree()
    leaves = _leaves(params)
    if n_micro > 1:
        gsum = [torch.zeros(p.shape, dtype=torch.float32,
                            device=p.device) for p in leaves]
        lsum = 0.0
        for mb in _split_micro(batch, n_micro):
            loss, _ = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(gsum, grads):
                if g is not None:
                    acc.add_(g)
            lsum = lsum + loss.detach()
            del grads, loss
        grads = [g / n_micro for g in gsum]
        del gsum
        loss = lsum / n_micro
    else:
        loss, _ = loss_fn(model, batch)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        loss = loss.detach()
    if model.mesh is not None:
        _sum_replicas(model.mesh, grads, _leaves_like(params, model.pspecs))
    return loss, grads


@torch.no_grad()
def _sum_replicas(mesh, grads: list, specs: list) -> None:
    """Sum each gradient over the axes its leaf is replicated on, in
    place: one float32 all-reduce for all the leaves that share those
    axes."""
    buckets: dict = {}
    for i, sp in enumerate(specs):
        axes = replicated_axes(sp, mesh)
        if axes:
            buckets.setdefault(axes, []).append(i)
    for axes, idx in buckets.items():
        flat = mesh.sum_over(torch.cat([grads[i].reshape(-1).to(
            torch.float32) for i in idx]), axes)
        at = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].view(grads[i].shape).to(
                grads[i].dtype)
            at += n


def _grad_norm(grads: list, mesh=None, specs=None) -> torch.Tensor:
    """The float32 global norm of ``grads``; on a mesh of several ranks
    (``specs`` the leaves' specs, in order) each leaf's sum of squares
    counted once: summed over the ranks that hold its blocks, never over
    its replicas."""
    if mesh is None or mesh.size == 1:
        return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                              for g in grads))
    sq = torch.stack([torch.sum(g.to(torch.float32) ** 2) for g in grads])
    first = torch.tensor([all(mesh.coords[a] == 0
                              for a in replicated_axes(sp, mesh))
                          for sp in specs], device=sq.device)
    sq = mesh.all_reduce(torch.where(first, sq, torch.zeros_like(sq)),
                         dist.ReduceOp.SUM)
    return torch.sqrt(sq.sum())


@torch.no_grad()
def apply_grads(model: Transformer, opt, opt_state: dict, grads: list):
    """The optimizer's update from ``grads`` (``grads_of``'s) added to
    every parameter of ``model`` in place (``p + u.to(p.dtype)``; on a mesh
    each rank updates its blocks).  Returns (new opt_state, the float32
    global gradient norm)."""
    params = model.params.tree()
    mesh = model.mesh
    gnorm = _grad_norm(grads, mesh, _leaves_like(params, model.pspecs)
                       if mesh is not None else None)
    updates, opt_state = opt.update(_like(params, grads), opt_state, params,
                                    mesh=mesh, pspecs=model.pspecs)
    for p, u in zip(_leaves(params), _leaves(updates)):
        p.add_(u.to(p.dtype))
    return opt_state, gnorm


def build_train_step(cfg, n_micro: int = 1, lr: float = 3e-4):
    """Returns (step, optimizer): the config's optimizer
    (``optim.make_optimizer``) and

        step(model, opt_state, batch) -> (opt_state, {"loss", "grad_norm"})

    which is ``grads_of`` (the gradient of ``loss_fn`` over ``n_micro``
    microbatches) then ``apply_grads`` (the float32 global norm, and the
    optimizer's update added to every parameter in place).  On a mesh
    (``Transformer(cfg, mesh=)``) every rank passes the global batch and
    an ``opt_state`` from ``opt.init(params, mesh=model.mesh,
    pspecs=model.pspecs)``, and gets the global loss and norm."""
    opt = make_optimizer(cfg, lr=lr)

    def step(model: Transformer, opt_state: dict, batch: dict):
        loss, grads = grads_of(model, batch, n_micro)
        opt_state, gnorm = apply_grads(model, opt, opt_state, grads)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    return step, opt


def _global_rows(model: Transformer, t: torch.Tensor, split: bool):
    return model.mesh.gather_dim(t, model.mesh.lane_group, 0) if split \
        else t


def vocab_argmax(logits: torch.Tensor, mesh=None, v0: int = 0
                 ) -> torch.Tensor:
    """Greedy ids over the last axis, ``logits`` being this rank's block
    of the vocabulary (from id ``v0``) on ``mesh``: each block's (max,
    first index), then the largest max with the lowest global index on
    ties, as ``torch.argmax`` and ``jnp.argmax`` break them."""
    idx = torch.argmax(logits, dim=-1)
    tp = TP(mesh)
    if tp.m == 1:
        return idx
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    idx = idx + v0
    vals, idxs = tp.gather(val[None], 0), tp.gather(idx[None], 0)
    best = torch.argmax(vals.to(torch.float32), dim=0)   # the first block
    return torch.gather(idxs, 0, best[None])[0]


def _whole_vocab(model: Transformer, logits: torch.Tensor) -> torch.Tensor:
    """``logits`` over the whole padded vocabulary: gathered over ``model``
    where this rank holds a block of it."""
    if logits.shape[-1] < model.cfg.padded_vocab:
        logits = TP(model.mesh).gather(logits, -1)
    return logits


@torch.inference_mode()
def prefill_step(model: Transformer, batch: dict, cache: dict):
    """Fill ``cache`` (zeroed first, as the JAX step starts from a zero
    cache) with the prompt from position 0.  Returns (last_logits
    [B, 1, padded_vocab], cache); on a mesh the logits are the global
    ones, on every rank."""
    for sub in cache.values():
        for t in sub.values():
            t.zero_()
    batch, rows = model.rows_of(batch)
    split = rows is not None
    hidden, _, cache = model(batch, mode="prefill", cache=cache)
    logits = _whole_vocab(model, model.logits_from_hidden(hidden[:, -1:, :]))
    return _global_rows(model, logits, split), cache


def _decode(model: Transformer, cache: dict, batch: dict):
    """One decode forward of ``serve_step``'s batch: (this rank's logits
    [b, 1, its vocabulary block], whether its rows are a block of the
    batch, cache)."""
    if "positions" not in batch:
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        shape = (x.shape[0], 1)
        if model.cfg.pos == "mrope":
            shape = (3,) + shape
        batch = {**batch, "positions": torch.full(
            shape, int(batch["cache_index"]), dtype=torch.int32,
            device=x.device)}
    batch, rows = model.rows_of(batch)
    split = rows is not None
    hidden, _, cache = model(batch, mode="decode", cache=cache)
    return model.logits_from_hidden(hidden), split, cache


@torch.inference_mode()
def serve_step(model: Transformer, cache: dict, batch: dict):
    """One greedy decode token: ``batch["tokens"]`` [B, 1] (or "embeds"
    [B, 1, d]) at position ``batch["cache_index"]``.  That is also its
    position unless ``batch["positions"]`` is given, as the JAX decode
    batch always has it: [B, 1], or [3, B, 1] for M-RoPE.  Returns
    (next_token [B, 1] int32, cache); on a mesh the global tokens, on
    every rank (the argmax over the vocabulary blocks,
    ``vocab_argmax``)."""
    logits, split, cache = _decode(model, cache, batch)
    tok = vocab_argmax(logits, model.mesh, model.vocab_offset(
        logits.shape[-1])).to(torch.int32)
    return _global_rows(model, tok, split), cache


@torch.inference_mode()
def decode_logits(model: Transformer, cache: dict, batch: dict):
    """``serve_step``'s forward with its logits in place of the token:
    (logits [B, 1, padded_vocab], cache); on a mesh the global logits, on
    every rank.  Their argmax is ``serve_step``'s token."""
    logits, split, cache = _decode(model, cache, batch)
    return _global_rows(model, _whole_vocab(model, logits), split), cache
