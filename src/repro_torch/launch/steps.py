"""Serving steps of the LM substrate: prefill a cache, then decode greedily.

PyTorch counterparts of the inner ``step`` functions of
``repro.launch.steps.build_prefill_step`` and ``build_serve_step``, on one
device and without a mesh.  Both run on the model's device (CUDA unless
the model was made elsewhere) under ``torch.inference_mode()`` and update
the cache in place, where the JAX steps return a new (donated) one.  The
batches are the JAX package's (``repro.launch.shapes.batch_specs``):
"tokens" [B, S], or "embeds" [B, S, d] for an ``input_mode="embeds"``
model; "enc_embeds" [B, S_enc, d] at prefill for an encoder-decoder
model; "positions" [3, B, S] for M-RoPE.  The train step waits for the
training slice (ROADMAP A12).

    model = Transformer(cfg)                      # on CUDA by default
    cache = init_cache(cfg, batch=2, s_max=4096)
    logits, cache = prefill_step(model, {"tokens": prompt}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for i in range(prompt.shape[1], prompt.shape[1] + n_new):
        tok, cache = serve_step(model, cache, {"tokens": tok,
                                               "cache_index": i})
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import Transformer


@torch.inference_mode()
def prefill_step(model: Transformer, batch: dict, cache: dict):
    """Fill ``cache`` (zeroed first, as the JAX step starts from a zero
    cache) with the prompt from position 0.  Returns (last_logits
    [B, 1, padded_vocab], cache)."""
    for sub in cache.values():
        for t in sub.values():
            t.zero_()
    hidden, _, cache = model(batch, mode="prefill", cache=cache)
    return model.logits_from_hidden(hidden[:, -1:, :]), cache


@torch.inference_mode()
def serve_step(model: Transformer, cache: dict, batch: dict):
    """One greedy decode token: ``batch["tokens"]`` [B, 1] (or "embeds"
    [B, 1, d]) at position ``batch["cache_index"]``.  That is also its
    position unless ``batch["positions"]`` is given, as the JAX decode
    batch always has it: [B, 1], or [3, B, 1] for M-RoPE.  Returns
    (next_token [B, 1] int32, cache)."""
    if "positions" not in batch:
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        shape = (x.shape[0], 1)
        if model.cfg.pos == "mrope":
            shape = (3,) + shape
        batch = {**batch, "positions": torch.full(
            shape, int(batch["cache_index"]), dtype=torch.int32,
            device=x.device)}
    hidden, _, cache = model(batch, mode="decode", cache=cache)
    logits = model.logits_from_hidden(hidden)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
