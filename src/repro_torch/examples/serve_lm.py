"""Serve an LM sharded over a mesh of ranks: one process per rank, started
by ``torchrun``.

Each rank holds its blocks of the parameters and of the cache (the JAX
package's ``param_pspecs`` / ``cache_pspecs`` layout), takes the global
prompt, and gets the global greedy tokens back.  By default the model
shards over ``model`` (tensor, expert and Mamba-channel parallelism,
the attention cache split by sequence); ``--model-shards`` below the
world size puts the rest on ``data`` (FSDP weights, the batch split).

On a machine with two cards, the whole Jamba-1.5-Large period with its
experts (8 layers, 45.36 B parameters, 84.5 GiB in bf16, more than one
card holds):

    torchrun --nproc-per-node=2 -m repro_torch.examples.serve_lm \\
        --arch jamba-1.5-large-398b --layers 8 --model-shards 2

On the CPU (gloo; the smoke widths):

    PYTHONPATH=src torchrun --nproc-per-node=2 -m \\
        repro_torch.examples.serve_lm --device cpu --smoke
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models.transformer import Transformer, init_cache


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced widths")
    ap.add_argument("--model-shards", type=int, default=None,
                    help="ranks on the model axis (default: the world)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or the rank's card (default)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    if cfg.input_mode != "tokens" or cfg.encoder_layers:
        raise SystemExit(f"{args.arch}: this example feeds tokens to a "
                         "decoder-only model")
    # 2 prompts of 2,048 tokens into 32,768 positions (16 into 64 at the
    # smoke widths)
    b, s, s_max = (2, 16, 64) if args.smoke else (2, 2_048, 32_768)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    init_world("gloo" if cpu else "nccl")       # torchrun's environment
    mesh = make_host_mesh(args.model_shards or dist.get_world_size(),
                          device=args.device)
    dev = mesh.device

    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        mesh=mesh)
    held = sum(p.numel() for p in model.parameters())
    cache = init_cache(cfg, b, s_max, mesh=mesh)
    init_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    last, cache = prefill_step(model, {"tokens": prompt}, cache)
    tok = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    sync()
    pre_s = time.perf_counter() - t0
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(args.steps):
        tok, cache = serve_step(model, cache, {"tokens": tok,
                                               "cache_index": s + i})
        toks.append(tok)
    sync()
    dec_s = time.perf_counter() - t0
    tokens = torch.cat(toks, 1).cpu()
    out = {"rank": mesh.rank, "mesh": mesh.shape, "tokens": tokens.tolist(),
           "params": cfg.param_count(), "held": held, "init_s": init_s,
           "prefill_tokens_per_s": b * s / pre_s,
           "decode_ms": 1e3 * dec_s / max(1, args.steps),
           "sent_bytes": dict(mesh.sent_bytes),
           "layout_bytes": mesh.layout_bytes}
    if mesh.rank == 0:
        print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters "
              f"({cfg.n_layers} layers, {cfg.dtype}) on "
              f"{dict(zip(mesh.axis_names, mesh.shape))}, {held / 1e9:.3f} B "
              f"on rank 0; prefill {b} x {s} tokens into "
              f"{s_max} positions at {out['prefill_tokens_per_s']:.0f} "
              f"tokens/s, {args.steps} greedy steps at "
              f"{out['decode_ms']:.2f} ms a step; tokens {tokens.tolist()}")
    return out


if __name__ == "__main__":
    main()
    dist.destroy_process_group()
