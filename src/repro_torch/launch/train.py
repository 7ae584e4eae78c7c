"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --steps 50 [--smoke] [--fail-at 20] [--ckpt DIR] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node=N -m repro_torch.launch.train \
        --arch jamba-1.5-large-398b --smoke --model 2 [--device cpu]

PyTorch counterpart of ``repro.launch.train``.  It trains on a mesh of the
ranks ``torchrun`` starts (``launch.mesh.make_host_mesh``: (N / model,
model), over NCCL on each rank's card, or gloo with ``--device cpu``; a
world of one rank without ``torchrun``), as the JAX launcher trains on its
host mesh.  ``--multi-pod`` builds the production (pod, data, model) =
(2, 16, 16) mesh instead, which raises unless the world has 512 ranks.
``--smoke`` trains the reduced config (the runnable path on a CPU);
without it the full config.  The process group the launcher brings up, it
takes down.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis shards of the host mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: each rank's card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    data = SyntheticLMData(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0,
        input_mode=cfg.input_mode, d_model=cfg.d_model,
        encoder=cfg.encoder_layers > 0, mrope=cfg.pos == "mrope")
    injector = FaultInjector(
        fail_at={args.fail_at: "cli-injected failure"}
        if args.fail_at >= 0 else {})
    owner = not dist.is_initialized()
    try:
        if args.multi_pod:
            cpu = args.device is not None and args.device == "cpu"
            mesh = make_production_mesh(multi_pod=True,
                                        backend="gloo" if cpu else "nccl",
                                        device=args.device)
        else:
            mesh = make_host_mesh(args.model, device=args.device)
        tr = Trainer(cfg, data,
                     TrainerConfig(steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   ckpt_dir=args.ckpt, lr=args.lr),
                     injector=injector, mesh=mesh)
        out = tr.run()
    finally:
        if owner and dist.is_initialized():
            dist.destroy_process_group()
    shape = dict(zip(mesh.axis_names, mesh.shape))
    print(f"[train] arch={args.arch} mesh={shape} rank={mesh.rank} "
          f"device={tr.device} {out}")
    return out


if __name__ == "__main__":
    main()
