"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --steps 50 [--smoke] [--fail-at 20] [--ckpt DIR] [--device cpu]

PyTorch counterpart of ``repro.launch.train`` on one device: CUDA unless
``--device`` names another.  ``--smoke`` trains the reduced config (the
runnable path on a CPU); without it the full config, which only the
smaller architectures fit on one card.  The JAX launcher's
``--multi-pod`` mesh waits for training on a mesh (ROADMAP A11c).
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLMData
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
    tr = Trainer(cfg, data,
                 TrainerConfig(steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt, lr=args.lr),
                 injector=injector, device=args.device)
    out = tr.run()
    print(f"[train] arch={args.arch} device={tr.device} {out}")
    return out


if __name__ == "__main__":
    main()
