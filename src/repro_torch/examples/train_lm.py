"""Train a ~100M-parameter LM with the fault-tolerant runtime.

PyTorch counterpart of ``examples/train_lm.py``.  Defaults are CPU-sized
(a reduced qwen2-family model, a few steps) so the example runs anywhere;
``--full`` selects the real ~100M config (``full_config``) and a few
hundred steps, for a card.  It runs on CUDA unless ``--device`` names
another device.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 20]
      [--full] [--fail-at 7] [--device cpu]
      # --fail-at injects a node failure: watch the restart
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig


def full_config():
    """The ~100M-parameter qwen2-family config of ``--full`` (12 layers,
    d_model 768, float32) and its (batch, seq): 8 x 512."""
    cfg = get_config("qwen2-7b").scaled(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32_768, max_seq=512, dtype="float32")
    return cfg, 8, 512


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--full", action="store_true",
                    help="~100M params, seq 512, few hundred steps")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.full:
        cfg, batch, seq = full_config()
        steps = max(args.steps, 300)
    else:
        cfg = get_config("qwen2-7b").smoke().scaled(n_layers=4, d_model=128,
                                                    d_ff=256)
        batch, seq = 4, 64
        steps = args.steps
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
          f"batch={batch} seq={seq} steps={steps}")

    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    injector = FaultInjector(
        fail_at={args.fail_at: "injected node loss"}
        if args.fail_at >= 0 else {})
    tr = Trainer(cfg, data,
                 TrainerConfig(steps=steps, ckpt_every=max(2, steps // 4),
                               ckpt_dir=args.ckpt, lr=3e-4),
                 injector=injector, device=args.device)
    out = tr.run()
    first = tr.metrics[0]["loss"]
    print(f"loss {first:.3f} -> {out['final_loss']:.3f} over "
          f"{out['steps_run']} logged steps; restarts={out['restarts']} "
          f"straggler_flags={out['straggler_flags']} on {tr.device}")
    if not out["final_loss"] < first:
        raise RuntimeError("training should reduce loss")
    print("checkpoints at:", args.ckpt)
    return out


if __name__ == "__main__":
    main()
