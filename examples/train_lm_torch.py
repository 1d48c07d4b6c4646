"""End-to-end training driver example on the PyTorch port
(``examples/train_lm.py``'s counterpart on ``repro_torch``).

Default: a reduced model on the card.  The real ~130M-parameter
configuration (mamba2-130m) runs with ``--arch mamba2-130m --no-reduced
--steps 300``, the same code path at full width and depth.  Without a GPU
pass ``--device cpu``; without it the run raises.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 100 --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import default_hparams_for, train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--no-reduced", action="store_true",
                    help="run the FULL config (slow on the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card; raises without one)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.no_reduced:
        cfg = reduced(cfg)
    hp = dataclasses.replace(
        default_hparams_for(cfg, global_batch=args.batch, data_shards=1),
        total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
        grad_accum=2)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    state, losses, wd = train_loop(
        cfg, hp, batch=args.batch, seq=args.seq, steps=args.steps,
        ckpt_dir=ckpt_dir, ckpt_every=max(10, args.steps // 5),
        log_every=max(1, args.steps // 20), device=args.device)
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps"
          f"; stragglers {wd.straggler_count}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
