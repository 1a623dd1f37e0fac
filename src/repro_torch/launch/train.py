"""Training launcher of the port.

Smoke run (real compute on a reduced config; the card by default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --smoke --steps 3 --device cpu
Production shapes need the sharding slice of the port (a device mesh
over many cards), which is not ported yet: the launcher says so.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import INPUT_SHAPES, get_config, reduce_config
from repro_torch.training.loop import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k",
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on one device")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
        hist = train(cfg, steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq, lr=args.lr,
                     accum_steps=args.accum, ckpt_path=args.ckpt,
                     device=args.device)
        print(f"final loss {hist[-1]['loss']:.4f}")
        return

    shape = INPUT_SHAPES[args.shape]
    raise SystemExit(
        f"production training of {cfg.name} at {shape.name} needs a device "
        f"mesh over many cards, which comes with the sharding and launch "
        f"slice of the port (not ported yet). Use --smoke for local runs.")


if __name__ == "__main__":
    main()
