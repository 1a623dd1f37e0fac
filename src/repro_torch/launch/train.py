"""Training launcher of the port.

Smoke run (real compute on a reduced config; the card by default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --smoke --steps 3 --device cpu
Production shape (a 256-card mesh, one process per card, the default
process group started by the caller):
    python -m repro_torch.launch.train --arch nemotron-4-340b \
        --shape train_4k
lays every parameter out on the production mesh by the logical-axis
rules and prints the layout; with fewer cards it exits naming the count.
"""
from __future__ import annotations

import argparse
from typing import Any, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, reduce_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.params import init_params
from repro_torch.sharding import rules
from repro_torch.sharding.axes import param_axes
from repro_torch.training.loop import train
from repro_torch.tree import leaves, tree_map


def production_layout(cfg: ModelConfig, mesh) -> Tuple[Any, Any]:
    """(parameter shapes, DTensor placements) of ``cfg`` on ``mesh``: two
    trees of the parameters' structure, the shapes drawn on the meta
    device (no memory), each leaf's placements resolved from its logical
    axes."""
    shapes = init_params(cfg, torch.Generator(), device="meta")
    with rules.activate(mesh):
        return shapes, tree_map(lambda x, a: rules.placements(a, x.shape),
                                shapes, param_axes(shapes))


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
    n_dev = mesh_lib.device_count()
    need = 256
    if n_dev < need:
        raise SystemExit(
            f"production training of {cfg.name} at {shape.name} needs a "
            f">=256-card mesh ({n_dev} cards visible). Use --smoke for "
            f"local runs.")
    mesh = mesh_lib.make_production_mesh()
    shapes, layout = production_layout(cfg, mesh)
    sharded = leaves(tree_map(lambda _, pl: any(p.is_shard() for p in pl),
                              shapes, layout))
    print(f"laid out {cfg.name} at {shape.name} on mesh "
          f"{rules.mesh_sizes(mesh)}: {len(sharded)} parameter leaves, "
          f"{sum(sharded)} sharded; materialize the shards and train")


if __name__ == "__main__":
    main()
