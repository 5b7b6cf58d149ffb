"""Training launcher: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch smollm-135m --steps 50
    python -m repro_torch.launch.train --arch qwen2-1.5b --full \\
        --batch 2 --seq 2048 --steps 8 --gridpilot

Runs the training loop on one device (``--device``, default ``cuda``): the
reduced config by default, the published one with ``--full``.  Under the
``REPRO_COORD_ADDR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
environment (one process per card) it trains on
``launch.mesh.make_local_mesh()``, each rank on its share of every batch,
the parameters and moments placed by the plan: sharded for an arch whose
plan is ``fsdp_tp`` (yi-9b, command-r-plus-104b, mamba2-1.3b,
zamba2-2.7b, phi-3-vision-4.2b, olmoe-1b-7b, mixtral-8x22b at
``--full``).  One process holds the whole state on its device: a world
of one would shard nothing and pay the sharded path's host cost.
With ``--gridpilot`` the GridPilot controller runs alongside: a Tier-3
plan from a synthetic grid, the safety island armed, FFR triggers
shedding steps.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published config; default reduced")
    ap.add_argument("--gridpilot", action="store_true")
    ap.add_argument("--grid-country", default="DE")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import distributed_env, make_local_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh = (make_local_mesh(args.device) if distributed_env() is not None
            else None)

    gp = None
    if args.gridpilot:
        from repro_torch.core.controller import GridPilot
        from repro_torch.grid.signals import make_grid

        grid = make_grid(args.grid_country, 24)
        gp = GridPilot(n_hosts=1, chips_per_host=1, device=args.device)
        plan = gp.hourly_plan(grid.ci, grid.t_amb)
        print(f"GridPilot plan: mu={plan.mu} rho={plan.rho} "
              f"(op row {gp.current_row} armed)")

    try:
        tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir)
        trainer = Trainer(cfg, shape, mesh, tcfg, gridpilot=gp,
                          seed=args.seed, device=args.device)
        out = trainer.train()
    finally:
        if gp is not None:
            gp.close()
        if mesh is not None:
            dist.destroy_process_group()
    losses = [h["loss"] for h in out["history"]]
    print(f"done: {len(losses)} steps, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}, skipped {out['skipped']} (power shed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
