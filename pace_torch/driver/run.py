"""CLI entry point: python -m pace_torch.driver.run <config.yaml>

Port of `pace_tpu.driver.run` (reference ai2cm/pace
driver/pace/driver/run.py, the click-based `pace run` command; plain
argparse here).  Runs on the card unless `--device cpu` is given.  The
performance report `<experiment_name>_perf.json` is written to the current
directory; with `performance_config.profile_dir` a Chrome trace of the time
loop is written to `<profile_dir>/trace.json`.

A config whose `mesh.layout` is `[t, 1, 1]` runs under torchrun, one
process a rank:

    torchrun --nproc_per_node t -m pace_torch.driver.run <config.yaml>

Each rank reads RANK, LOCAL_RANK and WORLD_SIZE from torchrun's
environment and runs on `cuda:LOCAL_RANK` (`--device cpu`: on the CPU,
exchanging through gloo); rank 0 writes the files.  A one-rank config runs
without torchrun.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pace_torch.driver.run",
        description="Run the pace_torch model from a yaml configuration.",
    )
    parser.add_argument("config_path", help="path to a yaml driver config")
    parser.add_argument(
        "--log-level", default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR"],
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda; cpu runs the kernels' "
             "plain PyTorch versions)",
    )
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    logger = logging.getLogger("pace_torch.driver")

    import torch.distributed as dist

    from pace_torch.driver.driver import Driver, DriverConfig

    config = DriverConfig.from_yaml(args.config_path)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != config.mesh.ranks and not config.mesh.multihost:
        raise ValueError(
            f"{world} processes for mesh layout {list(config.mesh.layout)} "
            f"of {config.mesh.ranks} ranks: give torchrun --nproc_per_node "
            f"{config.mesh.ranks}")
    logger.info("initializing driver on %s (n=%d, nz=%d, dt=%gs, %d steps, "
                "layout %s)", args.device, config.nx_tile, config.nz,
                config.dt_atmos, config.n_timesteps(),
                list(config.mesh.layout))
    try:
        driver = Driver(config, device=args.device)
        logger.info("rank %d on %s: stepping %d timesteps", driver.rank,
                    driver.device, config.n_timesteps())
        stepped = False
        try:
            driver.step_all()
            stepped = True
        finally:
            # flush perf JSON / diagnostics / restart even on a crash, so a
            # failed run leaves a resumable state behind (reference
            # driver/pace/driver/run.py:89-92 try/finally cleanup); the
            # ranks of a failed multi-rank run cannot meet in the gathers
            if stepped or driver.comm is None:
                report = driver.cleanup()
                if report:
                    logger.info("SYPD: %.4f", report.get("sypd", 0.0))
            else:
                logger.error("rank %d: a step failed; nothing is written",
                             driver.rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    logger.info("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
