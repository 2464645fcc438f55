"""CLI entry point: python -m pace_torch.driver.run <config.yaml>

Port of `pace_tpu.driver.run` (reference ai2cm/pace
driver/pace/driver/run.py, the click-based `pace run` command; plain
argparse here).  Runs on the card unless `--device cpu` is given.  The
performance report `<experiment_name>_perf.json` is written to the current
directory; with `performance_config.profile_dir` a Chrome trace of the time
loop is written to `<profile_dir>/trace.json`.
"""

from __future__ import annotations

import argparse
import logging
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

    from pace_torch.driver.driver import Driver, DriverConfig

    config = DriverConfig.from_yaml(args.config_path)
    logger.info("initializing driver on %s (n=%d, nz=%d, dt=%gs, %d steps)",
                args.device, config.nx_tile, config.nz, config.dt_atmos,
                config.n_timesteps())
    driver = Driver(config, device=args.device)
    logger.info("stepping %d timesteps", config.n_timesteps())
    try:
        driver.step_all()
    finally:
        # flush perf JSON / diagnostics / restart even on a crash, so a
        # failed run leaves a resumable state behind (reference
        # driver/pace/driver/run.py:89-92 try/finally cleanup)
        report = driver.cleanup()
        if report:
            logger.info("SYPD: %.4f", report.get("sypd", 0.0))
    logger.info("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
