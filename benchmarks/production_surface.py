"""Throughput of the shipped production config's FULL estimator surface.

Runs ``examples/dmc_production.yml`` through the real ``Proc.exec``
driver path (the same code the CLI runs) and reports the steady-state
walker-steps/s, optionally with named estimators dropped — the A/B
tool for pricing an estimator at the production surface (e.g. the
imaginary-time correlation ring buffer, ``--drop itc_spec``).

A warm pass (2 blocks, excluded from timing) pre-compiles every block
function through the shared-trace caches, so the timed pass starts hot
and the reported rate is the driver's own cumulative walker-steps/s
log line (fetches, accumulator work and window bookkeeping included —
this is the number a production user sees, not the bare sampler rate
``bench.py --estimators`` measures).

No reference analog: the reference never measures or logs throughput.

Run: PYTHONPATH=. \
       python benchmarks/production_surface.py [--drop itc_spec] ...
"""
import argparse
import json
import logging
import pathlib
import re
import time

EXAMPLES = pathlib.Path(__file__).parents[1] / "examples"

DROPPABLE = ("density_spec", "ssf_spec", "obd_spec", "pair_corr_spec",
             "cm_diffusion_spec", "itc_spec")


class _RateCapture(logging.Handler):
    """Collects the driver's cumulative walker-steps/s log lines."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.rates = []

    def emit(self, record):
        m = re.search(r"([\d,]+) walker-steps/s", record.getMessage())
        if m:
            self.rates.append(float(m.group(1).replace(",", "")))


def measure(blocks: int = 12, drop=(), bare: bool = False,
            dry: bool = False) -> dict:
    """Measure the production-surface throughput; returns the payload
    dict (also run by ``bench.py`` as its production stage)."""
    if dry:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache(min_compile_time_secs=0.5)

    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
    from phd_qmclib_tpu.qmc_exec.config import Loader
    from phd_qmclib_tpu.qmc_exec.logging import exec_logger
    from phd_qmclib_tpu.qmc_exec.proc import ModelSysConfSpec

    cfg = dict(Loader().load(
        EXAMPLES / "dmc_production.yml")["app_spec"][0]["proc"])
    cfg.pop("checkpoint_file", None)
    cfg.pop("checkpoint_every", None)
    drops = list(DROPPABLE) if bare else list(drop)
    for key in drops:
        cfg.pop(key, None)
    if dry:
        cfg.update(max_num_walkers=48, target_num_walkers=32,
                   num_time_steps_block=32, dtype="float64", est_every=4,
                   model_spec=dict(cfg["model_spec"], boson_number=5,
                                   supercell_size=5.0))
        for key, small in (("density_spec", {"num_bins": 8}),
                           ("ssf_spec", {"num_modes": 4}),
                           ("obd_spec", {"num_pos": 4}),
                           ("pair_corr_spec", {"num_bins": 8}),
                           ("cm_diffusion_spec", {"window_blocks": 2}),
                           ("itc_spec", {"num_modes": 4, "num_lags": 3,
                                         "est_every_mult": 2})):
            if key in cfg:
                cfg[key] = dict(cfg[key],
                                **small) if key != "cm_diffusion_spec" \
                    and key != "itc_spec" else small

    variant = "bare" if bare else (
        "full-minus-" + "+".join(d.replace("_spec", "") for d in drops)
        if drops else "full")

    # CM-diffusion windows must tile the run exactly.
    cm_window = (cfg.get("cm_diffusion_spec") or {}).get(
        "window_blocks", 1)
    timed_blocks = -(-blocks // cm_window) * cm_window

    # Fresh walker ensemble once; both passes start from it.
    warm_proc = dmc_exec.Proc.from_config(
        dict(cfg, num_blocks=max(2, cm_window), burn_in_blocks=0))
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        ModelSysConfSpec(dist_type="RANDOM"), warm_proc)

    t0 = time.perf_counter()
    warm_proc.exec(proc_input)
    warm_s = time.perf_counter() - t0

    timed_proc = dmc_exec.Proc.from_config(
        dict(cfg, num_blocks=timed_blocks, burn_in_blocks=0))
    capture = _RateCapture()
    exec_logger.addHandler(capture)
    t0 = time.perf_counter()
    timed_proc.exec(proc_input)
    wall_s = time.perf_counter() - t0
    exec_logger.removeHandler(capture)

    return {
        "metric": "dmc_production_surface", "variant": variant,
        "value": capture.rates[-1] if capture.rates else None,
        "unit": "walker-steps/s", "blocks": timed_blocks,
        "block_rates_cumulative": capture.rates,
        "warm_s": round(warm_s, 1), "wall_s": round(wall_s, 1)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--blocks", type=int, default=12,
                        help="timed blocks (512 steps each)")
    parser.add_argument("--drop", action="append", default=[],
                        choices=DROPPABLE, help="estimator specs to "
                        "remove from the production surface (repeat)")
    parser.add_argument("--bare", action="store_true",
                        help="drop EVERY estimator spec")
    parser.add_argument("--dry", action="store_true",
                        help="tiny CPU smoke run (logic check only)")
    args = parser.parse_args()
    print(json.dumps(measure(blocks=args.blocks, drop=args.drop,
                             bare=args.bare, dry=args.dry)))


if __name__ == "__main__":
    main()
