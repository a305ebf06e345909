"""Smoke run of the VMC/DMC main path on one GPU, or on four.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: walker mesh + sweep mesh

One card, in this order:

1. ``card_tests``: the card-only tests (``tests/test_gpu.py``) in a child
   process, before this process opens the card, so one process holds it
   at a time.  They compare the f32 kernels on the card with an f64 CPU
   evaluation, threefry normals with the CPU, the ITC lag products with
   numpy f64, and the branching comb and the walker histogram bit for
   bit with their plain forms.
2. ``dmc``: the flagship DMC run through ``qmc_exec.dmc.Proc.exec``
   (N=128, 16,384 target / 17,408 max walkers, f32, pure density, pure
   S(k) and pure ITC estimators), checked against the stored E/N band.
3. ``vmc``: N=64, 16,384 chains through ``qmc_exec.vmc.Proc.exec``.

``--multi`` runs only the four-card phases: the flagship physics with
131,072 walkers sharded over four cards against the same ensemble on one
card, and a (2 sweep x 2 walkers) ``SweepProc`` whose rows must match
their standalone two-card runs bit for bit.

A failed check raises, so the script exits non-zero and prints no
result; without a GPU it stops at once.  The last line of standard
output is one JSON object naming the device.
"""
import argparse
import importlib.util
import json
import logging
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: Optional packages whose presence is reported (none is needed here).
OPTIONAL_PACKAGES = ("h5py", "yaml", "jinja2", "click", "mpmath")

#: Flagship ensemble and schedule: 512-step blocks, 6 burn-in blocks
#: (tau ~ 3, the gas equilibrates in tau 3-4), then 2 measured blocks.
FLAGSHIP = dict(nop=128, target=16384, max_w=17408, nts=512, burn=6,
                blocks=2)
#: The walker mesh of ``--multi``: 32,768 target / 34,816 max walkers per
#: card.  More measured blocks than the one-card run, so the two E/N
#: values carry usable error bars.
MULTI_WALKERS = dict(FLAGSHIP, target=131072, max_w=139264, blocks=4)
#: Largest relative deviation of the mean walker count from its target.
WALKER_COUNT_RTOL = 0.05


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def run_card_tests() -> int:
    """The card-only tests in a child process; returns the pass count.

    Only their file is collected: other test modules import the file
    and CLI packages, which a GPU host need not have."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu",
               PHD_QMCLIB_TPU_NATIVE="0")
    cmd = [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-q",
           "-s", "-rA", "-p", "no:cacheprovider"]
    out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=900)
    print(out.stdout[-12000:], flush=True)
    check(out.returncode == 0,
          f"card tests failed (pytest rc {out.returncode}):\n"
          f"{out.stderr[-4000:]}")
    summary = out.stdout.strip().splitlines()[-1]
    passed = re.search(r"(\d+) passed", summary)
    check(passed is not None and not re.search(
        r"skipped|failed|error", summary),
        f"card tests did not all run on the card: {summary!r}")
    return int(passed.group(1))


class _ProcLog(logging.Handler):
    """``Proc.exec`` log records with their arrival times."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((time.perf_counter(), record.getMessage()))

    def __enter__(self):
        from phd_qmclib_tpu.qmc_exec.logging import exec_logger

        exec_logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        from phd_qmclib_tpu.qmc_exec.logging import exec_logger

        exec_logger.removeHandler(self)

    def matching(self, pattern: str):
        return [(t, m) for t, m in self.records if re.search(pattern, m)]


def dmc_proc(*, nop, target, max_w, nts, burn, blocks, seed=1,
             interaction_strength=1.0, estimators=True, itc_lags=64, **kw):
    """A flagship-physics DMC ``Proc``: v0=20, r=1, rm=0.4, L=N,
    dt=1e-3, f32; with ``estimators``, pure 128-bin density, pure
    64-mode S(k) and a pure ITC of production width (32 modes x 64
    lags) measured every 8th step."""
    from phd_qmclib_tpu import flagship
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec

    spec = flagship.spec(nop, interaction_strength)
    est = {}
    if estimators:
        est = dict(
            est_every=8,
            density_spec=dmc_exec.DensityEstSpec(num_bins=128,
                                                 as_pure_est=True),
            ssf_spec=dmc_exec.SSFEstSpec(num_modes=64, as_pure_est=True),
            itc_spec=dmc_exec.ITCEstSpec(num_modes=32, num_lags=itc_lags,
                                         as_pure_est=True))
    return dmc_exec.Proc(
        model_spec=spec, time_step=1e-3, max_num_walkers=max_w,
        target_num_walkers=target, num_walkers_control_factor=0.125,
        rng_seed=seed, num_blocks=blocks, num_time_steps_block=nts,
        burn_in_blocks=burn, dtype="float32", **est, **kw)


def exec_fresh(proc):
    """``proc.exec`` from fresh configurations; returns the result and
    the procedure's log records."""
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec

    pin = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    with _ProcLog() as log:
        result = proc.exec(pin)
    return result, log


def run_dmc(proc) -> dict:
    """``proc.exec`` from fresh configurations, checked by
    :func:`checked_summary`."""
    return checked_summary(proc, *exec_fresh(proc))


def checked_summary(proc, result, log) -> dict:
    """A DMC result checked for finite output, a mean walker count near
    its target and every shard inside (0, cap); returns a summary."""
    import numpy as np

    nop = proc.model_spec.boson_number
    blk = result.data.blocks
    e_per_n = float(blk.energy.mean) / nop
    e_err = float(blk.energy.mean_error) / nop
    check(np.isfinite(e_per_n) and np.isfinite(e_err),
          f"non-finite DMC energy {e_per_n} +- {e_err}")
    check(not log.matching("collapsed"),
          "a shard's walker population collapsed")
    mean_walkers = np.asarray(blk.num_walkers.totals,
                              dtype=np.float64) / proc.num_time_steps_block
    check(np.all(np.abs(mean_walkers / proc.target_num_walkers - 1.0)
                 < WALKER_COUNT_RTOL),
          f"mean walker counts {mean_walkers} stray from the target "
          f"{proc.target_num_walkers}")
    shard_nw = np.atleast_1d(np.asarray(result.state.num_walkers))
    shard_cap = proc.max_num_walkers // shard_nw.size
    check(shard_nw.min() > 0 and shard_nw.max() < shard_cap,
          f"final per-shard walker counts {shard_nw.tolist()} left "
          f"(0, {shard_cap})")
    for name in ("density", "ss_factor"):
        est = getattr(blk, name, None)
        if est is not None:
            check(np.all(np.isfinite(np.asarray(est.mean))),
                  f"non-finite DMC {name}")
    if blk.itc is not None:
        check(np.all(np.isfinite(blk.itc.mean)), "non-finite DMC ITC")
    # Smoke timing of the last measured block: its walker-steps over the
    # time between the last two block log lines of ``Proc.exec``.
    ticks = [t for t, _ in log.matching(r"walker-steps/s")]
    rate = (float(blk.num_walkers.totals[-1]) / (ticks[-1] - ticks[-2])
            if len(ticks) >= 2 else None)
    return {"e_per_n": e_per_n, "e_err": e_err,
            "mean_walkers": mean_walkers.tolist(),
            "final_shard_walkers": shard_nw.tolist(),
            "walker_steps_per_s": rate}


def dmc_phase(params=FLAGSHIP) -> dict:
    """The flagship DMC run, checked against the stored E/N band."""
    from phd_qmclib_tpu import flagship

    out = run_dmc(dmc_proc(**params))
    if params["nop"] == 128:
        check(flagship.energy_ok(out["e_per_n"]),
              f"flagship E/N {out['e_per_n']:.5f} outside "
              f"{flagship.ENERGY_BRACKET} or more than "
              f"{flagship.ENERGY_TOL} from {flagship.ENERGY_REF}")
    return out


def vmc_phase(*, nop=64, chains=16384, nts=512, burn=1, blocks=3,
              seed=1) -> dict:
    """VMC with the 32-mode S(k) through ``qmc_exec.vmc.Proc.exec``."""
    import numpy as np

    from phd_qmclib_tpu import flagship, ideal
    from phd_qmclib_tpu.qmc_exec import vmc as vmc_exec

    spec = flagship.spec(nop)
    proc = vmc_exec.Proc(
        model_spec=spec, move_spread=0.4, rng_seed=seed,
        num_blocks=blocks, num_steps_block=nts, burn_in_blocks=burn,
        num_walkers=chains, dtype="float32",
        ssf_spec=vmc_exec.SSFEstSpec(num_modes=32))
    pin = vmc_exec.ProcInput.from_model_sys_conf_spec(
        vmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    with _ProcLog() as log:
        result = proc.exec(pin)
    blk = result.data.blocks
    e_per_n = float(blk.energy.mean) / nop
    e0 = ideal.eigen_energy(spec.lattice_depth, spec.lattice_ratio)
    check(np.isfinite(e_per_n) and e_per_n > e0,
          f"VMC E/N {e_per_n} not finite or below the ideal band "
          f"bottom {e0}")
    check(np.all(np.isfinite(np.asarray(blk.ss_factor.mean))),
          "non-finite VMC S(k)")
    (_, line), = log.matching(r"Mean acceptance rate")
    accept = float(line.rsplit(":", 1)[1])
    check(0.0 < accept < 1.0, f"VMC acceptance rate {accept}")
    return {"e_per_n": e_per_n, "band_bottom": e0, "accept_rate": accept}


def multi_walker_phase(params=MULTI_WALKERS, num_devices: int = 4) -> dict:
    """The flagship physics sharded over ``num_devices`` cards against
    the same ensemble (same seed, same start) on one card."""
    from phd_qmclib_tpu import flagship

    sharded = run_dmc(dmc_proc(**params, estimators=False,
                               num_mesh_devices=num_devices,
                               rebalance_every=4))
    single = run_dmc(dmc_proc(**params, estimators=False))
    lo, hi = flagship.ENERGY_BRACKET
    for name, out in (("sharded", sharded), ("single", single)):
        check(params["nop"] != 128 or lo < out["e_per_n"] < hi,
              f"{name} E/N {out['e_per_n']:.5f} outside ({lo}, {hi})")
    diff = sharded["e_per_n"] - single["e_per_n"]
    sigma = (sharded["e_err"] ** 2 + single["e_err"] ** 2) ** 0.5
    # Same start, different random streams (the shards fold their own
    # keys): the two means differ by noise only.
    check(abs(diff) <= 3.0 * sigma,
          f"sharded vs single-card E/N differ by {diff:.6f}, more than "
          f"3 combined error bars ({sigma:.6f})")
    return {"sharded": sharded, "single": single, "diff": diff,
            "sigma": sigma}


def multi_sweep_phase(params=FLAGSHIP, devices=None) -> dict:
    """A (2 sweep x 2 walkers) ``SweepProc`` of two flagship-schedule
    rows (gn = 1 and 2); each row passes the checks of
    :func:`checked_summary` and equals its standalone run on a
    two-device walker mesh bit for bit."""
    import jax
    import numpy as np

    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
    from phd_qmclib_tpu.qmc_exec.sweep import SweepProc

    devices = list(devices or jax.devices())[:4]
    mesh = jax.make_mesh((2, 2), ("sweep", "walkers"), devices=devices)
    couplings = (1.0, 2.0)
    procs = tuple(dmc_proc(**params, seed=31 + r, interaction_strength=g)
                  for r, g in enumerate(couplings))
    pins = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), p) for p in procs]
    with _ProcLog() as log:
        fused = SweepProc(procs, mesh=mesh).exec(pins)
    rows = []
    for r, g in enumerate(couplings):
        row = checked_summary(procs[r], fused[r], log)
        alone_proc = dmc_proc(**params, seed=31 + r,
                              interaction_strength=g, num_mesh_devices=2)
        alone, alone_log = exec_fresh(alone_proc)
        checked_summary(alone_proc, alone, alone_log)
        fb, ab = fused[r].data.blocks, alone.data.blocks
        for name, a, b in (
                ("energy", fb.energy.totals, ab.energy.totals),
                ("density", fb.density.totals, ab.density.totals),
                ("itc", fb.itc.lag_sums, ab.itc.lag_sums)):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  f"sweep row {r} {name} differs from its standalone run")
        rows.append(row)
    return {"rows": rows}


def environment_lines(card: str):
    import jax
    import jaxlib

    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache

    present = {m: importlib.util.find_spec(m) is not None
               for m in OPTIONAL_PACKAGES}
    return [f"card: {card}",
            f"jax {jax.__version__}, jaxlib {jaxlib.__version__}",
            f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}",
            f"compile cache: {enable_persistent_cache()}",
            f"optional packages present: {present}"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card phases")
    args = parser.parse_args(argv)

    # The native reblocking library is a build product; the smoke run
    # uses the pure-Python statistics.
    os.environ["PHD_QMCLIB_TPU_NATIVE"] = "0"
    sys.path.insert(0, HERE)
    from phd_qmclib_tpu.utils.device import card_name_and_power_limit, \
        require_gpu

    card = card_name_and_power_limit("chip_smoke")
    if not args.multi:
        n = run_card_tests()
        print(f"phase card_tests: ok ({n} passed)", flush=True)

    devices = require_gpu("chip_smoke")
    for line in environment_lines(card):
        print(line, flush=True)

    if args.multi:
        if len(devices) < 4:
            sys.exit(f"chip_smoke --multi: needs 4 GPUs, found "
                     f"{len(devices)}")
        out = multi_walker_phase()
        for name in ("sharded", "single"):
            r = out[name]
            print(f"phase multi_walkers {name}: E/N = {r['e_per_n']:.6f} "
                  f"+- {r['e_err']:.6f}, mean walkers "
                  f"{r['mean_walkers']}, final shard walkers "
                  f"{r['final_shard_walkers']}; smoke timing (not a "
                  f"benchmark) {r['walker_steps_per_s']:.6g} walker-steps/s "
                  f"over the last block; card: {card}", flush=True)
        print(f"phase multi_walkers: ok (difference {out['diff']:.6f}, "
              f"combined error {out['sigma']:.6f})", flush=True)
        out = multi_sweep_phase()
        for r, row in enumerate(out["rows"]):
            print(f"phase multi_sweep row {r}: E/N = {row['e_per_n']:.6f} "
                  f"+- {row['e_err']:.6f}, mean walkers "
                  f"{row['mean_walkers']}, final shard walkers "
                  f"{row['final_shard_walkers']}", flush=True)
        print("phase multi_sweep: ok (rows bit-identical to their "
              "standalone 2-card runs)", flush=True)
    else:
        out = dmc_phase()
        print(f"phase dmc: ok (E/N = {out['e_per_n']:.6f} +- "
              f"{out['e_err']:.6f}, mean walkers {out['mean_walkers']})",
              flush=True)
        print(f"smoke timing (not a benchmark): "
              f"{out['walker_steps_per_s']:.6g} walker-steps/s over the "
              f"last DMC block, incl. host fetches; card: {card}",
              flush=True)
        out = vmc_phase()
        print(f"phase vmc: ok (E/N = {out['e_per_n']:.6f} above the band "
              f"bottom {out['band_bottom']:.6f}, acceptance "
              f"{out['accept_rate']:.4f})", flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
