"""Device-time breakdown of one flagship DMC block, from a profiler trace.

    python benchmarks/trace_flagship.py [--out traces]

Runs the flagship DMC (N=128, 16,384 target / 17,408 max walkers, dt
1e-3, f32, 6 burn-in blocks, then 2 measured blocks of 512 steps)
through ``qmc_exec.dmc.Proc.exec`` with ``profile_dir`` set, so ``Proc``
traces its first measured block; the second runs untraced.  It runs
twice: ``bare``, with no estimators, and ``estimators``, with the
estimator load of ``chip_smoke.py`` (pure 128-bin density, pure 64-mode
S(k), pure ITC of 32 modes x 64 lags, every 8th step).

The trace is reduced (:func:`reduce_trace`) to:

- the traced window, from the first kernel's start to the last one's
  end on the card's stream lines, and that window per step;
- the device busy share (the union of the kernel and copy intervals
  over the window) and the idle share, 1 - busy.  Tracing stretches
  the window: the host launches each step of the loop, and the tracer
  slows the host.  So the untraced block's time per step is reported
  too (between ``Proc``'s block log lines, host fetch included), and
  the idle share with the profiler off is estimated as 1 - (busy time
  per step) / (untraced time per step);
- per kernel name: calls, summed device time, share of the window and
  time per step, beside the output shape of the HLO instruction of that
  name in the compiled block (:func:`fusion_outputs`).  A fusion whose
  output is a ``(B, N, N)`` array writes that array to device memory.

One JSON line per variant, with the 12 longest kernels, goes to
standard output; the full kernel table and the trace go under
``<out>/<variant>/``.  Runs only on a GPU.
"""
import argparse
import glob
import json
import os
import re
import sys
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

#: Lines that a trace viewer derives from the kernel events; they
#: repeat the kernels and are never counted.
DERIVED_LINES = frozenset((
    "XLA Modules", "XLA Ops", "XLA TraceMe", "Steps", "Source code",
    "Framework Name Scope", "Framework Ops", "TensorFlow Name Scope",
    "TensorFlow Ops"))

_FUSION = re.compile(r"^\s*(?:ROOT\s+)?%?(\S+)\s+=\s+(.+?)\s+fusion\(")
_LAYOUT = re.compile(r"\{[^{}]*\}")


def _kernel_key(name: str) -> str:
    """A kernel or HLO instruction name with ``.``/``-`` as ``_``: the
    GPU backend names a fusion's kernel after the instruction this
    way."""
    return re.sub(r"[.\-]", "_", name)


def latest_xplane(profile_dir: str) -> str:
    """The newest ``.xplane.pb`` that ``jax.profiler`` wrote under
    ``profile_dir``."""
    paths = glob.glob(os.path.join(profile_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {profile_dir}")
    return max(paths, key=os.path.getmtime)


def device_events(profile, plane_name: str = "/device:GPU:0",
                  line_prefix: str = "Stream"):
    """``(events, line_names)`` of one device plane of a
    ``jax.profiler.ProfileData``: every event of the lines whose name
    starts with ``line_prefix`` (the GPU's streams), or of every line
    that is not a derived view when none does.  An event is ``(name,
    start_ns, end_ns)``, named by its ``hlo_op`` stat where it has
    one."""
    plane = profile.find_plane_with_name(plane_name)
    if plane is None:
        raise ValueError(f"the trace has no plane {plane_name!r}")
    lines = list(plane.lines)
    chosen = [ln for ln in lines if ln.name.startswith(line_prefix)] or \
        [ln for ln in lines if ln.name not in DERIVED_LINES]
    events = []
    for line in chosen:
        for ev in line.events:
            with warnings.catch_warnings():
                # The stats' binding type predates module names.
                warnings.simplefilter("ignore", DeprecationWarning)
                stats = dict(ev.stats)
            name = str(stats.get("hlo_op") or ev.name)
            events.append((name, ev.start_ns, ev.start_ns + ev.duration_ns))
    return events, [ln.name for ln in chosen]


def union_ns(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def reduce_trace(events, num_steps: int, outputs=None) -> dict:
    """Window, busy and idle share, and the per-kernel table of one
    traced block of ``num_steps`` steps.  ``outputs`` maps kernel keys
    to HLO output shapes (:func:`fusion_outputs`)."""
    if not events:
        raise ValueError("no device events in the traced window")
    outputs = outputs or {}
    start = min(s for _, s, _ in events)
    end = max(e for _, _, e in events)
    window = end - start
    busy = union_ns((s, e) for _, s, e in events)
    per = {}
    for name, s, e in events:
        calls, total = per.get(name, (0, 0.0))
        per[name] = (calls + 1, total + (e - s))
    kernels = [
        {"name": name, "calls": calls, "ms": total / 1e6,
         "share": total / window, "us_per_step": total / 1e3 / num_steps,
         "output": outputs.get(_kernel_key(name))}
        for name, (calls, total) in sorted(per.items(),
                                           key=lambda kv: -kv[1][1])]
    return {"window_ms": window / 1e6,
            "ms_per_step": window / 1e6 / num_steps,
            "busy_share": busy / window, "idle_share": 1.0 - busy / window,
            "num_events": len(events), "kernels": kernels}


def fusion_outputs(hlo_text: str) -> dict:
    """Output shape (layouts dropped) of every fusion instruction of a
    compiled HLO module, keyed by :func:`_kernel_key` of its name."""
    out = {}
    for line in hlo_text.splitlines():
        m = _FUSION.match(line)
        if m:
            out[_kernel_key(m.group(1))] = _LAYOUT.sub("", m.group(2))
    return out


def pair_shaped(outputs: dict, nop: int) -> dict:
    """The fusions among ``outputs`` that write a ``(B, nop, nop)``
    array."""
    pat = re.compile(rf"\[\d+,{nop},{nop}\]")
    return {k: v for k, v in outputs.items() if pat.search(v)}


def run_variant(params: dict, estimators: bool, out_dir: str,
                plane_name: str = "/device:GPU:0",
                line_prefix: str = "Stream") -> dict:
    """One traced flagship-schedule run through ``Proc.exec``, reduced;
    writes the summary to ``<out_dir>/kernels.json`` and returns it."""
    import jax
    from jax.profiler import ProfileData

    sys.path.insert(0, os.path.dirname(HERE))
    from chip_smoke import dmc_proc, exec_fresh

    proc = dmc_proc(**params, estimators=estimators, profile_dir=out_dir)
    result, log = exec_fresh(proc)
    nts = proc.num_time_steps_block
    sampling = proc.sampling
    state = result.state
    dtype = state.pos.dtype
    hlo = sampling._block_fn_measure.lower(
        state, jax.random.PRNGKey(0), sampling._scalars(dtype),
        sampling._cast_params(dtype), nts).compile().as_text()
    outputs = fusion_outputs(hlo)
    events, lines = device_events(
        ProfileData.from_file(latest_xplane(out_dir)), plane_name,
        line_prefix)
    table = reduce_trace(events, nts, outputs)
    nop = proc.model_spec.boson_number
    busy_ms_per_step = table["busy_share"] * table["ms_per_step"]
    ticks = [t for t, _ in log.matching(r"walker-steps/s")]
    untraced = (ticks[1] - ticks[0]) * 1e3 / nts if len(ticks) >= 2 \
        else None
    summary = dict(table, busy_ms_per_step=busy_ms_per_step,
                   untraced_ms_per_step=untraced,
                   idle_share_est_profiler_off=(
                       1.0 - busy_ms_per_step / untraced
                       if untraced else None),
                   lines=lines, walkers=params["target"],
                   max_walkers=params["max_w"], nop=nop,
                   num_time_steps=nts,
                   pair_shaped_fusions=pair_shaped(outputs, nop))
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="traces")
    args = parser.parse_args(argv)

    sys.path.insert(0, os.path.dirname(HERE))
    from chip_smoke import FLAGSHIP
    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache
    from phd_qmclib_tpu.utils.device import card_name_and_power_limit, \
        require_gpu

    card = card_name_and_power_limit("trace_flagship")
    devices = require_gpu("trace_flagship")
    enable_persistent_cache(min_compile_time_secs=0.5)
    params = dict(FLAGSHIP, blocks=2)
    for variant in ("bare", "estimators"):
        out_dir = os.path.abspath(os.path.join(args.out, variant))
        summary = run_variant(params, variant == "estimators", out_dir)
        summary["kernels"] = summary["kernels"][:12]
        print(json.dumps(dict(summary, variant=variant, card=card,
                              device_kind=devices[0].device_kind)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
