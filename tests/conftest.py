"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so kernel
values can be checked against high-precision host references.
Production runs on the GPU use float32 (the kernels are
dtype-polymorphic).  A caller that sets ``JAX_PLATFORMS`` itself (the
card-only tests: ``JAX_PLATFORMS=cuda,cpu python -m pytest
tests/test_gpu.py``) keeps its platform.
"""
import os

# Must be set before JAX initializes its backends.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Build the native reblocking cascade if it is missing or stale, so the
# native path is always exercised (a silently-skipped native test is an
# unverified native path).  Fails loudly if the toolchain is broken.
# PHD_QMCLIB_TPU_NATIVE=0 turns the native path off (stats/native.py),
# and then nothing is built.
def _ensure_native_built():
    import subprocess

    if os.environ.get("PHD_QMCLIB_TPU_NATIVE", "1") == "0":
        return

    root = os.path.join(os.path.dirname(__file__), os.pardir)
    src = os.path.join(root, "csrc", "reblock.cpp")
    out = os.path.join(root, "phd_qmclib_tpu", "_native",
                       "libreblock.so")
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(src):
        return
    subprocess.run(["make", "-C", os.path.join(root, "csrc")],
                   check=True, capture_output=True)


_ensure_native_built()

# Persistent XLA compilation cache: the suite compiles hundreds of
# (mostly identical across runs) CPU executables; caching them on disk
# cuts repeat-run wall time substantially.  The hardened enable makes
# entry writes atomic — a suite run killed mid-write must not leave a
# truncated entry that aborts every later run (observed failure mode;
# see utils/compile_cache.py).
from phd_qmclib_tpu.utils.compile_cache import \
    enable_persistent_cache  # noqa: E402

enable_persistent_cache(min_compile_time_secs=0.2)



@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; a test that asks for it skips on a host
    without one.  Decided when the test runs, never at import, so every
    pytest-xdist worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest tests/test_gpu.py")


@pytest.fixture(scope="session")
def cpu():
    """The host CPU device, where the f64 references run."""
    return jax.devices("cpu")[0]


# Freeze the long-lived startup object graph so the cyclic GC stops
# re-scanning it on every collection (the suite allocates heavily
# while tracing).  Do NOT raise the GC thresholds: jitted functions
# sit in reference cycles, and delaying their collection keeps dead
# executables' mmap'd code sections alive — the per-process mapping
# limit (vm.max_map_count) is the scarce resource here, not RAM.
import gc  # noqa: E402

gc.collect()
gc.freeze()

# ---------------------------------------------------------------------------
# Fast-tier timing canary: the tier's pledge
# is <= FAST_TIER_BUDGET_S warm on this host under light load.  The
# session start time and the pre-session load average are recorded
# here; ``tests/zz_timing_canary_test.py`` (collected last) fails the
# tier when a FULL fast-tier run exceeds the budget on an idle host —
# so a regression trips a test instead of silently eroding the
# contract.  Guards: partial runs (-k/-m subsets, single files), busy
# hosts and cold compile caches skip the check.
# ---------------------------------------------------------------------------
import time as _time  # noqa: E402

FAST_TIER_BUDGET_S = 270.0
FAST_TIER_MIN_TESTS = 400


def pytest_sessionstart(session):
    session.config._tier_t0 = _time.monotonic()
    try:
        session.config._tier_load0 = os.getloadavg()[0]
    except OSError:  # pragma: no cover
        session.config._tier_load0 = float("inf")
