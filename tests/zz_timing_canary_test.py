"""Fast-tier timing canary — collected LAST (the ``zz_`` prefix sorts
after every other test module), so the elapsed time it reads covers
the whole session.  See the note in ``tests/conftest.py``."""
import os
import time

import pytest

from phd_qmclib_tpu.utils.compile_cache import cache_dir
from tests.conftest import FAST_TIER_BUDGET_S, FAST_TIER_MIN_TESTS


def test_fast_tier_stays_under_budget(request):
    config = request.config
    session = request.session
    t0 = getattr(config, "_tier_t0", None)
    if t0 is None:  # pragma: no cover
        pytest.skip("no session start time recorded")
    # Only a FULL fast-tier run is under contract: subsets (-k, -m,
    # single files) and the slow tier measure nothing.
    if len(session.items) < FAST_TIER_MIN_TESTS:
        pytest.skip("partial run — the tier budget applies to the "
                    "full fast tier only")
    # The fast tier is the default "-m 'not slow'" (pyproject addopts);
    # anything else (full tier "-m ''", custom subsets) is not under
    # the budget.
    if config.getoption("-m") != "not slow":
        pytest.skip("custom marker expression — not the fast tier")
    load0 = getattr(config, "_tier_load0", float("inf"))
    if load0 > 1.5:
        pytest.skip(f"busy host (load {load0:.1f} at session start) — "
                    f"the budget is a warm, idle-host contract")
    # A host that was idle at start can get contended mid-run (this
    # box shares one core with chip-queue orchestration); the 1-minute
    # load average READ NOW covers the run's tail, and the 5-minute
    # average covers most of the run itself.  The suite alone keeps
    # one core ~100% busy, so "idle" here reads ~1; competing work
    # pushes it toward 2.
    load1, load5 = os.getloadavg()[:2]
    if max(load1, load5) > 1.6:
        pytest.skip(f"host contended during the run (load "
                    f"{load1:.1f}/{load5:.1f}) — the budget is an "
                    f"idle-host contract")
    warm = os.path.isdir(cache_dir())
    if not warm:  # pragma: no cover
        pytest.skip("cold compile cache — first run is not under "
                    "contract")
    elapsed = time.monotonic() - t0
    assert elapsed <= FAST_TIER_BUDGET_S, (
        f"fast tier took {elapsed:.0f}s (> {FAST_TIER_BUDGET_S:.0f}s "
        f"budget) on an idle host with a warm cache — re-tier the "
        f"newest heavy tests to the slow tier (pytest --durations=20 "
        f"shows the offenders)")
