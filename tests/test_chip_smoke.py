"""``chip_smoke.py`` and ``bench.py`` on a host without a GPU, and the
smoke phases at tiny sizes on the CPU (logic only; the real sizes run on
the card)."""
import shutil

import jax
import pytest

import bench
import chip_smoke
from phd_qmclib_tpu.utils import device

# Tiny runs have too few blocks for the reblocking criterion.
pytestmark = pytest.mark.filterwarnings(
    "ignore:the optimum block size criterion:RuntimeWarning")

TINY = dict(nop=8, target=64, max_w=80, nts=16, burn=1, blocks=2,
            itc_lags=2)


def test_chip_smoke_stops_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_refuses_cpu_devices():
    with pytest.raises(SystemExit) as exc:
        device.require_gpu("chip_smoke")
    assert "no GPU" in str(exc.value.code)


def test_bench_refuses_cpu_devices(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert "no GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_dmc_phase_tiny():
    out = chip_smoke.dmc_phase(TINY)
    assert 8.0 < out["e_per_n"] < 9.0
    assert len(out["mean_walkers"]) == TINY["blocks"]


def test_vmc_phase_tiny():
    out = chip_smoke.vmc_phase(nop=8, chains=32, nts=16, burn=1, blocks=2)
    assert out["e_per_n"] > out["band_bottom"]


def test_multi_walker_phase_tiny():
    out = chip_smoke.multi_walker_phase(
        dict(TINY, target=128, max_w=160, blocks=4), num_devices=4)
    assert len(out["sharded"]["final_shard_walkers"]) == 4
    assert len(out["single"]["final_shard_walkers"]) == 1


def test_multi_sweep_phase_tiny():
    out = chip_smoke.multi_sweep_phase(TINY, devices=jax.devices()[:4])
    assert len(out["rows"]) == 2
    assert all(len(row["final_shard_walkers"]) == 2 for row in out["rows"])
