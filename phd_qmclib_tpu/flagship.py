"""The flagship configuration and its stored E/N band.

The mrbp model at unit filling (v0=20, r=1, gn=1, rm=0.4, L=N) that
``bench.py``, ``chip_smoke.py``, ``benchmarks/trace_flagship.py`` and
the card tests run.
"""

__all__ = ["ENERGY_BRACKET", "ENERGY_REF", "ENERGY_TOL", "energy_ok",
           "spec"]

#: Stored equilibrated E/N for the flagship configuration (v0=20, gn=1,
#: N=128, 16k walkers, dt=1e-3): the dt-band table in BASELINE.md
#: ("N=128, 16,384 walkers", dt=1e-3 row).  A run's own E/N must land
#: within ``ENERGY_TOL`` of it (covers the residual equilibration
#: transient of a short cold-start run) AND inside the physical bracket
#: (ideal band bottom, VMC variational energy).
ENERGY_REF = 8.41614
ENERGY_TOL = 0.02
ENERGY_BRACKET = (8.0107, 8.5089)


def spec(nop: int = 128, interaction_strength: float = 1.0):
    """The flagship mrbp model with ``nop`` bosons at unit filling."""
    from phd_qmclib_tpu.models import mrbp

    return mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=interaction_strength,
                     boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=0.4)


def energy_ok(e_per_boson: float) -> bool:
    """E/N inside the physical bracket and near the stored band value
    (N=128 only)."""
    lo, hi = ENERGY_BRACKET
    return bool(lo < e_per_boson < hi
                and abs(e_per_boson - ENERGY_REF) < ENERGY_TOL)
