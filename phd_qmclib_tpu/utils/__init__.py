"""Foundation utilities (timezone-aware timestamps, RNG seeding,
parameter-sweep meshes, dict helpers).

JAX counterpart of the reference foundation layer
(``/root/reference/src/phd_qmclib/utils.py``).  The reference's
``CachedProperty``/numba-env machinery has no analog here: JAX functions
are pure and cached by ``jax.jit`` itself.
"""
import importlib
import itertools
import os
import time
import typing as t
from datetime import datetime, timezone

import numpy as np

__all__ = [
    "get_random_rng_seed",
    "items_to_mesh",
    "mapping_to_mesh",
    "now",
    "require",
    "strict_update",
]

#: pip distribution names of the optional packages whose import name
#: differs.
_DISTRIBUTION = {"yaml": "pyyaml"}


def require(module: str, purpose: str):
    """Import an optional package for ``purpose``, or raise an
    ``ImportError`` that names the package to install.

    The compute path (samplers, ``Proc.exec`` without file output)
    needs none of them; HDF5 files, YAML configs, Jinja2 templates and
    the CLI do.
    """
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        dist = _DISTRIBUTION.get(module, module)
        raise ImportError(
            f"{purpose} needs the '{dist}' package, which is not "
            f"installed") from exc

#: Maximum seed value: the reference caps seeds at uint32 range
#: (``/root/reference/src/phd_qmclib/utils.py:250-266``).
MAX_SEED = 2 ** 32 - 1


def now() -> datetime:
    """Current date and time, timezone-aware (UTC offset of the host).

    Reference: ``utils.py:119-127``.
    """
    return datetime.now(timezone.utc).astimezone()


def get_random_rng_seed() -> int:
    """Derive a per-process pseudo-random seed.

    Mixes the process id and the current time (reference
    ``utils.py:250-266`` uses ``pid + time_ms``; here they are hashed
    through ``numpy.random.SeedSequence`` for better avalanche behavior).
    """
    pid = os.getpid()
    time_ns = time.time_ns()
    ss = np.random.SeedSequence([pid, time_ns & MAX_SEED])
    return int(ss.generate_state(1)[0])


def items_to_mesh(*items: t.Sequence) -> t.List[t.Tuple]:
    """Cartesian-product mesh over the given parameter sequences.

    Reference: ``utils.py:173-193``.
    """
    return list(itertools.product(*items))


def mapping_to_mesh(mapping: t.Mapping[str, t.Sequence]) \
        -> t.List[t.Dict[str, t.Any]]:
    """Cartesian-product mesh of dicts from a mapping of sequences.

    Reference: ``utils.py:196-214``.
    """
    keys = list(mapping.keys())
    values_mesh = itertools.product(*(mapping[k] for k in keys))
    return [dict(zip(keys, values)) for values in values_mesh]


def strict_update(base: t.MutableMapping,
                  other: t.Optional[t.Mapping] = None,
                  full: bool = False) -> t.MutableMapping:
    """Update ``base`` with ``other``, accepting only existing keys.

    If ``full`` is true, ``other`` must supply *every* key of ``base``.
    Reference: ``utils.py:284-302``.
    """
    other = {} if other is None else other
    unknown = set(other.keys()) - set(base.keys())
    if unknown:
        raise KeyError(f"unexpected keys: {sorted(unknown)}")
    if full:
        missing = set(base.keys()) - set(other.keys())
        if missing:
            raise KeyError(f"missing keys: {sorted(missing)}")
    base.update(other)
    return base
