"""Foundation utility tests (reference pattern:
``/root/reference/tests/test_utils.py``)."""
import pytest

from phd_qmclib_tpu import utils


def test_strict_update():
    base = {"a": 1, "b": 2}
    utils.strict_update(base, {"a": 10})
    assert base == {"a": 10, "b": 2}

    with pytest.raises(KeyError):
        utils.strict_update(dict(base), {"c": 3})

    with pytest.raises(KeyError):
        utils.strict_update(dict(base), {"a": 1}, full=True)

    utils.strict_update(base, {"a": 5, "b": 6}, full=True)
    assert base == {"a": 5, "b": 6}


def test_get_random_rng_seed():
    seeds = {utils.get_random_rng_seed() for _ in range(8)}
    assert len(seeds) > 1
    assert all(0 <= s <= utils.MAX_SEED for s in seeds)


def test_meshes():
    mesh = utils.items_to_mesh([1, 2], ["x", "y"])
    assert len(mesh) == 4 and (2, "y") in mesh

    dict_mesh = utils.mapping_to_mesh({"a": [1, 2], "b": [3]})
    assert dict_mesh == [{"a": 1, "b": 3}, {"a": 2, "b": 3}]


def test_persistent_cache_hygiene(tmp_path):
    """Atomic-write hardening of the JAX compile cache: entry writes
    go through temp+rename (no torn files for killed processes to trip
    over), and startup sweeps remove zero-length entries and temp
    leftovers from crashed runs (a truncated entry hard-aborts XLA's
    deserializer — observed failure mode)."""
    from jax._src import lru_cache as _lru

    from phd_qmclib_tpu.utils import compile_cache

    compile_cache.harden_cache_writes()
    assert getattr(_lru.LRUCache.put, "_atomic_writes", False)

    cache = _lru.LRUCache(str(tmp_path), max_size=-1)
    cache.put("k1", b"payload")
    assert cache.get("k1") == b"payload"
    # Same key again: first write wins, still no temp leftovers.
    cache.put("k1", b"other")
    assert cache.get("k1") == b"payload"
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"k1-cache"}

    # Crash debris: a zero-length entry and an orphaned temp file.
    (tmp_path / "dead-cache").write_bytes(b"")
    (tmp_path / "k2-cache.__tmp.123").write_bytes(b"zz")
    compile_cache._sweep(str(tmp_path))
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"k1-cache"}


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_persistent_cache_location(env_set, tmp_path, monkeypatch):
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's fixed
    ``.jax_cache`` — never a per-process or temporary path."""
    import os

    import jax

    from phd_qmclib_tpu.utils import compile_cache

    if env_set:
        expected = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.abspath(os.path.join(
            os.path.dirname(__file__), os.pardir, ".jax_cache"))
    previous = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_persistent_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
        assert os.path.isdir(expected)
    finally:
        jax.config.update("jax_compilation_cache_dir", previous)
