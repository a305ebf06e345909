"""DMC sampler tests.

Follows the reference integration-test pattern (``/root/reference/tests/
mrbp_qmc/test_dmc.py``: VMC chain seeds a DMC ensemble, then drives
blocks/estimators) with numeric assertions: exact ideal-gas limit,
population control, estimator sum rules, branching-comb statistics, and
the variational inequality E_DMC <= E_VMC.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import dmc, vmc

V0, R, GN, NOP, SC_SIZE, RM = 10.0, 1.0, 1.0, 5, 5.0, 0.3
TIME_STEP = 1e-3


def make_spec(**kw):
    base = dict(lattice_depth=V0, lattice_ratio=R, interaction_strength=GN,
                boson_number=NOP, supercell_size=SC_SIZE,
                tbf_contact_cutoff=RM)
    base.update(kw)
    return mrbp.Spec(**base)


def make_confs(spec, num, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(num)])


class TestBranchingComb:

    def test_unit_weights_are_identity(self):
        key = jax.random.PRNGKey(0)
        w = jnp.ones(16)
        parent, nw = dmc.branching_comb(w, jnp.asarray(16), key)
        assert int(nw) == 16
        np.testing.assert_array_equal(np.asarray(parent), np.arange(16))

    @pytest.mark.slow
    def test_expected_clone_count(self):
        # E[floor(w + u)] == w exactly for uniform u.  Use a buffer with
        # ample headroom so the max_num_walkers cap never bites.  All
        # trials run in ONE vmapped dispatch (a per-trial Python loop
        # costs ~5 ms/dispatch on this host).  Slow tier: 2000-trial
        # statistical gate (~15 s on the 1-CPU host); the comb's exact
        # behavior stays fast via the searchsorted-oracle and corner-
        # shape tests.
        w = np.zeros(96)
        w[:32] = np.linspace(0.2, 1.8, 32)
        w = jnp.asarray(w)
        trials = 2000
        us = jax.random.uniform(jax.random.PRNGKey(7), (trials, 96))
        parents, nws = jax.vmap(
            lambda u: dmc.branching_comb(w, jnp.asarray(32), u=u))(us)
        parents, nws = np.asarray(parents), np.asarray(nws)
        live = np.arange(96)[None, :] < nws[:, None]
        sel = np.where(live, parents, 96)  # park dead slots off-range
        counts = np.bincount(sel.ravel(), minlength=97)[:96]
        mean_clones = counts / trials
        np.testing.assert_allclose(mean_clones[:32], np.asarray(w)[:32],
                                   atol=0.12)
        assert counts[32:].sum() == 0

    def test_cap_at_max_num_walkers(self):
        key = jax.random.PRNGKey(1)
        w = jnp.full(8, 3.0)  # wants 24+ clones, only 8 slots
        parent, nw = dmc.branching_comb(w, jnp.asarray(8), key)
        assert int(nw) == 8
        # Children fill in parent order: the first parents get cloned.
        p = np.asarray(parent)
        assert (np.diff(p) >= 0).all() and p[0] == 0

    def test_masked_walkers_never_clone(self):
        key = jax.random.PRNGKey(2)
        w = jnp.full(8, 1.0)
        parent, nw = dmc.branching_comb(w, jnp.asarray(3), key)
        assert int(nw) == 3
        assert np.asarray(parent)[: 3].max() <= 2

    @staticmethod
    def _check_oracle(max_w, num, seed):
        # The defining relation: parent[slot] = #{i : cum[i] <= slot}
        # (searchsorted-right into the clone-count cumsum).
        rng = np.random.default_rng(seed)
        w = rng.uniform(0.0, 2.5, size=max_w)
        u = rng.uniform(0.0, 1.0, size=max_w)
        parent, nw = dmc.branching_comb(
            jnp.asarray(w), jnp.asarray(num), u=jnp.asarray(u))
        n_clones = np.floor(w + u).astype(int)
        n_clones[num:] = 0
        cum = np.cumsum(n_clones)
        expect_nw = min(cum[-1], max_w)
        oracle = np.clip(
            np.searchsorted(cum, np.arange(max_w), side="right"),
            0, max_w - 1)
        assert int(nw) == expect_nw
        np.testing.assert_array_equal(np.asarray(parent), oracle)

    def test_parent_matches_searchsorted_oracle(self):
        # Fast tier: three fixed buffer shapes that pin the corner
        # cases of the factorized marks histogram — tiny (<128),
        # non-multiple-of-128 (exercises the q*128+r factorization
        # padding), and an exact multiple.  The slow tier widens this
        # to a randomized shape sweep.
        self._check_oracle(5, 3, seed=0)
        self._check_oracle(131, 97, seed=1)
        self._check_oracle(256, 200, seed=2)

    @pytest.mark.slow
    def test_parent_matches_searchsorted_oracle_wide(self):
        # Randomized weights/masks/buffer sizes, arbitrary shapes.
        for seed in range(8):
            rng = np.random.default_rng(seed)
            max_w = int(rng.integers(5, 300))
            num = int(rng.integers(1, max_w + 1))
            self._check_oracle(max_w, num, seed=seed + 100)


class TestRobustness:

    def test_build_state_rejects_bad_shapes(self):
        spec = make_spec()
        sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                max_num_walkers=32,
                                target_num_walkers=24, rng_seed=1)
        with pytest.raises(ValueError, match="configuration layout"):
            sampling.build_state(np.zeros((8, NOP + 2)))

    def test_more_confs_than_target_are_truncated(self):
        spec = make_spec()
        sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                max_num_walkers=32,
                                target_num_walkers=24, rng_seed=1)
        state = sampling.build_state(make_confs(spec, 30))
        assert int(np.asarray(state.num_walkers).sum()) == 24

    def test_extreme_interaction_strength_params(self):
        # The brentq two-body matching must stay solvable across the
        # coupling range.
        for gn in (1e-3, 0.1, 10.0, 100.0):
            spec = make_spec(interaction_strength=gn)
            tbf = spec.tbf_params
            assert np.isfinite([tbf.param_k2, tbf.param_beta,
                                tbf.param_r_off, tbf.param_am]).all()
            funcs = mrbp.core_funcs(spec)
            pos = jnp.asarray(np.linspace(0.3, SC_SIZE - 0.7, NOP))
            e = float(funcs.energy(pos, spec.cfc_params))
            assert np.isfinite(e)


class TestIdealGasExactness:

    def test_energy_is_exact_every_step(self):
        spec = make_spec(interaction_strength=0.0)
        e0 = spec.obf_params.param_e0
        sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                max_num_walkers=80, target_num_walkers=64,
                                rng_seed=4)
        state = sampling.build_state(make_confs(spec, 64))
        assert float(state.energy / state.weight) == pytest.approx(
            NOP * e0, rel=1e-10)
        blocks = sampling.blocks(state, num_time_steps_block=32)
        for _ in range(3):
            b = next(blocks)
        e_per_walker = (np.asarray(b.iter_props.energy)
                        / np.asarray(b.iter_props.weight))
        np.testing.assert_allclose(e_per_walker, NOP * e0, rtol=1e-9)
        # The growth estimate converges there too.
        assert float(b.iter_props.accum_energy[-1]) == pytest.approx(
            NOP * e0, rel=1e-9)


class TestPopulationControl:

    @pytest.fixture(scope="class")
    def run(self):
        spec = make_spec()
        sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                max_num_walkers=160,
                                target_num_walkers=128, rng_seed=9)
        state = sampling.build_state(make_confs(spec, 128))
        blocks = sampling.blocks(state, num_time_steps_block=64)
        history = []
        for _ in range(12):
            b = next(blocks)
            history.append(b)
        return sampling, history

    def test_population_stays_near_target(self, run):
        _, history = run
        nw = np.concatenate(
            [np.asarray(b.iter_props.num_walkers) for b in history[2:]])
        assert nw.min() > 0.5 * 128
        assert nw.max() <= 160
        assert abs(nw.mean() - 128) < 16

    def test_energy_below_vmc_variational(self, run):
        sampling, history = run
        spec = sampling.model_spec
        # A VMC run of the same model for the variational bound.
        vs = vmc.Sampling(spec, move_spread=0.25, rng_seed=21,
                          num_walkers=64)
        v_state = vs.build_state(make_confs(spec, 64, seed=3))
        v_blocks = vs.blocks(512, v_state)
        next(v_blocks)  # burn-in
        vb = next(v_blocks)
        e_vmc = float(np.asarray(vb.iter_props.energy).mean()) / NOP

        e_dmc = float(history[-1].iter_props.accum_energy[-1]) / NOP
        e0 = spec.obf_params.param_e0
        # Ground state is bracketed: e0 <= E_DMC <= E_VMC (+3 sigma-ish).
        assert e0 - 0.05 < e_dmc < e_vmc + 0.05

    def test_states_generator_api(self):
        spec = make_spec()
        sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                max_num_walkers=48,
                                target_num_walkers=32, rng_seed=4)
        state = sampling.build_state(make_confs(spec, 32))
        it = sampling.states(state)
        s1 = next(it)
        s2 = next(it)
        assert float(s2.total_weight) > float(s1.total_weight)
        assert not np.allclose(np.asarray(s1.pos), np.asarray(s2.pos))

    def test_reproducible_by_seed(self):
        spec = make_spec()
        outs = []
        for seed in (5, 5, 6):
            sampling = dmc.Sampling(spec, time_step=TIME_STEP,
                                    max_num_walkers=64,
                                    target_num_walkers=48, rng_seed=seed)
            state = sampling.build_state(make_confs(spec, 48))
            b = next(sampling.blocks(state, num_time_steps_block=16))
            outs.append(np.asarray(b.iter_props.energy))
        np.testing.assert_array_equal(outs[0], outs[1])
        assert not np.array_equal(outs[0], outs[2])


class TestEstimators:

    @pytest.fixture(scope="class")
    def sampling_factory(self):
        spec = make_spec()

        def make(density_pure, ssf_pure, pfw=None):
            return spec, dmc.Sampling(
                spec, time_step=TIME_STEP, max_num_walkers=96,
                target_num_walkers=64, rng_seed=17,
                density_est_spec=dmc.DensityEstSpec(
                    num_bins=10, as_pure_est=density_pure,
                    pfw_num_time_steps=pfw),
                ssf_est_spec=dmc.SSFEstSpec(
                    num_modes=4, as_pure_est=ssf_pure,
                    pfw_num_time_steps=pfw))

        return make

    @pytest.mark.parametrize("pure", [False, True])
    def test_density_sum_rule(self, sampling_factory, pure):
        spec, sampling = sampling_factory(pure, pure, pfw=16)
        state = sampling.build_state(make_confs(spec, 64))
        blocks = sampling.blocks(state, num_time_steps_block=32,
                                 burn_in_blocks=1)
        next(blocks)  # burned
        b = next(blocks)
        assert b.iter_density.shape == (32, 10)
        nw = np.asarray(b.iter_props.num_walkers, dtype=np.float64)
        # Every walker deposits N counts; pure estimators divide by the
        # forward-walking window, preserving the per-step sum rule.
        np.testing.assert_allclose(np.asarray(b.iter_density).sum(axis=1),
                                   NOP * nw, rtol=1e-7)

    @pytest.mark.parametrize("pure", [False, True])
    def test_ssf_zero_mode(self, sampling_factory, pure):
        spec, sampling = sampling_factory(pure, pure, pfw=16)
        state = sampling.build_state(make_confs(spec, 64))
        blocks = sampling.blocks(state, num_time_steps_block=32,
                                 burn_in_blocks=1)
        next(blocks)
        b = next(blocks)
        assert b.iter_ssf.shape == (32, 4, 3)
        nw = np.asarray(b.iter_props.num_walkers, dtype=np.float64)
        np.testing.assert_allclose(np.asarray(b.iter_ssf[:, 0, 0]),
                                   NOP ** 2 * nw, rtol=1e-7)
        np.testing.assert_allclose(np.asarray(b.iter_ssf[:, 0, 1]),
                                   NOP * nw, rtol=1e-7)

    def test_burn_in_blocks_skip_estimators(self, sampling_factory):
        spec, sampling = sampling_factory(True, True, pfw=16)
        state = sampling.build_state(make_confs(spec, 64))
        blocks = sampling.blocks(state, num_time_steps_block=8,
                                 burn_in_blocks=1)
        b0 = next(blocks)
        assert b0.iter_density is None and b0.iter_ssf is None
        b1 = next(blocks)
        assert b1.iter_density is not None and b1.iter_ssf is not None

    def test_state_data_blocks(self, sampling_factory):
        spec, sampling = sampling_factory(False, False)
        state = sampling.build_state(make_confs(spec, 64))
        blocks = sampling.state_data_blocks(state,
                                            num_time_steps_block=16,
                                            thin=4)
        ens, block = next(blocks)
        assert ens["pos"].shape == (4, 96, NOP)
        assert ens["energies"].shape == (4, 96)
        assert block.iter_props.energy.shape == (16,)
        assert block.iter_density is None
        # Recorded last ensemble matches the block's final state.
        np.testing.assert_allclose(np.asarray(ens["pos"][-1]),
                                   np.asarray(block.last_state.pos))

    def test_density_concentrates_in_wells(self, sampling_factory):
        # After equilibration the density in the wells (z_cell < 1/2 for
        # r=1) must exceed the density inside the barriers.
        spec, sampling = sampling_factory(False, False)
        state = sampling.build_state(make_confs(spec, 64))
        blocks = sampling.blocks(state, num_time_steps_block=64,
                                 burn_in_blocks=2)
        for _ in range(4):
            b = next(blocks)
        dens = np.asarray(b.iter_density).sum(axis=0)  # (10 bins over L=5)
        # Bins alternate well/barrier halves per unit cell (2 bins/cell).
        wells = dens[0::2].sum()
        barriers = dens[1::2].sum()
        assert wells > 1.5 * barriers
