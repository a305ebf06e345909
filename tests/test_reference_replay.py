"""Bit-comparable single-walker reference replay (SURVEY hard part 4).

The reference samples with numba's clone of NumPy's legacy MT19937
``RandomState`` (``qmc_base/utils.py:14-21``; numba documents sequence
compatibility with NumPy for the same seed).
:mod:`phd_qmclib_tpu.reference_replay` re-enacts the reference's exact
per-step draw order in pure NumPy; these tests then feed the *identical*
pre-drawn noise into the JAX framework's samplers and assert the
trajectories agree bit-for-bit (positions) / at f64 round-off
(wavefunction, energies, weights), with every discrete decision
(Metropolis accepts, branching tables) matching exactly.

This upgrades the reference-parity gate from statistical
(``tests/samplers/test_distribution.py``) to exact.
"""
import numpy as np
import pytest

from phd_qmclib_tpu import reference_replay as replay
from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import dmc, vmc


@pytest.fixture(scope="module")
def model_spec():
    return mrbp.Spec(lattice_depth=12.0, lattice_ratio=1.0,
                     interaction_strength=4.0, boson_number=16,
                     supercell_size=16.0, tbf_contact_cutoff=0.35)


class TestKernelAgreement:
    """The serial replay kernels and the vectorized framework kernels
    must agree at f64 round-off on arbitrary configurations."""

    def test_wf_and_energy(self, model_spec):
        import jax.numpy as jnp

        kern = replay.MRBPKernels(model_spec)
        funcs = mrbp.core_funcs(model_spec)
        cfc = model_spec.cfc_params
        cfc64 = type(cfc)(*(type(p)(*(np.float64(v) for v in p))
                            for p in cfc))
        rng = np.random.default_rng(8)
        for _ in range(4):
            pos = rng.uniform(0, 16.0, size=16)
            wf_np = kern.wf_abs_log(pos)
            e_np, d_np = kern.energy_and_drift(pos)
            wf_fw, e_fw = (np.float64(x) for x in
                           funcs.log_psi_and_energy(jnp.asarray(pos),
                                                    cfc64))
            e2_fw, d_fw = funcs.energy_and_drift(jnp.asarray(pos), cfc64)
            assert wf_fw == pytest.approx(wf_np, rel=1e-12)
            assert e_fw == pytest.approx(e_np, rel=1e-12)
            assert np.float64(e2_fw) == pytest.approx(e_np, rel=1e-12)
            np.testing.assert_allclose(np.asarray(d_fw), d_np,
                                       rtol=1e-11, atol=1e-11)


class TestVmcReplay:

    @pytest.fixture(scope="class")
    def chains(self, model_spec):
        num_steps = 1500
        rng = np.random.default_rng(3)
        ini_pos = np.sort(rng.uniform(0, 16.0, size=16))

        ref = replay.vmc_replay(model_spec, move_spread=0.25,
                                rng_seed=991, ini_pos=ini_pos,
                                num_steps=num_steps)

        sampling = vmc.Sampling(model_spec, move_spread=0.25,
                                rng_seed=991, num_walkers=1)
        state = sampling.build_state(ini_pos)
        pos, wf, accepted = sampling.replay_chain(
            state, ref.moves_u, ref.accept_u)
        return ref, np.asarray(pos)[:, 0], np.asarray(wf)[:, 0], \
            np.asarray(accepted)[:, 0]

    def test_accept_decisions_identical(self, chains):
        ref, _, _, accepted = chains
        np.testing.assert_array_equal(accepted, ref.accepted)
        # Sanity: the chain actually mixes (not all-accept/all-reject).
        rate = ref.accepted.mean()
        assert 0.05 < rate < 0.95

    def test_positions_bit_exact(self, chains):
        # Given identical accept decisions and identical noise, the
        # position arithmetic (displace + recast) is the same sequence
        # of IEEE operations on both sides.
        ref, pos, _, _ = chains
        np.testing.assert_array_equal(pos, ref.pos[1:])

    def test_wavefunction_at_roundoff(self, chains):
        ref, _, wf, _ = chains
        np.testing.assert_allclose(wf, ref.wf_abs_log[1:], rtol=1e-12,
                                   atol=1e-12)


class TestDmcReplay:

    @pytest.fixture(scope="class")
    def runs(self, model_spec):
        num_steps = 400
        max_w, target = 48, 32
        sampling = dmc.Sampling(model_spec, time_step=5e-4,
                                max_num_walkers=max_w,
                                target_num_walkers=target, rng_seed=7,
                                ref_compat=True)
        rng = np.random.default_rng(12)
        confs = np.stack([model_spec.init_get_sys_conf(rng=rng)
                          for _ in range(target)])
        state = sampling.build_state(confs)

        ref = replay.dmc_replay(
            model_spec, time_step=5e-4, rng_seed=1234,
            ini_pos=np.asarray(state.pos),
            ini_drift=np.asarray(state.drift),
            ini_energies=np.asarray(state.energies),
            ini_weights=np.asarray(state.weights),
            ini_num_walkers=int(np.asarray(state.num_walkers).sum()),
            ini_ref_energy=float(state.ref_energy),
            max_num_walkers=max_w, target_num_walkers=target,
            nwc_factor=float(sampling.num_walkers_control_factor),
            num_steps=num_steps)

        out = sampling.replay_states(state, ref.comb_u,
                                     ref.diffusion_noise)
        return ref, out

    def test_branching_tables_identical(self, runs):
        ref, out = runs
        np.testing.assert_array_equal(np.asarray(out["num_walkers"]),
                                      ref.num_walkers)
        # Parent tables must match on every live slot.
        nts, max_w = ref.cloning_refs.shape
        live = np.arange(max_w)[None, :] < ref.num_walkers[:, None]
        fw_parents = np.asarray(out["parent"])
        np.testing.assert_array_equal(
            np.where(live, fw_parents, 0),
            np.where(live, ref.cloning_refs, 0))
        # The population actually fluctuates (branching is active).
        assert ref.num_walkers.min() != ref.num_walkers.max()

    def test_trajectory_at_roundoff(self, runs):
        ref, out = runs
        nts, max_w = ref.next_energies.shape
        live = np.arange(max_w)[None, :] < ref.num_walkers[:, None]

        pos = np.asarray(out["pos"])
        np.testing.assert_allclose(
            np.where(live[:, :, None], pos, 0.0),
            np.where(live[:, :, None], ref.next_pos, 0.0),
            rtol=0, atol=5e-11)

        energies = np.asarray(out["energies"])
        np.testing.assert_allclose(
            np.where(live, energies, 0.0),
            np.where(live, ref.next_energies, 0.0),
            rtol=1e-9, atol=1e-9)

        weights = np.asarray(out["weights"])
        np.testing.assert_allclose(
            np.where(live, weights, 0.0),
            np.where(live, ref.next_weights, 0.0),
            rtol=1e-10, atol=1e-12)

    def test_controller_at_roundoff(self, runs):
        ref, out = runs
        np.testing.assert_allclose(np.asarray(out["energy"]),
                                   ref.energy, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(out["ref_energy"]),
                                   ref.ref_energy, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(out["accum_energy"]),
                                   ref.accum_energy, rtol=1e-10)


class TestVmcGaussianReplay:
    """The ``vmc_ndf`` (Gaussian-proposal) variant replays bit-exactly
    too (``qmc_base/vmc_ndf.py:43-59``; ``sigma = sqrt(time_step)``,
    ``mrbp_qmc/vmc_ndf.py:38-45``)."""

    def test_trajectory_matches(self, model_spec):
        num_steps = 800
        sigma = float(np.sqrt(1e-3))
        rng = np.random.default_rng(6)
        ini_pos = np.sort(rng.uniform(0, 16.0, size=16))

        ref = replay.vmc_replay(model_spec, move_spread=sigma,
                                rng_seed=313, ini_pos=ini_pos,
                                num_steps=num_steps, gaussian=True)
        sampling = vmc.Sampling(model_spec, move_spread=sigma,
                                rng_seed=313, num_walkers=1,
                                gaussian=True)
        state = sampling.build_state(ini_pos)
        pos, wf, accepted = sampling.replay_chain(
            state, ref.moves_u, ref.accept_u)
        np.testing.assert_array_equal(np.asarray(accepted)[:, 0],
                                      ref.accepted)
        np.testing.assert_array_equal(np.asarray(pos)[:, 0],
                                      ref.pos[1:])
        rate = ref.accepted.mean()
        assert 0.5 < rate < 0.999  # sqrt(dt) moves: high acceptance
