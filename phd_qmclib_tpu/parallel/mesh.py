"""Device meshes for walker-axis data parallelism.

The mrbp QMC problem has exactly one large axis - the walker ensemble -
so the parallel layout is a 1D mesh with the walker axis sharded across
every device (the JAX analog of the reference's ``numba.prange`` over
walkers, ``qmc_base/jastrow/dmc.py:892``).  Per step, the only
cross-device traffic is the scalar ``psum`` of ensemble energy/weight
for the population controller plus the per-block estimator reductions -
all tiny.  There is no parameter state to shard (the model has O(10)
scalar parameters), so TP/PP/SP/EP axes do not apply; the natural
second axis is a *parameter sweep* axis (independent model specs per
mesh row).
"""
import typing as t

import jax

__all__ = ["make_walker_mesh"]


def make_walker_mesh(num_devices: t.Optional[int] = None,
                     axis_name: str = "walkers") -> jax.sharding.Mesh:
    """A 1D mesh over ``num_devices`` (default: all) local devices."""
    devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, {len(devices)} "
                f"available")
        devices = devices[:num_devices]
    return jax.make_mesh((len(devices),), (axis_name,),
                         devices=devices)
