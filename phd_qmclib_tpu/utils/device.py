"""The GPU that a measurement or smoke run needs, and the card it ran on.

``bench.py``, ``chip_smoke.py`` and ``benchmarks/trace_flagship.py``
time or check the program on a GPU only: on a host without one they
stop with a message instead of running on the CPU.
"""
import shutil
import subprocess
import sys

__all__ = ["card_name_and_power_limit", "require_gpu"]


def card_name_and_power_limit(prog: str) -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for the first card;
    exits with a message naming ``prog`` when the host has none."""
    if shutil.which("nvidia-smi") is None:
        sys.exit(f"{prog}: no GPU on this host (nvidia-smi not found); "
                 f"this program runs only on a GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        sys.exit(f"{prog}: nvidia-smi found no GPU: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def require_gpu(prog: str) -> list:
    """JAX's devices; exits with a message naming ``prog`` unless they
    are GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"{prog}: JAX found no GPU (platform "
                 f"{devices[0].platform!r}); this program runs only on "
                 f"a GPU")
    return devices
