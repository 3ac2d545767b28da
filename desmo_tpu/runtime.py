"""Process set-up shared by the CLI, ``bench.py`` and ``chip_smoke.py``: the
persistent compile cache, the accelerator check and the card's identity.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed and inside the checkout: the cache directory is part of what JAX
# keys on, so a path built from a temp name, a pid or the time never hits
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is overridden. Otherwise the cache goes to ``DEFAULT_CACHE_DIR``.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The devices JAX found, or ``RuntimeError`` when the first is not a
    GPU. Measurements and the on-card smoke run never fall back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this program measures the card only"
        )
    return devices


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them, read
    in a child process that does not import JAX. Raises ``RuntimeError`` when
    ``nvidia-smi`` cannot be run."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(
            cmd, capture_output=True, text=True, timeout=60, check=True
        )
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{' '.join(cmd)} failed: {exc}") from exc
    return out.stdout.strip()
