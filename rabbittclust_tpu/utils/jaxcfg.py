"""JAX runtime configuration: persistent compile cache and device checks.

The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set
(JAX reads the variable itself) and otherwise in the fixed
``<repo>/.cache/jax_cache``; the path is part of the cache key, so it must
not move between runs.  ``configure_jax`` runs once at CLI start for
``--device`` runs and again (as a no-op) inside each device engine.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache", "jax_cache")

_configured = False


def configure_jax() -> None:
    global _configured
    if _configured:
        return
    import jax

    if not os.environ.get(CACHE_ENV):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _configured = True


def check_device_platform() -> None:
    """``--device`` runs on an NVIDIA GPU.  JAX's CPU backend is accepted
    only when ``JAX_PLATFORMS=cpu`` asks for it explicitly (tests and
    rehearsals); anything else raises instead of silently running the
    device engines on the host."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return
    if platform == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return
    raise RuntimeError(
        f"--device needs an NVIDIA GPU, but JAX found platform "
        f"{platform!r}; set JAX_PLATFORMS=cpu to run the device engines on "
        f"the host on purpose")
