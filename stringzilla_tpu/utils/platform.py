"""Backend detection and the compile cache.

The reference library picks an ISA tier at load time via CPUID/HWCAP probes and a
dispatch table (see reference ``c/stringzilla/dispatch.h:34-109``). Here the
"capability" axis is one query, :func:`backend`, with two answers:

* ``"gpu"`` — compiled kernels: plain XLA everywhere, Pallas kernels through
  the Triton route, and the device tiers of ``Str``, hashing and intersect on;
* ``"cpu"`` — plain XLA on the host, Pallas kernels in interpret mode (the
  test suite's tier, the analog of the reference validating SIMD tiers
  against serial under QEMU, reference ``CONTRIBUTING.md:218-244``).

Interpret mode is chosen only on ``"cpu"``; a GPU never interprets a kernel.
"""

from __future__ import annotations

import os

import jax

_FORCED: str | None = None

#: Compile-cache path used when ``JAX_COMPILATION_CACHE_DIR`` is unset: fixed,
#: inside the checkout (listed in ``.gitignore``), so every process of one
#: checkout shares it and the path — part of the cache key — never moves.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads the
    variable itself) and nothing else is configured here."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_CACHE_DIR


enable_compile_cache()


def backend() -> str:
    """``"gpu"`` on a CUDA device, otherwise ``"cpu"`` (or the tier forced
    by :func:`force_backend`)."""
    if _FORCED is not None:
        return _FORCED
    return "gpu" if jax.default_backend() == "gpu" else "cpu"


def force_backend(name: str | None) -> None:
    """Test hook behind ``sz.reset_capabilities``: ``"cpu"``, ``"gpu"`` or
    ``None`` (detect)."""
    global _FORCED
    if name not in (None, "cpu", "gpu"):
        raise ValueError(f"unknown backend {name!r}")
    _FORCED = name


def capabilities() -> tuple[str, ...]:
    """Introspection analog of ``sz_capabilities_to_string`` (reference
    ``stringzilla.h:742-765``)."""
    caps = ["serial-jnp",
            "pallas-triton" if backend() == "gpu" else "pallas-interpret",
            f"backend:{jax.default_backend()}",
            f"devices:{jax.device_count()}"]
    return tuple(caps)
