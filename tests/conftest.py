"""Test environment: CPU backend with 8 virtual devices.

Mirrors the reference's strategy of validating every accelerated tier against
serial baselines under emulation (QEMU sweeps, reference
``CONTRIBUTING.md:218-244``): here Pallas interpret mode plays the SIMD-tier
role and an 8-device virtual CPU mesh plays the multi-device role.

``SZ_TESTS_GPU=1`` keeps the GPU backend instead, for the tests marked
``gpu`` (run on a card with ``SZ_TESTS_GPU=1 python -m pytest -m gpu tests/``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("SZ_TESTS_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (decided at run time, never
    at import, so every test worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with SZ_TESTS_GPU=1 on a card)")


@pytest.fixture(scope="session")
def rng():
    seed = int(os.environ.get("SZ_TESTS_SEED", "42"))
    return np.random.default_rng(seed)


@pytest.fixture(scope="session")
def iterations():
    """Scale fuzz-test iteration counts (the reference's reproducible-fuzzing
    knob ``SZ_TESTS_MULTIPLIER``, reference ``CONTRIBUTING.md:183-236``).

    The default (0.25) pins the full suite under the 10-minute CI budget on
    the 1-core image: measured 5:18 at 0.25x on an idle host (184 tests,
    round 5 final; 8:39-11:41 under concurrent bench load, 12:34 at 0.5x
    when last swept — ~4-5 min is fixed compile/import cost, fuzz scales
    the rest).
    Nightly/deep runs set ``SZ_TESTS_MULTIPLIER=10`` for the
    reference-depth sweeps."""
    mult = float(os.environ.get("SZ_TESTS_MULTIPLIER", "0.25"))
    return lambda base: max(1, int(base * mult))


def pytest_report_header(config):
    import jax

    from stringzilla_tpu.utils import platform

    return [
        f"jax {jax.__version__} backend={jax.default_backend()} devices={jax.device_count()}",
        f"stringzilla_tpu capabilities: {platform.capabilities()}",
    ]
