"""Backend dispatch: one query (``platform.backend``) decides interpret mode
and the device tiers; the compile cache follows JAX_COMPILATION_CACHE_DIR."""

import numpy as np
import pytest

import stringzilla_tpu as sz
from stringzilla_tpu.utils import platform


@pytest.fixture
def as_gpu(monkeypatch):
    """Pretend the backend is a GPU (the device tiers are plain XLA, so they
    also run on the CPU backend)."""
    monkeypatch.setattr(platform, "_FORCED", "gpu")


def test_backend_default_is_cpu_here():
    assert platform.backend() == "cpu"
    assert "pallas-interpret" in platform.capabilities()


def test_reset_capabilities_tiers():
    try:
        sz.reset_capabilities("gpu")
        assert platform.backend() == "gpu"
        assert "pallas-triton" in platform.capabilities()
        sz.reset_capabilities("serial")
        assert platform.backend() == "cpu"
    finally:
        sz.reset_capabilities()
    assert platform.backend() == "cpu"
    with pytest.raises(ValueError):
        sz.reset_capabilities("avx512")


def test_gpu_builds_no_interpreted_kernel(as_gpu, monkeypatch):
    """On a GPU backend every pallas_call is built compiled (never
    interpret=True); captured here without running it."""
    import jax
    import jax.numpy as jnp

    from stringzilla_tpu.ops import myers as M

    seen = []

    def fake_pallas_call(kernel, *, out_shape, interpret=False, **kw):
        seen.append((interpret, kw.get("backend")))
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(M.pl, "pallas_call", fake_pallas_call)
    M._build_kernel.cache_clear()
    try:
        q = jnp.full((32, 2), -1, jnp.int32)
        M.myers_distances(q, jnp.zeros((2, 1), jnp.int32),
                          jnp.zeros((8, 4), jnp.int32),
                          jnp.zeros((1, 4), jnp.int32))
    finally:
        M._build_kernel.cache_clear()
        jax.clear_caches()
    assert seen == [(False, "triton")]


def test_gpu_selects_device_tiers(as_gpu, monkeypatch):
    """On a GPU the Str, hash and intersect device tiers switch on."""
    from stringzilla_tpu.ops import hash_device, intersect as I

    assert sz.Str(b"x" * (1 << 20))._use_device()
    assert not sz.Str(b"x" * 1000)._use_device()

    calls = []
    real = hash_device.hash_batch_device

    def spy(items, seed=0):
        calls.append(len(items))
        return real(items, seed)

    monkeypatch.setattr(hash_device, "hash_batch_device", spy)
    n = I._DEVICE_MIN_ITEMS
    a = [b"k%d" % i for i in range(n)]
    b = [b"k%d" % i for i in range(0, 2 * n, 2)]
    ia, ib = sz.intersect(a, b)
    assert calls, "intersect did not take the device hasher"
    assert [a[i] for i in ia] == [b[j] for j in ib]


def test_cpu_keeps_host_tiers():
    assert not sz.Str(b"x" * (1 << 20))._use_device()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    import jax

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert updates == []  # nothing else is set in code


def test_compile_cache_default_in_checkout(monkeypatch):
    import os

    import jax

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(sz.__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in updates
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
