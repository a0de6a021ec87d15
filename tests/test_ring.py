"""Cross-chip ring wavefront (ppermute frontier exchange) vs DP oracles on
the virtual multi-device mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from stringzilla_tpu.parallel.ring import ring_wavefront_score

from .oracles import levenshtein, score_linear


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()), axis_names=("data",))


def test_ring_levenshtein(mesh, rng):
    for _ in range(4):
        m = int(rng.integers(1, 500))
        n = int(rng.integers(1, 500))
        a = bytes(rng.integers(97, 101, m).astype(np.uint8))
        b = bytes(rng.integers(97, 101, n).astype(np.uint8))
        assert ring_wavefront_score(a, b, mesh, block_cols=64) == levenshtein(a, b)


def test_ring_scores(mesh, rng):
    a = bytes(rng.integers(97, 101, 200).astype(np.uint8))
    b = bytes(rng.integers(97, 101, 333).astype(np.uint8))
    exp = score_linear(a, b, lambda x, y: 1 if x == y else -1, -2, objective="max")
    got = ring_wavefront_score(a, b, mesh, match=1, mismatch=-1, gap=-2,
                               objective="max", block_cols=64)
    assert got == exp


def test_ring_edges(mesh):
    assert ring_wavefront_score(b"a", b"a", mesh) == 0
    assert ring_wavefront_score(b"", b"xyz", mesh) == 3
    assert ring_wavefront_score(b"xyz", b"", mesh) == 3


def test_ring_affine_global(mesh, rng):
    from .oracles import score_affine

    a = bytes(rng.integers(97, 101, 180).astype(np.uint8))
    b = bytes(rng.integers(97, 101, 290).astype(np.uint8))
    exp = score_affine(a, b, lambda x, y: 2 if x == y else -1, -4, -1,
                       objective="max")
    got = ring_wavefront_score(a, b, mesh, match=2, mismatch=-1, gap=-4,
                               extend=-1, objective="max", block_cols=64)
    assert got == exp
    # min-objective affine distance
    exp2 = score_affine(a, b, lambda x, y: 0 if x == y else 1, 3, 1,
                        objective="min")
    got2 = ring_wavefront_score(a, b, mesh, match=0, mismatch=1, gap=3,
                                extend=1, objective="min", block_cols=64)
    assert got2 == exp2


def test_ring_local(mesh, rng):
    from .oracles import score_affine, score_linear

    a = bytes(rng.integers(97, 101, 150).astype(np.uint8))
    b = bytes(rng.integers(97, 101, 260).astype(np.uint8))
    exp = score_linear(a, b, lambda x, y: 2 if x == y else -1, -2,
                       objective="max", local=True)
    got = ring_wavefront_score(a, b, mesh, match=2, mismatch=-1, gap=-2,
                               objective="max", locality="local", block_cols=64)
    assert got == exp
    exp2 = score_affine(a, b, lambda x, y: 2 if x == y else -1, -3, -1,
                        objective="max", local=True)
    got2 = ring_wavefront_score(a, b, mesh, match=2, mismatch=-1, gap=-3,
                                extend=-1, objective="max", locality="local",
                                block_cols=64)
    assert got2 == exp2


def test_ring_class_costs(mesh, rng):
    from .oracles import score_affine, score_linear

    table = rng.integers(-3, 4, (32, 32)).astype(np.int32)
    np.fill_diagonal(table, 3)
    a = rng.integers(0, 32, 170).astype(np.uint8)
    b = rng.integers(0, 32, 240).astype(np.uint8)
    sub = lambda x, y: int(table[x, y])
    exp = score_linear(bytes(a), bytes(b), sub, -2, objective="max")
    got = ring_wavefront_score(a, b, mesh, gap=-2, objective="max",
                               table=table, block_cols=64)
    assert got == exp
    # class costs + affine together
    exp2 = score_affine(bytes(a), bytes(b), sub, -4, -1, objective="max")
    got2 = ring_wavefront_score(a, b, mesh, gap=-4, extend=-1,
                                objective="max", table=table, block_cols=64)
    assert got2 == exp2


def test_engine_routes_oversize_pairs_to_ring(mesh, rng, monkeypatch):
    """A pair beyond ``RING_MIN_CELLS`` must route to the cross-device ring
    tier under a multi-device scope (thresholds shrunk to keep the test
    fast)."""
    import stringzilla_tpu as sz
    import stringzilla_tpu.models.similarities as sim
    from stringzilla_tpu.ops import wavefront

    monkeypatch.setattr(sim, "_LONG_THRESHOLD", 64)
    monkeypatch.setattr(wavefront, "RING_MIN_CELLS", 128)
    a = bytes(rng.integers(97, 101, 200).astype(np.uint8))
    b = bytes(rng.integers(97, 101, 251).astype(np.uint8))
    scope = sz.DeviceScope(mesh=mesh)
    out = sz.LevenshteinDistances()([a], [b], device=scope)
    assert int(out[0, 0]) == levenshtein(a, b)
