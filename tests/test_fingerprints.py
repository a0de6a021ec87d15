"""Fingerprints: the device integer-limb form vs exact f64/NumPy oracle vs a
pure-Python-int reimplementation (triple differential)."""

import numpy as np
import pytest

import stringzilla_tpu as szt
from stringzilla_tpu.ops import fingerprints as fp

from . import oracles


def python_int_fingerprint(doc: bytes, params):
    """Third, independent implementation with exact Python integers."""
    ndim = len(params["width"])
    out_h = np.full(ndim, 0xFFFFFFFF, dtype=np.uint32)
    out_c = np.zeros(ndim, dtype=np.uint32)
    for d in range(ndim):
        w = int(params["width"][d])
        mult = int(params["mult"][d])
        m = int(params["modulo"][d])
        if len(doc) < w:
            continue
        state = 0
        for t in range(w):
            state = (state * mult + doc[t] + 1) % m
        minimum, count = state, 1
        disc = pow(mult, w - 1, m)
        for t in range(w, len(doc)):
            state = (state - disc * (doc[t - w] + 1)) % m
            state = (state * mult + doc[t] + 1) % m
            if state < minimum:
                minimum, count = state, 1
            elif state == minimum:
                count += 1
        out_h[d] = np.uint32(minimum & 0xFFFFFFFF)
        out_c[d] = count
    return out_h, out_c


def test_oracle_matches_python_ints(rng):
    params = fp.derive_params(16, (3, 5), seed=42)
    docs = [b"", b"ab", b"abc", b"hello world hello world", bytes(rng.integers(0, 256, 100, dtype=np.uint8))]
    for doc in docs:
        oh, oc = fp.fingerprint_oracle(doc, params)
        ph, pc = python_int_fingerprint(doc, params)
        np.testing.assert_array_equal(oh, ph)
        np.testing.assert_array_equal(oc, pc)


def test_param_derivation_matches_reference_rule():
    # sliced mapping: ndim = 512 over 8 widths → 64 dims per width, blockwise
    p = fp.derive_params(512)
    assert p["width"][0] == 3 and p["width"][63] == 3
    assert p["width"][64] == 4 and p["width"][511] == 31
    # fallback mapping: interleaved
    p = fp.derive_params(10)
    assert list(p["width"][:9]) == [3, 4, 5, 7, 9, 11, 15, 31, 3]
    # multipliers in [256, 640), moduli just below base
    assert (p["mult"] >= 256).all() and (p["mult"] < 640).all()
    assert (p["modulo"] > fp.MODULO_BASE - (1 << 20)).all() and (p["modulo"] <= fp.MODULO_BASE).all()


def test_kernel_matches_oracle(rng):
    engine = szt.Fingerprints(ndim=16, window_widths=(3, 5, 8, 16), seed=7)
    docs = [
        b"",
        b"ab",
        b"abcd",
        b"the quick brown fox jumps over the lazy dog",
        bytes(rng.integers(0, 256, 200, dtype=np.uint8)),
        bytes(rng.integers(97, 123, 333, dtype=np.uint8)),
        b"aaaaaaaaaaaaaaaaaaaaaaaa",  # repeated minimum → count-min exercise
    ]
    got_h, got_c = engine(docs)
    for i, doc in enumerate(docs):
        want_h, want_c = fp.fingerprint_oracle(doc, engine._params)
        np.testing.assert_array_equal(got_h[i], want_h, err_msg=f"doc {i} hashes")
        np.testing.assert_array_equal(got_c[i], want_c, err_msg=f"doc {i} counts")


def test_kernel_default_widths_many_docs(rng):
    engine = szt.Fingerprints(ndim=64, seed=0)
    docs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 120, size=40)]
    got_h, got_c = engine(docs)
    assert got_h.shape == (40, 64) and got_h.dtype == np.uint32
    for i in [0, 7, 19, 39]:
        want_h, want_c = fp.fingerprint_oracle(docs[i], engine._params)
        np.testing.assert_array_equal(got_h[i], want_h)
        np.testing.assert_array_equal(got_c[i], want_c)


def test_minhash_similarity_property(rng):
    """Near-duplicate docs share most min-hashes; unrelated docs don't."""
    engine = szt.Fingerprints(ndim=128, window_widths=(4, 8), seed=1)
    base = bytes(rng.integers(97, 123, 600, dtype=np.uint8))
    near = bytearray(base)
    near[50] = near[50] ^ 1  # single edit
    far = bytes(rng.integers(97, 123, 600, dtype=np.uint8))
    h, _ = engine([base, bytes(near), far])
    sim_near = (h[0] == h[1]).mean()
    sim_far = (h[0] == h[2]).mean()
    assert sim_near > 0.7
    assert sim_far < 0.3


def test_fingerprints_reference_golden_vectors():
    """Bit-identity against vectors generated from the REFERENCE's compiled
    serial engine (floating_rolling_hashers<serial, 64>; generator harness
    documented in tests/golden/fingerprint_vectors.json's commit)."""
    import json
    import os

    from stringzilla_tpu import Fingerprints

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "fingerprint_vectors.json")
    cases = json.load(open(path))
    assert len(cases) >= 30
    widths = (3, 4, 5, 7, 9, 11, 15, 31)
    engines = {}
    for case in cases:
        nw = case["nwidths"]
        key = (case["seed"], nw)
        if key not in engines:
            engines[key] = Fingerprints(ndim=64 * nw,
                                        window_widths=widths[:nw],
                                        seed=case["seed"])
        doc = bytes(case["doc"])
        h, c = engines[key]([doc])
        assert h.shape == (1, 64 * nw)
        assert list(map(int, h[0])) == case["hashes"], (case["seed"], nw, len(doc))
        assert list(map(int, c[0])) == case["counts"], (case["seed"], nw, len(doc))


def test_device_out_and_band_keys(rng):
    """device_out returns the same bits as the host path, without the pull;
    band_keys groups equal band slices and only equal ones (on this corpus)."""
    import numpy as np

    from stringzilla_tpu import Fingerprints
    from stringzilla_tpu.ops.fingerprints import band_keys

    docs = [bytes(rng.integers(97, 123, int(rng.integers(40, 200))).astype(np.uint8))
            for _ in range(37)]
    docs.append(docs[0])  # exact duplicate must share every band bucket
    eng = Fingerprints(ndim=128)
    h_host, c_host = eng(docs)
    h_dev, c_dev = eng(docs, device_out=True)
    np.testing.assert_array_equal(np.asarray(h_dev), h_host)
    np.testing.assert_array_equal(np.asarray(c_dev), c_host)

    keys = np.asarray(band_keys(h_dev, bands=16))
    assert keys.shape == (len(docs), 16) and keys.dtype == np.uint32
    # equal slices -> equal keys (the duplicate), and keys computed on host
    # numpy give the same bits
    np.testing.assert_array_equal(keys[0], keys[-1])
    np.testing.assert_array_equal(keys, np.asarray(band_keys(h_host, bands=16)))
    # distinct docs should (overwhelmingly) not collide in every band
    assert not any((keys[i] == keys[0]).all() for i in range(1, len(docs) - 1))
