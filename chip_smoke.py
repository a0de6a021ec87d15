#!/usr/bin/env python
"""Smoke test on one GPU: every device path, at real widths, vs its reference.

Run from the repository root:

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases (one card): the ``LevenshteinDistances`` engine at the ``bench.py``
shape (128 x 32768 ~100 B strings) against Wagner-Fischer; NW and SW with
linear and affine gaps on ~1K-aa proteins against the DP oracles; the UTF-8
engine on mixed scripts; one 100K-char pair with K planted substitutions
through the engine's banded tier; fingerprints against the golden vectors;
``Str`` find/rfind/count/translate/byteset on a 64 MiB buffer against the
``bytes`` built-ins; token hashes, SHA-256, ``fill_random`` and UTF-8
validation against their host paths; and the Myers kernel timed against its
plain XLA form. Every comparison is exact. ``--four`` runs the sharded engine
over ``DeviceScope()`` against the one-card result and a 50K-char pair on
the device ring against its planted distance.

Each phase prints a JSON line with its timings; the card's name and power
limit come first; the last line is ``{"ok": true, "device": {...}}``. A
failed check raises (exit code 1). With no GPU the script exits with code 2
and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
SEED = 42

# Shapes: the reference benchmark's where it has one (bench/similarities.cpp
# ~100 B lines and ~1K-aa proteins, bench/fingerprints.cpp docs).
LEV_SHAPE = (128, 32768)  # queries x candidates, ~N(100, 12.5) bytes
PROTEIN_SHAPE = (16, 512, 1000)  # queries x candidates, mean residues
UTF8_SHAPE = (64, 8192)  # queries x candidates, ~100 runes, 4 scripts
LONG_PAIR = (100_000, 500)  # chars, planted substitutions
FP_DOCS = 32768  # 60-180 B docs, 256 dims
STR_BYTES = 64 << 20
TOKENS = 65536
RING_PAIR = (50_000, 200)  # chars, planted substitutions


def report(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(fn, reps=3):
    """(seconds per call after one warm-up call, last result)."""
    out = fn()
    _block(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _block(out)
    return (time.perf_counter() - t0) / reps, out


def _block(x):
    if hasattr(x, "block_until_ready"):
        x.block_until_ready()


def ascii_batch(rng, count, mean=100, cap=128):
    lens = np.clip(rng.normal(mean, mean / 8, count).astype(int), 8, cap)
    return [rng.integers(97, 123, int(n)).astype(np.uint8).tobytes()
            for n in lens]


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def phase_levenshtein(rng):
    import stringzilla_tpu as sz
    from tests.oracles import levenshtein

    nq, nc = LEV_SHAPE
    qs, cs = ascii_batch(rng, nq), ascii_batch(rng, nc)
    eng = sz.LevenshteinDistances()
    cells = float(np.outer([len(q) for q in qs], [len(c) for c in cs]).sum())
    t0 = time.perf_counter()
    out = eng(qs, cs)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng(qs, cs)
    warm = time.perf_counter() - t0
    assert out.shape == (nq, nc)
    for i in rng.choice(nq, 3, replace=False):
        for j in rng.choice(nc, 40, replace=False):
            assert out[i, j] == levenshtein(qs[i], cs[j]), (i, j)
    report("levenshtein_engine", queries=nq, candidates=nc,
           first_call_s=first, warm_call_s=warm, gcups=cells / warm / 1e9,
           checked_pairs=120)


def _protein_setup(rng):
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    b2c = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(aa):
        b2c[ch] = i
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    table = ((table + table.T) // 2).astype(np.int32)
    np.fill_diagonal(table, rng.integers(4, 10, 32))

    nq, nc, mean = PROTEIN_SHAPE

    def proteins(count):
        lens = np.clip(rng.normal(mean, mean / 10, count).astype(int),
                       mean // 10, 1024)
        return [rng.choice(aa, int(n)).tobytes() for n in lens]

    return b2c, table, proteins(nq), proteins(nc)


def phase_alignment(rng):
    import stringzilla_tpu as sz
    from stringzilla_tpu.ops.tape import Tape
    from tests.oracles import score_affine, score_linear

    b2c, table, qs, cs = _protein_setup(rng)
    qt, ct = Tape.from_strings(qs), Tape.from_strings(cs)
    cells = float(np.outer([len(q) for q in qs], [len(c) for c in cs]).sum())

    def sub(x, y):
        return int(table[b2c[x], b2c[y]])

    for name, cls, open_, ext in (("nw_linear", sz.NeedlemanWunschScores, -5, -5),
                                  ("sw_linear", sz.SmithWatermanScores, -5, -5),
                                  ("nw_affine", sz.NeedlemanWunschScores, -11, -1),
                                  ("sw_affine", sz.SmithWatermanScores, -11, -1)):
        eng = cls(byte_to_class=b2c, class_substitution_costs=table,
                  open=open_, extend=ext)
        t0 = time.perf_counter()
        out = eng(qt, ct)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = eng(qt, ct)
        warm = time.perf_counter() - t0
        local = name.startswith("sw")
        shortest = (int(np.argmin([len(q) for q in qs])),
                    int(np.argmin([len(c) for c in cs])))
        for i, j in (shortest, (int(rng.integers(len(qs))),
                                int(rng.integers(len(cs))))):
            if open_ == ext:
                want = score_linear(qs[i], cs[j], sub, open_, "max", local)
            else:
                want = score_affine(qs[i], cs[j], sub, open_, ext, "max", local)
            assert out[i, j] == want, (name, i, j, out[i, j], want)
        report(name, queries=len(qs), candidates=len(cs), first_call_s=first,
               warm_call_s=warm, gcups=cells / warm / 1e9, checked_pairs=2)


def phase_utf8(rng):
    import stringzilla_tpu as sz
    from tests.oracles import levenshtein

    pools = [np.arange(97, 123), np.arange(0x430, 0x450),
             np.arange(0x4E00, 0x4E60), np.arange(0x1F600, 0x1F620)]

    def mk(count):
        out = []
        for n in np.clip(rng.normal(100, 12, count).astype(int), 8, 128):
            which = rng.integers(0, len(pools), int(n))
            out.append("".join(chr(int(rng.choice(pools[w]))) for w in which))
        return out

    nq, nc = UTF8_SHAPE
    qs, cs = mk(nq), mk(nc)
    eng = sz.LevenshteinDistancesUTF8()
    out = eng(qs, cs)
    t0 = time.perf_counter()
    out = eng(qs, cs)
    warm = time.perf_counter() - t0
    cells = float(np.outer([len(q) for q in qs], [len(c) for c in cs]).sum())
    for i in rng.choice(nq, 2, replace=False):
        for j in rng.choice(nc, 20, replace=False):
            want = levenshtein([ord(x) for x in qs[i]], [ord(x) for x in cs[j]])
            assert out[i, j] == want, (i, j)
    report("levenshtein_utf8_engine", queries=nq, candidates=nc,
           warm_call_s=warm, rune_gcups=cells / warm / 1e9, checked_pairs=40)


def planted_pair(rng, n, k):
    """``b`` is ``a`` with ``k`` substitutions to a byte ``a`` never holds,
    so the edit distance is exactly ``k``."""
    a = rng.integers(97, 123, n).astype(np.uint8)
    b = a.copy()
    b[np.sort(rng.choice(n, k, replace=False))] = ord("$")
    return a.tobytes(), b.tobytes()


def phase_long_pair(rng):
    import stringzilla_tpu as sz
    from stringzilla_tpu.ops import wavefront

    n, k = LONG_PAIR
    a, b = planted_pair(rng, n, k)
    flat_calls = []
    real_flat = wavefront.wavefront_score

    def counting_flat(*args, **kw):
        flat_calls.append(1)
        return real_flat(*args, **kw)

    wavefront.wavefront_score = counting_flat
    try:
        eng = sz.LevenshteinDistances()
        t0 = time.perf_counter()
        d = int(eng([a], [b])[0, 0])
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = int(eng([a], [b])[0, 0])
        warm = time.perf_counter() - t0
    finally:
        wavefront.wavefront_score = real_flat
    assert d == k, (d, k)
    assert not flat_calls, "the banded tier fell back to the flat wavefront"
    report("long_pair_banded", chars=n, planted=k, first_call_s=first,
           warm_call_s=warm)


def phase_fingerprints(rng):
    import stringzilla_tpu as sz

    with open(os.path.join(ROOT, "tests", "golden", "fingerprint_vectors.json")) as f:
        cases = json.load(f)
    widths = (3, 4, 5, 7, 9, 11, 15, 31)
    by_key = {}
    for case in cases:
        by_key.setdefault((case["seed"], case["nwidths"]), []).append(case)
    for (seed, nw), group in by_key.items():
        eng = sz.Fingerprints(ndim=64 * nw, window_widths=widths[:nw], seed=seed)
        h, c = eng([bytes(case["doc"]) for case in group])
        for row, case in enumerate(group):
            assert list(map(int, h[row])) == case["hashes"], (seed, nw, row)
            assert list(map(int, c[row])) == case["counts"], (seed, nw, row)
    docs = [rng.integers(32, 127, int(n)).astype(np.uint8).tobytes()
            for n in rng.integers(60, 180, FP_DOCS)]
    eng = sz.Fingerprints(ndim=256)
    eng(docs)
    t0 = time.perf_counter()
    h, _ = eng(docs)
    warm = time.perf_counter() - t0
    assert h.shape == (FP_DOCS, 256)
    total = sum(len(d) for d in docs)
    report("fingerprints", golden_cases=len(cases), docs=FP_DOCS, ndim=256,
           warm_call_s=warm, ghash_per_s=total * 256 / warm / 1e9)


def phase_str(rng):
    import stringzilla_tpu as sz

    n = STR_BYTES
    buf = rng.integers(97, 123, n).astype(np.uint8)
    for pos in (n // 13, n // 2, n - 100):
        buf[pos:pos + 5] = np.frombuffer(b"XqZwV", np.uint8)
    buf[n // 3] = ord("\n")
    hay = buf.tobytes()
    s = sz.Str(hay)
    assert s._use_device()
    long_needle = hay[n // 4:n // 4 + 40]
    checks = {
        "find": (lambda: s.find(b"XqZwV"), hay.find(b"XqZwV")),
        "rfind": (lambda: s.rfind(b"XqZwV"), hay.rfind(b"XqZwV")),
        "find_long": (lambda: s.find(long_needle), hay.find(long_needle)),
        "count": (lambda: s.count(b"XqZwV", allowoverlap=True),
                  hay.count(b"XqZwV")),
        "find_first_of": (lambda: s.find_first_of(b"\n\r"), hay.find(b"\n")),
        "find_last_of": (lambda: s.find_last_of(b"XV"),
                         max(hay.rfind(b"X"), hay.rfind(b"V"))),
    }
    times = {}
    for name, (fn, want) in checks.items():
        fn()
        t0 = time.perf_counter()
        got = fn()
        times[name] = time.perf_counter() - t0
        assert got == want, (name, got, want)
    lut = bytes(range(256)).swapcase()
    got = bytes(s.translate(lut))
    assert got == hay.translate(lut)
    report("str_64mib", bytes=n, seconds=times)


def phase_hashes(rng):
    import hashlib

    import stringzilla_tpu as sz
    from stringzilla_tpu.ops.hash import fill_random, hash_batch
    from stringzilla_tpu.ops.hash_device import fill_random_device, hash_batch_device
    from stringzilla_tpu.ops.sha256 import sha256_tape
    from stringzilla_tpu.ops.tape import Tape

    toks = [rng.integers(0, 256, int(n)).astype(np.uint8).tobytes()
            for n in rng.integers(0, 48, TOKENS)]
    toks += [rng.integers(0, 256, int(n)).astype(np.uint8).tobytes()
             for n in rng.integers(65, 5000, 256)]
    got = hash_batch_device(toks, 7)
    assert (got == hash_batch(toks, seed=7)).all()
    msgs = [rng.integers(0, 256, int(n)).astype(np.uint8).tobytes()
            for n in rng.integers(0, 300, 4096)]
    dig = sha256_tape(Tape.from_strings(msgs))
    for i, m in enumerate(msgs):
        assert dig[i].tobytes() == hashlib.sha256(m).digest(), i
    for length, nonce in ((1 << 20, 7), (12345, 2**40 + 3)):
        assert bytes(np.asarray(fill_random_device(length, nonce))) == \
            fill_random(length, nonce)
    text = ("ascii and кириллица and 漢字 and 😀 " * (STR_BYTES >> 6)).encode()
    s = sz.Str(text)
    assert s._use_device()
    assert s.utf8_count() == len(text.decode())
    assert s.utf8_valid()
    bad = bytearray(text)
    bad[len(bad) // 2] = 0xFF
    assert not sz.Str(bytes(bad)).utf8_valid()
    report("hashes", tokens=len(toks), sha256_messages=len(msgs),
           utf8_bytes=len(text))


def phase_myers_kernel_vs_xla(rng):
    import jax.numpy as jnp

    from stringzilla_tpu.ops import myers as M

    def batch(count):
        lens = np.clip(rng.normal(100, 12.5, count).astype(np.int32), 8, 128)
        ch = rng.integers(97, 123, size=(128, count), dtype=np.int32)
        return np.where(np.arange(128)[:, None] < lens[None, :], ch, 0), lens

    nq, nc = LEV_SHAPE
    qc, ql = batch(nq)
    q_t = np.where(np.arange(128)[:, None] < ql[None, :], qc, -1)
    cc, cl = batch(nc)
    args = (jnp.asarray(q_t.astype(np.int32)), jnp.asarray(ql.reshape(-1, 1)),
            jnp.asarray(cc), jnp.asarray(cl.reshape(1, -1)))
    cells = float(np.outer(ql.astype(np.int64), cl.astype(np.int64)).sum())
    t_kernel, out_k = timed(lambda: M.myers_kernel(*args), reps=10)
    t_xla, out_x = timed(lambda: M.myers_reference(*args), reps=3)
    assert (np.asarray(out_k) == np.asarray(out_x)).all()

    # End to end: the same engine call with each form behind it.
    import stringzilla_tpu as sz

    qs, cs = ascii_batch(rng, nq), ascii_batch(rng, nc)
    eng = sz.LevenshteinDistances()
    engine_s = {}
    real_use_kernel = M.use_kernel
    try:
        for form, use in (("kernel", real_use_kernel),
                          ("xla", lambda words: False)):
            M.use_kernel = use
            engine_s[form], engine_out = timed(lambda: eng(qs, cs))
            engine_s[form + "_out"] = engine_out
    finally:
        M.use_kernel = real_use_kernel
    assert (engine_s.pop("kernel_out") == engine_s.pop("xla_out")).all()
    report("myers_kernel_vs_xla", queries=nq, candidates=nc,
           kernel_s=t_kernel, xla_s=t_xla,
           kernel_gcups=cells / t_kernel / 1e9, xla_gcups=cells / t_xla / 1e9,
           engine_kernel_s=engine_s["kernel"], engine_xla_s=engine_s["xla"])


# ---------------------------------------------------------------------------
# Four-card phase
# ---------------------------------------------------------------------------


def phase_four(rng):
    import jax

    import stringzilla_tpu as sz
    from stringzilla_tpu.parallel.ring import ring_wavefront_score

    assert len(jax.devices()) == 4, jax.devices()
    qs, cs = ascii_batch(rng, LEV_SHAPE[0]), ascii_batch(rng, LEV_SHAPE[1])
    eng = sz.LevenshteinDistances()
    scope = sz.DeviceScope()
    assert scope.device_count == 4
    sharded = eng(qs, cs, device=scope)
    t0 = time.perf_counter()
    sharded = eng(qs, cs, device=scope)
    t_sharded = time.perf_counter() - t0
    one = eng(qs, cs, device=sz.DeviceScope(device_index=0))
    assert (sharded == one).all()
    n, k = RING_PAIR
    a, b = planted_pair(rng, n, k)
    t0 = time.perf_counter()
    d = ring_wavefront_score(a, b, scope.mesh, block_cols=2048)
    t_ring = time.perf_counter() - t0
    assert d == k, (d, k)
    report("four_cards", sharded_engine_warm_s=t_sharded,
           ring_pair_chars=n, ring_planted=k, ring_first_call_s=t_ring)


def main():
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        sys.exit(2)
    four = "--four" in sys.argv[1:]
    import stringzilla_tpu  # noqa: F401 — fail before printing anything
    import tests.oracles  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(SEED)
    phases = [phase_four] if four else [
        phase_levenshtein, phase_alignment, phase_utf8, phase_long_pair,
        phase_fingerprints, phase_str, phase_hashes, phase_myers_kernel_vs_xla]
    for phase in phases:
        t0 = time.perf_counter()
        phase(rng)
        report(phase.__name__, wall_s=time.perf_counter() - t0)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
