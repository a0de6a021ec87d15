#!/usr/bin/env python
"""Secondary benchmark suite — one JSON line per metric, mirroring the
reference's ``bench/`` binaries and the BASELINE.md rows:

* ``find``        — first-match substring search GB/s over a 1 GiB corpus
                    (reference ``bench/find.cpp``; AVX-512 baseline 10.6 GB/s)
* ``rfind_byteset`` — last-of-set GB/s (baselines 0.43 / 4.4 GB/s)
* ``lookup``      — 256-LUT transform GB/s (baselines 21.2 / 7.9 GB/s)
* ``fill_random`` — AES-CTR PRNG GB/s (baselines 0.056 / 0.678 GB/s)
* ``hash_tokens`` — sz_hash over ~8-byte words, Mtokens/s (``bench/token.cpp``)
* ``argsort``     — ~1M word argsort seconds (baselines 1.91 / 0.92 s)
* ``nw_proteins`` — NW with 32x32 class costs over ~1K-aa sequences
                    (``bench/similarities.cpp``; baselines 0.452 CPU / 9.02 H100 GCUPS)
* ``levenshtein`` — the headline GCUPS (same as ../bench.py)
* ``wavefront``   — single 100K-pair GCUPS (intra-pair tier)

Every row names the device it ran on; a metric process that finds no GPU
prints an error row instead of a number.

Usage: python benches/bench_all.py [filter-substring]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DURATION = 4.0


def timed(fn, *args):
    """Seconds per call: warm (compile) once, calibrate, then back-to-back
    calls ending in ``block_until_ready`` on the last result."""

    def sync(x):
        if hasattr(x, "block_until_ready"):  # jax array
            x.block_until_ready()

    sync(fn(*args))  # compile/warm
    t0 = time.perf_counter()
    sync(fn(*args))
    per_call = max(time.perf_counter() - t0, 1e-5)
    iters = max(int(DURATION / per_call), 2)
    out = None
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def emit(metric, value, unit, baseline):
    print(json.dumps({"metric": metric, "value": round(value, 3), "unit": unit,
                      "vs_baseline": round(value / baseline, 2),
                      "device": _device()}))


def bench_find(rng):
    import jax
    import jax.numpy as jnp

    from stringzilla_tpu.ops.find import search_positions

    N = 1 << 30
    # generated on device: a 1 GiB host->device copy would dominate set-up
    H = jax.random.randint(jax.random.PRNGKey(42), (N // 128, 128), 97, 123,
                           dtype=jnp.int32).astype(jnp.uint8)
    row, col = (N - 4096) // 128, (N - 4096) % 128
    H = H.at[row, col : col + 5].set(
        jnp.asarray(np.frombuffer(b"XqZwV", np.uint8)))
    H.block_until_ready()
    needle = np.frombuffer(b"XqZwV", np.uint8)
    dt = timed(lambda: search_positions(H, N, "first", needle=needle))
    emit("substring_find", N / dt / 1e9, "GB/s", 10.6)
    from stringzilla_tpu.ops.find import byteset_mask

    ws = byteset_mask(b" \t\n\r\x0b\x0c")
    dt = timed(lambda: search_positions(H, N, "last", byteset_words=ws))
    emit("rfind_byteset", N / dt / 1e9, "GB/s", 0.43)
    nl = byteset_mask(b"\n\r")  # the reference's line-split row
    dt = timed(lambda: search_positions(H, N, "first", byteset_words=nl))
    emit("find_byteset", N / dt / 1e9, "GB/s", 4.08)


def bench_lookup(rng):
    import jax.numpy as jnp

    from stringzilla_tpu.ops.memory import lookup_transform

    import jax

    N = 1 << 30
    data = jax.random.randint(jax.random.PRNGKey(7), (N // 128, 128), 0, 256,
                              dtype=jnp.int32).astype(jnp.uint8)
    data.block_until_ready()
    lut = np.frombuffer(bytes(range(256)).swapcase(), np.uint8)
    dt = timed(lambda: lookup_transform(data, lut))
    emit("lookup_transform", N / dt / 1e9, "GB/s", 21.2)


def bench_fill_random(rng):
    from stringzilla_tpu.ops.hash_device import fill_random_device

    N = 1 << 28
    dt = timed(lambda: fill_random_device(N, 42))
    emit("fill_random", N / dt / 1e9, "GB/s", 0.0562)


def bench_hash_tokens(rng):
    import jax.numpy as jnp

    from stringzilla_tpu.ops.hash_device import hash_tokens_raw
    from stringzilla_tpu.utils import native

    N = 1 << 20
    lens = rng.integers(4, 13, N)
    blob = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data2d, lengths = native.pack_i32(blob, offsets, None, N, 16,
                                      transpose=True, fill=0)
    d, l = jnp.asarray(data2d), jnp.asarray(lengths)
    dt = timed(lambda: hash_tokens_raw(d, l, 0, 1))
    emit("hash_tokens", N / dt / 1e6, "Mtokens/s", 1.0)


def bench_sha256(rng):
    import jax.numpy as jnp

    from stringzilla_tpu.ops import sha256 as S

    N = 1 << 16
    toks = [bytes(rng.integers(0, 256, int(l)).astype(np.uint8))
            for l in rng.integers(4, 48, N)]
    S.sha256_batch(toks)  # end-to-end warm (compiles the lane widths)
    # device-kernel rate on pre-packed single-block words — the same
    # convention as the hash_tokens row (bench/token.cpp analog)
    buf = np.zeros((N, 64), dtype=np.uint8)
    for i, s in enumerate(toks):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
        buf[i, len(s)] = 0x80
    lens = np.array([len(s) for s in toks], dtype=np.int64)
    buf[:, -8:] = (lens * 8).astype(">u8").view(np.uint8).reshape(N, 8)
    words = jnp.asarray(buf.view(">u4").astype(np.uint32)
                        .reshape(N, 1, 16).transpose(1, 2, 0))
    fn = S._jit_batch()
    dt = timed(lambda: fn(words))
    emit("sha256_tokens", N / dt / 1e6, "Mtokens/s", 1.0)


def bench_crypto_e2e(rng):
    """Honest host-bytes-in rows for the hashing pipelines: a tape (blob +
    offsets) of ~8-byte tokens in host memory, digests back in host memory.
    Production tier is the native (AES-NI / SHA-NI) host runtime — hashing
    is compute-light enough that crossing to the device only pays for data
    already resident in HBM (those kernel rates are the ``hash_tokens`` /
    ``sha256_tokens`` rows)."""
    from stringzilla_tpu.ops.sha256 import sha256_batch
    from stringzilla_tpu.ops.tape import Tape

    N = 1 << 20
    lens = rng.integers(4, 13, N)
    blob = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    tape = Tape(data=blob, offsets=offsets)

    from stringzilla_tpu.utils import native

    out = None
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        out = native.hash_tape(blob, offsets, 0)
        best = min(best, time.perf_counter() - t0)
    if out is not None:
        emit("hash_tokens_e2e", N / best / 1e6, "Mtokens/s", 1.0)

    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        dig = sha256_batch(tape)
        best = min(best, time.perf_counter() - t0)
    assert dig.shape == (N, 32)
    emit("sha256_tokens_e2e", N / best / 1e6, "Mtokens/s", 1.0)

    # document scale: 1000 × 100 KB
    M, L = 1000, 100_000
    dblob = rng.integers(0, 256, M * L).astype(np.uint8)
    doffs = (np.arange(M + 1, dtype=np.int64) * L)
    from stringzilla_tpu.utils import native

    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        native.hash_tape(dblob, doffs, 0)
        best = min(best, time.perf_counter() - t0)
    emit("hash_docs_e2e", M * L / best / 1e9, "GB/s", 1.0)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        sha256_batch(Tape(data=dblob, offsets=doffs))
        best = min(best, time.perf_counter() - t0)
    emit("sha256_docs_e2e", M * L / best / 1e9, "GB/s", 1.0)


def bench_segmentation(rng):
    """UAX-29/14 segmentation GB/s on a mostly-ASCII English-like corpus
    (the reference's headline is 10-70× ICU; ICU's band is 0.02-0.3 GB/s,
    reference README.md:24). Baseline = ICU's upper band 0.3 GB/s."""
    from stringzilla_tpu.ops import segment

    words = [b"the", b"of", b"and", b"history", b"information", b"people",
             b"science", "école".encode(), "straße".encode(), "日本".encode()]
    probs = np.array([8, 5, 5, 2, 2, 2, 2, 0.05, 0.05, 0.02])
    probs /= probs.sum()
    idx = rng.choice(len(words), 2_000_000, p=probs)
    parts = []
    for k, i in enumerate(idx):
        parts.append(words[i])
        parts.append(b". " if k % 17 == 16 else b" ")
    corpus = b"".join(parts)
    n = len(corpus)

    # Primary rows: the enumerate/drain contract — what ICU's BreakIterator
    # and the reference's fill-and-drain segmenters are measured under
    # (boundaries classified and counted, no offset-array materialization).
    # The *_export rows additionally materialize every offset as int64 —
    # 3-8 output bytes per input byte, a different (memory-bound) workload.
    for name, fn in [("word_breaks", segment.word_breaks),
                     ("grapheme_breaks", segment.grapheme_breaks),
                     ("sentence_breaks", segment.sentence_breaks),
                     ("line_breaks", segment.line_breaks)]:
        for suffix, kw in [("", {"count_only": True}), ("_export", {})]:
            best = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                fn(corpus, **kw)
                best = min(best, time.perf_counter() - t0)
            emit(name + suffix, n / best / 1e9, "GB/s", 0.3)


def bench_argsort(rng):
    from stringzilla_tpu.ops.sort import argsort_bounds

    # LIKE-FOR-LIKE with the reference row: ~8M English-like words, mean
    # length ~6.5 (BASELINE.md:24, reference README.md:240-263 sorts ~8M
    # words in 1.91s on a full SPR socket / 0.92s on Graviton5). The CI
    # host has ONE vCPU (os.cpu_count()==1) — the native MSD sort's thread
    # fan-out engages on real multi-core hosts (TC_THREADS to override).
    n = 8_000_000
    lens = rng.integers(2, 12, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = rng.integers(97, 123, offsets[-1]).astype(np.uint8)
    t0 = time.perf_counter()
    argsort_bounds(data, offsets[:-1], offsets[1:])
    dt = time.perf_counter() - t0
    # baseline is seconds (lower better) → report speedup as baseline/ours
    print(json.dumps({"metric": "argsort_8M_words", "value": round(dt, 3),
                      "unit": "s", "vs_baseline": round(1.91 / dt, 2)}))


def bench_levenshtein(rng):
    # bench.py runs in its own process; this one must not have started a
    # JAX client first (a client reserves most of the card's memory).
    import subprocess
    env = dict(os.environ, STRINGWARS_DURATION="4")
    out = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                         text=True, env=env, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    print(out.stdout.strip().splitlines()[-1])


def bench_nw_proteins(rng):
    import stringzilla_tpu as sz

    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    b2c = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(aa):
        b2c[ch] = i
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    table = ((table + table.T) // 2).astype(np.int32)
    np.fill_diagonal(table, rng.integers(4, 10, 32))
    eng = sz.NeedlemanWunschScores(byte_to_class=b2c,
                                   class_substitution_costs=table,
                                   open=-5, extend=-5)
    qs = [rng.choice(aa, int(l)).tobytes()
          for l in np.clip(rng.normal(1000, 100, 16).astype(int), 100, 1024)]
    cl = np.clip(rng.normal(1000, 100, 512).astype(int), 100, 1024)
    cs = [rng.choice(aa, int(l)).tobytes() for l in cl]
    ql = np.array([len(q) for q in qs])
    cells = float(np.outer(ql, np.array([len(c) for c in cs])).sum())
    # Tapes built once outside the timed region — the reference's bench also
    # times engine calls over pre-built tape operands (szs engines take
    # sequence/tape objects, python/stringzillas.c:96-101; the device blob
    # mirror is cached on the Tape).
    from stringzilla_tpu.ops.tape import Tape

    qs_t, cs_t = Tape.from_strings(qs), Tape.from_strings(cs)
    dt = timed(lambda: eng(qs_t, cs_t))
    emit("needleman_wunsch_1k_proteins", cells / dt / 1e9, "GCUPS", 0.452)

    sw = sz.SmithWatermanScores(byte_to_class=b2c,
                                class_substitution_costs=table,
                                open=-5, extend=-5)
    dt = timed(lambda: sw(qs_t, cs_t))
    # reference smith_waterman baselines mirror the NW ones (bench/similarities.cpp)
    emit("smith_waterman_1k_proteins", cells / dt / 1e9, "GCUPS", 0.452)

    # Device-tier row: device-resident operands, isolating the DP from the
    # host packing and the result pull that the e2e rows above pay per
    # call. True cells accounting, identical results.
    import jax.numpy as jnp

    from stringzilla_tpu.ops.similarity import (ClassCosts, LinearGaps,
                                                SimilarityConfig, score_batch)

    rows = 1032
    q_ext = np.zeros((rows, len(qs)), np.int32)
    for i, s in enumerate(qs):
        q_ext[1 : len(s) + 1, i] = b2c[np.frombuffer(s, np.uint8)]
    cands = np.zeros((1024, len(cs)), np.int32)
    for i, s in enumerate(cs):
        cands[: len(s), i] = b2c[np.frombuffer(s, np.uint8)]
    kcfg = SimilarityConfig(
        "max", "global", LinearGaps(-5),
        ClassCosts(tuple(range(32)) * 8, tuple(tuple(r) for r in table.tolist())))
    kargs = (jnp.asarray(q_ext), jnp.asarray(ql.reshape(-1, 1).astype(np.int32)),
             jnp.asarray(cands), jnp.asarray(cl.reshape(1, -1).astype(np.int32)),
             kcfg, jnp.asarray(table))
    dt = timed(lambda: score_batch(*kargs))
    emit("needleman_wunsch_kernel_tier", cells / dt / 1e9, "GCUPS", 0.452)


def bench_utf8_host(rng):
    """Host (native C++) tier rows: full case folding + uncased search on an
    English-like corpus with ~0.3% non-ASCII words (the reference's own
    corpus is mostly-ASCII English; README.md:62-97)."""
    from stringzilla_tpu.ops.utf8 import utf8_fold, utf8_uncased_find

    words = [b"the", b"of", b"and", b"to", b"in", b"was", b"history",
             b"information", b"people", b"time", b"government", b"science",
             "école".encode(), "straße".encode()]
    probs = np.array([8, 4, 4, 4, 3, 2, 2, 2, 2, 2, 1, 1, 0.05, 0.05])
    probs /= probs.sum()
    idx = rng.choice(len(words), 6_000_000, p=probs)
    corpus = b" ".join(words[i] for i in idx)
    n = len(corpus)

    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        utf8_fold(corpus)
        best = min(best, time.perf_counter() - t0)
    emit("utf8_fold", n / best / 1e9, "GB/s", 1.3)

    miss = corpus.replace(b"information", b"informatiom") + b" tHeUniqueNdl"
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        r = utf8_uncased_find(miss, "THEUNIQUENDL")
        best = min(best, time.perf_counter() - t0)
    assert r[0] == len(miss) - 12, r
    emit("utf8_uncased_find", len(miss) / best / 1e9, "GB/s", 3.0)

    from stringzilla_tpu.ops.utf8 import utf8_norm

    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        out = utf8_norm(corpus, "NFC")  # quick-check short-circuit path
        best = min(best, time.perf_counter() - t0)
    assert out == corpus
    # no published reference GB/s row for sz_utf8_norm; report vs 1 GB/s
    emit("utf8_norm_nfc_clean", n / best / 1e9, "GB/s", 1.0)


def bench_utf8_count_device(rng):
    """Fused UTF-8 validation + rune count on device (own row; the
    reference's utf8_runes kernels run 1-5 GB/s per core)."""
    import jax.numpy as jnp

    import stringzilla_tpu as sz
    from stringzilla_tpu.ops.utf8_device import _validate_count_raw

    N = 1 << 28
    blob = rng.integers(32, 127, N).astype(np.uint8)
    pos = np.arange(1000, N - 2, 4096)
    blob[pos] = 0xC3
    blob[pos + 1] = 0xA9
    s = sz.Str(blob.tobytes())
    assert s.utf8_valid()
    m = s._device()
    n = len(s)
    dt = timed(lambda: _validate_count_raw(m, n))
    emit("utf8_validate_count_device", N / dt / 1e9, "GB/s", 1.0)


def bench_fingerprints(rng):
    from stringzilla_tpu.models.fingerprints import Fingerprints
    from stringzilla_tpu.ops.fingerprints import band_keys

    docs = [bytes(rng.integers(32, 127, int(rng.integers(60, 180)))
                  .astype(np.uint8)) for _ in range(32768)]
    total = sum(len(d) for d in docs)
    eng = Fingerprints(ndim=256)
    eng(docs[:256])  # compile the bucket specializations
    eng(docs)
    t0 = time.perf_counter()
    h, c = eng(docs)
    dt = time.perf_counter() - t0
    # Baseline 0.993 Ghash/s = the reference's own AVX-512 engine
    # (floating_rolling_hashers<sz_cap_skylake_k>, fingerprints/skylake.hpp)
    # compiled -O3 -march=native and measured on THIS host at THIS exact
    # shape (benches/ref_baseline/fingerprints_baseline.cpp; serial tier
    # reads 0.215, identical checksums). Single-core — the CI host has one;
    # recall@10 parity is tracked separately by recall_fingerprints.py.
    emit("fingerprints_minhash", total * 256 / dt / 1e9, "Ghash/s", 0.993)

    # Device-resident consumer path: hashes stay in HBM, only 4*bands
    # bytes/doc of LSH band keys cross back (32x less D2H than the
    # (hashes, counts) pull above). Baseline = the host-pull row measured
    # seconds ago in this same window, so vs_baseline reads as the speedup
    # of keeping the product on device.
    def device_pipeline():
        dh, dc = eng(docs, device_out=True)
        return np.asarray(band_keys(dh, bands=16))

    device_pipeline()  # warm band_keys compile
    t0 = time.perf_counter()
    keys = device_pipeline()
    dt_dev = time.perf_counter() - t0
    assert keys.shape == (len(docs), 16)
    emit("fingerprints_device_out", total * 256 / dt_dev / 1e9, "Ghash/s",
         total * 256 / dt / 1e9)

    # Device tier: device-resident operands, one dyadic bucket at the bench
    # shape (same convention as the NW device-tier row).
    import jax.numpy as jnp

    from stringzilla_tpu.ops.fingerprints import (DEFAULT_WINDOW_WIDTHS,
                                                  derive_params,
                                                  fingerprint_all_groups,
                                                  pack_limbs)

    doc_len, n_docs = 192, 32768
    lens_np = rng.integers(60, doc_len + 1, n_docs).astype(np.int32)
    docs_np = rng.integers(32, 127, (doc_len, n_docs)).astype(np.uint8)
    widths = DEFAULT_WINDOW_WIDTHS
    params = derive_params(256, widths)
    order = np.argsort([list(widths).index(int(w)) for w in params["width"]],
                       kind="stable")
    group_sizes = tuple(int((params["width"] == w).sum()) for w in widths)
    args = (jnp.asarray(docs_np), jnp.asarray(lens_np.reshape(1, -1)),
            jnp.asarray(np.array(widths, np.int32).reshape(1, -1)),
            group_sizes,
            jnp.asarray(params["mult"][order].astype(np.int32).reshape(-1, 1)),
            jnp.asarray(pack_limbs(params["modulo"][order]).reshape(2, -1, 1)),
            jnp.asarray(pack_limbs(params["fused_disc"][order]).reshape(2, -1, 1)),
            jnp.asarray((1.0 / params["modulo"][order].astype(np.float32))
                        .reshape(-1, 1)))
    dt_k = timed(lambda: fingerprint_all_groups(*args)[0])
    emit("fingerprints_kernel_tier", float(lens_np.sum()) * 256 / dt_k / 1e9,
         "Ghash/s", 0.993)


def bench_serve(rng):
    """Engine calls over the serving socket vs in-process at the same
    shape — the protocol overhead row (VERDICT r3 ask #4b). Two contrasting
    workloads: a device-bound DP engine call (overhead should vanish) and a
    host-native hash batch (overhead is the whole story). vs_baseline is
    the in-process rate measured in the same window."""
    import tempfile

    import stringzilla_tpu as sz
    from stringzilla_tpu.ops.hash import hash_batch
    from stringzilla_tpu.ops.tape import Tape
    from stringzilla_tpu.serve import EngineClient, EngineServer

    sock = os.path.join(tempfile.mkdtemp(), "bench.sock")
    server = EngineServer(sock)
    server.start_background()
    client = EngineClient(sock)

    # --- levenshtein at a bench-like shape: 32 queries x 1024 candidates
    qs = [bytes(rng.integers(97, 123, int(rng.integers(80, 120)))
                .astype(np.uint8)) for _ in range(32)]
    cs = [bytes(rng.integers(97, 123, int(rng.integers(80, 120)))
                .astype(np.uint8)) for _ in range(1024)]
    cells = float(np.outer([len(q) for q in qs], [len(c) for c in cs]).sum())
    eng = sz.LevenshteinDistances()
    eng(qs, cs)  # compile
    t0 = time.perf_counter()
    ref = eng(qs, cs)
    dt_local = time.perf_counter() - t0
    client.call("levenshtein", tapes={"queries": qs, "candidates": cs})  # warm
    t0 = time.perf_counter()
    (wire,) = client.call("levenshtein", tapes={"queries": qs, "candidates": cs})
    dt_wire = time.perf_counter() - t0
    assert np.array_equal(np.asarray(ref), wire)
    emit("serve_levenshtein", cells / dt_wire / 1e9, "GCUPS",
         cells / dt_local / 1e9)

    # --- hash batch: 2^18 ~8-byte tokens (host-native; wire cost dominates)
    N = 1 << 18
    lens = rng.integers(4, 13, N)
    blob = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    tape = Tape(data=blob, offsets=offsets)
    t0 = time.perf_counter()
    local = hash_batch(tape, seed=0)
    dt_local = time.perf_counter() - t0
    client.call("hash", tapes={"texts": tape}, seed=0)  # warm
    t0 = time.perf_counter()
    (wire,) = client.call("hash", tapes={"texts": tape}, seed=0)
    dt_wire = time.perf_counter() - t0
    assert np.array_equal(local, wire)
    emit("serve_hash_tokens", N / dt_wire / 1e6, "Mtokens/s",
         N / dt_local / 1e6)

    client.close()
    server.shutdown()


def bench_wavefront(rng):
    from stringzilla_tpu.ops.wavefront import (levenshtein_long_pair,
                                               wavefront_score)

    m = 100_000
    a = rng.integers(97, 123, m).astype(np.uint8)
    b = a.copy()
    b[rng.choice(m, 500, replace=False)] ^= 1
    dt = timed(lambda: wavefront_score(a, b))
    emit("wavefront_long_pair", m * m / dt / 1e9, "GCUPS", 3.434)

    # Banded tier on the same near-duplicate pair — the tier the engines
    # route unit-cost long pairs to (models/similarities.py). Ukkonen band
    # doubling touches O((m+n)*d) cells, but CUPS accounting stays the full
    # m*n so the row is comparable with the flat one above (reference analog:
    # bounded Levenshtein + the CUDA live-tile walk, cuda.cuh:708-749).
    dt = timed(lambda: levenshtein_long_pair(a, b))
    emit("wavefront_banded_long_pair", m * m / dt / 1e9, "GCUPS", 3.434)


def bench_affine(rng):
    """Affine-gap NW/SW (open != extend → the Gotoh 3-matrix recurrence,
    reference serial.hpp:1091-1386, types.h:767-772) at the protein shape.
    The reference's published GCUPS rows use linear gaps; these rows measure
    what the 3-plane state costs here (theoretical 7-vs-3 diagonal ratio
    ~2.3x, see BENCH_NOTES)."""
    import stringzilla_tpu as sz
    from stringzilla_tpu.ops.tape import Tape

    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    b2c = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(aa):
        b2c[ch] = i
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    table = ((table + table.T) // 2).astype(np.int32)
    np.fill_diagonal(table, rng.integers(4, 10, 32))
    qs = [rng.choice(aa, int(l)).tobytes()
          for l in np.clip(rng.normal(1000, 100, 16).astype(int), 100, 1024)]
    cl = np.clip(rng.normal(1000, 100, 512).astype(int), 100, 1024)
    cs = [rng.choice(aa, int(l)).tobytes() for l in cl]
    ql = np.array([len(q) for q in qs])
    cells = float(np.outer(ql, np.array([len(c) for c in cs])).sum())
    qs_t, cs_t = Tape.from_strings(qs), Tape.from_strings(cs)
    for name, cls in (("needleman_wunsch_affine", sz.NeedlemanWunschScores),
                      ("smith_waterman_affine", sz.SmithWatermanScores)):
        eng = cls(byte_to_class=b2c, class_substitution_costs=table,
                  open=-5, extend=-1)
        dt = timed(lambda: eng(qs_t, cs_t))
        emit(name, cells / dt / 1e9, "GCUPS", 0.452)


def bench_levenshtein_utf8(rng):
    """LevenshteinDistancesUTF8 GCUPS at a mixed-script shape through the
    device decode path (ops/utf8_pack_device.py). CUPS accounting is over
    RUNE cells (the reference's utf8 engines count codepoints too,
    serial.hpp:2800); byte counts are ~1.9x higher at this script mix."""
    import stringzilla_tpu as sz

    # ~100-rune strings mixing 1-byte ASCII, 2-byte Cyrillic, 3-byte CJK
    pools = [np.arange(97, 123), np.arange(0x430, 0x450),
             np.arange(0x4E00, 0x4E60)]

    def mk(count):
        texts, rlens = [], []
        lens = np.clip(rng.normal(100, 12, count).astype(int), 8, 128)
        for l in lens:
            which = rng.integers(0, 3, int(l))
            cps = [int(rng.choice(pools[w])) for w in which]
            texts.append("".join(map(chr, cps)).encode())
            rlens.append(int(l))
        return texts, np.array(rlens)

    qs, qr = mk(64)
    cs, cr = mk(8192)
    cells = float(np.outer(qr, cr).sum())
    eng = sz.LevenshteinDistancesUTF8()
    dt = timed(lambda: eng(qs, cs))
    # baseline: the reference's SPR CPU byte-Levenshtein row (3.434 GCUPS) —
    # it publishes no separate utf8 GCUPS figure.
    emit("levenshtein_utf8_mixed_script", cells / dt / 1e9, "GCUPS", 3.434)


BENCHES = {
    "find": bench_find,
    "lookup": bench_lookup,
    "fill_random": bench_fill_random,
    "hash_tokens": bench_hash_tokens,
    "sha256": bench_sha256,
    "crypto_e2e": bench_crypto_e2e,
    "segmentation": bench_segmentation,
    "argsort": bench_argsort,
    "levenshtein": bench_levenshtein,
    "levenshtein_utf8": bench_levenshtein_utf8,
    "nw_proteins": bench_nw_proteins,
    "affine": bench_affine,
    "fingerprints": bench_fingerprints,
    "serve": bench_serve,
    "utf8_count_device": bench_utf8_count_device,
    "utf8_host": bench_utf8_host,
    "wavefront": bench_wavefront,
}


def main():
    filt = sys.argv[1] if len(sys.argv) > 1 else ""
    if not filt:
        # Full pass: one subprocess per metric, one at a time, so a single
        # failure or OOM cannot take down the suite and exactly one process
        # holds the card. This parent never imports JAX.
        import subprocess

        here = os.path.abspath(__file__)
        for name in BENCHES:
            try:
                proc = subprocess.run([sys.executable, here, name],
                                      capture_output=True, text=True,
                                      timeout=1200)
            except subprocess.TimeoutExpired:
                # A hung metric must not abort the rest of the pass — emit
                # an error row and move on.
                print(json.dumps({"metric": name,
                                  "error": "timeout after 1200s"}),
                      flush=True)
                continue
            rows = [l for l in proc.stdout.splitlines() if l.startswith("{")]
            if rows:
                print("\n".join(rows), flush=True)
            else:
                err = (proc.stderr or "no output").strip().splitlines()
                print(json.dumps({"metric": name, "error": err[-1][:200]}),
                      flush=True)
        return
    rng = np.random.default_rng(42)
    for name, fn in BENCHES.items():
        # Exact key → run just that metric (the full pass spawns each key,
        # and "levenshtein" must not also run "levenshtein_utf8");
        # otherwise substring filter for interactive use.
        skip = (name != filt) if filt in BENCHES else (filt not in name)
        if skip:
            continue
        if name != "levenshtein":  # that one spawns bench.py, which checks
            import jax

            if jax.default_backend() != "gpu":
                print(json.dumps({"metric": name,
                                  "error": f"no GPU: {jax.devices()}"}))
                sys.exit(1)
        try:
            fn(rng)
        except Exception as e:  # keep going; report the failure
            print(json.dumps({"metric": name, "error": str(e)[:200]}))


if __name__ == "__main__":
    main()
