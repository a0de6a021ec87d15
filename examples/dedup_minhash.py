#!/usr/bin/env python
"""Near-duplicate detection over a document corpus with MinHash fingerprints.

The reference's flagship batch workflow (``szs.Fingerprints`` +
Jaccard-over-minhash retrieval): fingerprint every document on the GPU,
then find near-duplicate pairs by hashed-band bucketing (classic LSH).

    python examples/dedup_minhash.py [path-to-text-file]

With no argument, generates a synthetic corpus with planted near-dupes.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stringzilla_tpu as sz  # noqa: E402


def load_docs(path: str | None) -> list[bytes]:
    if path:
        data = sz.File(path)
        return [bytes(p) for p in data.splitlines() if len(p) > 40]
    rng = np.random.default_rng(7)
    docs = [bytes(rng.integers(97, 123, 300).astype(np.uint8))
            for _ in range(5000)]
    # plant near-duplicates: 2% mutations of existing docs
    for i in range(0, 1000, 10):
        d = bytearray(docs[i])
        for p in rng.choice(len(d), 6, replace=False):
            d[p] ^= 1
        docs.append(bytes(d))
    return docs


def main():
    from stringzilla_tpu.ops.fingerprints import band_keys

    docs = load_docs(sys.argv[1] if len(sys.argv) > 1 else None)
    n = len(docs)
    print(f"{n} documents")

    # Fingerprints stay ON DEVICE; LSH band keys (16 bands x 8 rows) are
    # folded there too, so the host pulls 4 B/band/doc instead of the full
    # 8 B/dim/doc minhash matrix — 32x less D2H on the hot path.
    engine = sz.Fingerprints(ndim=128)
    h_dev, _ = engine(docs, device_out=True)
    keys = np.asarray(band_keys(h_dev, bands=16))  # (n, 16) u32

    # Bucket per band (vectorized): docs sharing a band key are candidates.
    candidates = set()
    for b in range(keys.shape[1]):
        order = np.argsort(keys[:, b], kind="stable")
        k_sorted = keys[order, b]
        run_starts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
        run_ends = np.r_[run_starts[1:], k_sorted.shape[0]]
        for s, e in zip(run_starts, run_ends):
            if e - s > 1:
                members = np.sort(order[s:e])
                for x in range(len(members)):
                    for y in range(x + 1, len(members)):
                        candidates.add((int(members[x]), int(members[y])))

    # Verify candidates by minhash agreement (Jaccard estimate) — pull only
    # the rows the candidates touch.
    needed = sorted({i for p in candidates for i in p})
    rows = {i: r for i, r in zip(needed, np.asarray(h_dev[np.array(needed)]))}
    dupes = sorted((a, c) for a, c in candidates
                   if float((rows[a] == rows[c]).mean()) > 0.5)
    print(f"{len(dupes)} near-duplicate pairs (est. Jaccard > 0.5)")
    for a, c in dupes[:10]:
        sim = float((rows[a] == rows[c]).mean())
        print(f"  doc {a} ~ doc {c}  (minhash agreement {sim:.2f})")


if __name__ == "__main__":
    main()
