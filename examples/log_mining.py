#!/usr/bin/env python
"""Single-string ops over a big buffer: search, counting, transforms.

Mirrors the reference's ``Str``/``File`` workflow — a memory-mapped (or
in-memory) buffer whose searches dispatch to the device search passes
above ~1 MiB.

    python examples/log_mining.py [path]
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stringzilla_tpu as sz  # noqa: E402


def main():
    if len(sys.argv) > 1:
        text = sz.File(sys.argv[1])
    else:
        rng = np.random.default_rng(1)
        lines = []
        for i in range(200_000):
            level = (b"INFO", b"WARN", b"ERROR")[int(rng.integers(0, 3))]
            body = bytes(rng.integers(97, 123, 40).astype(np.uint8))
            lines.append(b"2026-08-17T12:00:00 " + level + b" " + body)
        text = sz.Str(b"\n".join(lines))

    print(f"{len(text) / 1e6:.1f} MB buffer")
    print("lines:", text.count(b"\n") + 1)
    print("first ERROR at byte:", text.find(b" ERROR "))
    print("last ERROR at byte:", text.rfind(b" ERROR "))
    print("ERROR count:", text.count(b" ERROR "))
    print("rune count (device validated):", text.utf8_count())

    upper = text.translate(bytes(range(256)).upper())
    print("uppercased head:", bytes(upper[:40]))

    errors = [bytes(line) for line in text.split_iter(b"\n")
              if line.contains(b" ERROR ")]
    print("materialized error lines:", len(errors))


if __name__ == "__main__":
    main()
