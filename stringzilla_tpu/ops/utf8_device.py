"""Device-tier UTF-8 structural validation + rune counting.

The reference's rune layer is register-wide lead-byte classification
(``sz_utf8_count``/``sz_utf8_decode``, reference ``utf8_runes.h:34-96``,
per-ISA kernels under ``utf8_runes/``). Here RFC 3629 validity is a *local*
property — every byte's class must agree with the class of the 1-3 bytes
before it — so the whole check is shifted compares over the device mirror,
fused by XLA into one pass ending in two sums:

* structural: continuation bytes exactly where a preceding lead demands;
* range: no C0/C1/F5-FF leads, no overlongs (E0 A0.., F0 90..), no
  surrogates (ED 80-9F), nothing above U+10FFFF (F4 90..);
* truncation: a trailing lead meets the mirror's zero padding, which is
  not a continuation — detected by the same structural check.

Valid buffers have exactly one rune per non-continuation byte, so the
count is a masked popcount in the same pass. Invalid buffers fall back to
the host's exact maximal-subpart (U+FFFD) semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["validate_count_device", "utf8_valid"]


@jax.jit
def _validate_count_jit(mirror, n):
    # Zero bytes after the buffer read as ASCII — the neutral "no lead"
    # context — and give the truncated-trailing-lead check room at n..n+2.
    Y = jnp.concatenate([mirror.reshape(-1).astype(jnp.int32),
                         jnp.zeros((4,), jnp.int32)])
    # classify once into bit flags, then shift the single class array
    CLS = (((Y & 0xC0) == 0x80).astype(jnp.int32)
           | (((Y >= 0xC2) & (Y <= 0xDF)).astype(jnp.int32) << 1)
           | (((Y & 0xF0) == 0xE0).astype(jnp.int32) << 2)
           | (((Y >= 0xF0) & (Y <= 0xF4)).astype(jnp.int32) << 3)
           | ((Y == 0xE0).astype(jnp.int32) << 4)
           | ((Y == 0xED).astype(jnp.int32) << 5)
           | ((Y == 0xF0).astype(jnp.int32) << 6)
           | ((Y == 0xF4).astype(jnp.int32) << 7)
           | ((Y >= 0x80).astype(jnp.int32) << 8))

    def prev(X, k):  # X[p - k], zeros (ASCII) before the buffer
        return jnp.concatenate([jnp.zeros((k,), X.dtype), X[:-k]])

    c0, c1, c2, c3 = CLS, prev(CLS, 1), prev(CLS, 2), prev(CLS, 3)
    pos = jnp.arange(Y.shape[0], dtype=jnp.int32)
    inside = pos < n
    cont_b = (c0 & 1) == 1
    bad_lead = ((c0 >> 8) & 1 & ~(c0 | (c0 >> 1) | (c0 >> 2) | (c0 >> 3))) == 1
    must_cont = (((c1 >> 1) | (c1 >> 2) | (c1 >> 3)
                  | (c2 >> 2) | (c2 >> 3) | (c3 >> 3)) & 1) == 1
    # structure is checked past the end too (a truncated trailing lead)
    struct_bad = (cont_b != must_cont) & (pos < n + 3)
    bad_rng = cont_b & (((((c1 >> 4) & 1) == 1) & (Y < 0xA0))
                        | ((((c1 >> 5) & 1) == 1) & (Y >= 0xA0))
                        | ((((c1 >> 6) & 1) == 1) & (Y < 0x90))
                        | ((((c1 >> 7) & 1) == 1) & (Y >= 0x90)))
    viol = (bad_lead | bad_rng) & inside | struct_bad
    runes = ~cont_b & inside
    return jnp.stack([jnp.sum(viol.astype(jnp.int32)),
                      jnp.sum(runes.astype(jnp.int32))]).reshape(1, 2)


def _validate_count_raw(mirror: jnp.ndarray, n: int) -> jnp.ndarray:
    """Returns the (1, 2) i32 device array ``[[violations, rune_count]]``
    (no host sync — benchable)."""
    return _validate_count_jit(mirror, jnp.int32(n))


def validate_count_device(mirror, n: int):
    """Run the fused validation+count pass on a device mirror; returns
    ``(bool, int)`` after one host pull."""
    out = np.asarray(_validate_count_raw(jnp.asarray(mirror), n))
    return int(out[0, 0]) == 0, int(out[0, 1])


def utf8_valid(data) -> bool:
    """Whether ``data`` is well-formed UTF-8 (RFC 3629). Host tier:
    CPython's decoder; big ``Str`` buffers on a GPU take the device pass."""
    from ..models.str_api import Str
    from .utf8 import _as_bytes

    if isinstance(data, Str) and data._use_device():
        valid, _ = validate_count_device(data._device(), len(data))
        return valid
    buf = _as_bytes(data)
    try:
        buf.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False
