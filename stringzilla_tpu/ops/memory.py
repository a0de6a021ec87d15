"""Memory transforms — the reference's ``memory`` domain.

The reference's memory domain is ``sz_copy`` / ``sz_move`` / ``sz_fill`` /
``sz_lookup`` (reference ``include/stringzilla/memory.h:66-153``). The first
three are native XLA copies and fills; ``lookup`` — the 256-byte LUT
transform (21.2 GB/s AVX-512 headline, reference ``README.md:218-237``) — is
one gather from a 256-entry table, which XLA fuses into a single streaming
pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lookup_transform"]


@jax.jit
def _lookup(data, lut):
    return jnp.take(lut, data.astype(jnp.int32), mode="clip")


def lookup_transform(data: jnp.ndarray, lut: np.ndarray) -> jnp.ndarray:
    """Apply a 256-entry byte LUT to a u8 device array of any shape
    (``sz_lookup``, reference ``memory.h:153``). Returns the same shape."""
    return _lookup(data, jnp.asarray(np.asarray(lut, dtype=np.uint8)))
