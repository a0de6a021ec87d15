"""DeviceScope — execution placement handle, the counterpart of the reference's
``szs_device_scope_t`` (reference ``c/stringzillas/stringzillas.cuh:276-331``,
Python type ``python/stringzillas.c:198-199``).

The reference's scope is a variant of {default, cpu(cores), gpu(device)}.
Under JAX the axes collapse into one: *which devices participate*. A scope
therefore wraps a ``jax.sharding.Mesh`` (1-D: the GPUs of a host are joined
all to all over NVLink, so the mesh needs no torus shape):

* ``DeviceScope()``                 — all addressable devices, 1-D ``data`` axis
* ``DeviceScope(device_index=k)``   — a single device (``gpu_device=k``)
* ``DeviceScope(mesh=my_mesh)``     — bring-your-own mesh
* ``DeviceScope(cpu_cores=n)``      — accepted for API parity; thread counts are
  meaningless under XLA, so ``n`` picks min(n, device_count) devices instead.

Engines shard the candidate axis of a cross-product over the scope's ``data``
axis (the analog of ``for_n_dynamic`` batch parallelism in the reference's
``cross_in_parallel_``, ``similarities/serial.hpp:3296-3395``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["DeviceScope", "default_device_scope"]


class DeviceScope:
    def __init__(self, cpu_cores: int | None = None, gpu_device: int | None = None,
                 device_index: int | None = None, mesh: Mesh | None = None):
        if mesh is not None:
            self.mesh = mesh
            return
        devices = jax.devices()
        if gpu_device is not None and device_index is None:
            device_index = gpu_device  # API-parity alias
        if device_index is not None:
            devices = [devices[device_index]]
        elif cpu_cores is not None and cpu_cores > 0:
            devices = devices[: min(cpu_cores, len(devices))]
        self.mesh = Mesh(np.asarray(devices), axis_names=("data",))

    @property
    def device_count(self) -> int:
        return int(np.prod(self.mesh.devices.shape))

    @property
    def is_single_device(self) -> bool:
        return self.device_count == 1

    def get_capabilities(self) -> tuple[str, ...]:
        """Analog of ``szs_device_scope_get_capabilities``
        (reference ``stringzillas.h:148``)."""
        from ..utils import platform

        return platform.capabilities() + (f"scope-devices:{self.device_count}",)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DeviceScope(devices={self.device_count})"


_default: DeviceScope | None = None


def default_device_scope() -> DeviceScope:
    global _default
    if _default is None:
        _default = DeviceScope(device_index=0)
    return _default
