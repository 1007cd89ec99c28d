"""Accelerator discovery and properties.

Role of the reference's utils/device_query.{cu,cuh} (device count, name, SM
count, compute capability — used by the CLI at tools/aligner.c:189-204 and the
worker heuristic at lib/alignment_parameters.h:73-81), expressed in JAX terms:
platform, device kind, device/host counts, and per-device memory stats where
the runtime exposes them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str          # "gpu" / "cpu"
    device_kind: str       # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int       # all devices across hosts
    num_local_devices: int
    num_hosts: int
    hbm_bytes: int | None  # per-device memory limit when known


def query_devices() -> DeviceInfo:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    hbm = None
    try:
        stats = d0.memory_stats()
        if stats:
            hbm = stats.get("bytes_limit")
    except Exception:
        pass
    return DeviceInfo(
        platform=jax.default_backend(),
        device_kind=getattr(d0, "device_kind", str(d0)),
        num_devices=len(devs),
        num_local_devices=len(jax.local_devices()),
        num_hosts=jax.process_count(),
        hbm_bytes=hbm,
    )


def describe() -> str:
    info = query_devices()
    mem = (
        f", {info.hbm_bytes / 2**30:.1f} GiB HBM/device"
        if info.hbm_bytes
        else ""
    )
    return (
        f"{info.num_devices} {info.platform} device(s) "
        f"[{info.device_kind}] on {info.num_hosts} host(s){mem}"
    )
