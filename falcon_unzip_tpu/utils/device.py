"""The device a measurement ran on, named the same way everywhere.

Every timing this repository prints names its device: JAX's platform,
device kind and count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load).  Measurement scripts call ``require_gpu`` first: a
timing taken without the card is not a device number.
"""
from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of each visible card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    """{platform, kind, count} of JAX's devices (as the driver reads them)."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``describe()`` when JAX's first device is a GPU; raise otherwise."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is on platform "
                           f"{dev['platform']!r}; device timings need the "
                           "card")
    return dev
