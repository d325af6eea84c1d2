"""The accelerator a measurement runs on: a GPU, or a refusal.

Every number a benchmark or smoke run prints names the card it came from,
and a measurement path that finds no GPU fails instead of falling back to
the CPU (``bench.py --cpu`` is the one explicit CPU opt-in).
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "card_line", "device_info"]


def require_gpu():
    """The first JAX device, which must be a GPU; raises otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {dev.platform!r} ({dev.device_kind}); "
            "this measurement runs only on the card")
    return dev


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card (a card may be capped below its maximum power, and
    then runs slower under load, so every number carries this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """The device keys every result line carries."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
