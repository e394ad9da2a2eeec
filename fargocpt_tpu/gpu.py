"""What a measurement on the GPU states about its device.

Every number taken on the card is printed beside the device JAX reports
and the card's name and power limit (a card set below its maximum power
runs slower under load).  A measurement path that finds no GPU refuses to
run; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX found no GPU."""


def require_gpu(device=None):
    """The device to measure on (default ``jax.devices()[0]``); raises
    :class:`NoGPUError` unless it is a GPU."""
    if device is None:
        import jax
        device = jax.devices()[0]
    if device.platform != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's device is {device.platform!r} "
            f"({device.device_kind}); this measurement runs only on a GPU")
    return device


def device_record(devices) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for every card, one per line (read by a child process that does not
    import JAX)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    if res.returncode != 0:
        return f"nvidia-smi failed (rc={res.returncode}): {res.stderr.strip()}"
    return res.stdout.strip()
