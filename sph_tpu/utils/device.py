"""What a measurement ran on: JAX's view of the device and, on an NVIDIA
card, the name and power limit that `nvidia-smi` reports.  A card set
below its maximum power limit runs slower under load, so every time this
repository prints goes out beside these fields."""

from __future__ import annotations

import subprocess
from typing import Optional


def nvidia_smi_name_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` for each card, one line
    per card, or None where there is no such tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def require_gpu() -> None:
    """Exit unless JAX's first device is a GPU: a measurement that fell
    back to the CPU would still print a time."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found platform {platform!r}")


def device_info() -> dict:
    """platform, device_kind and count as JAX reports them, plus the card
    name and power limit (`gpu`) where `nvidia-smi` answers."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "gpu": nvidia_smi_name_power()}
