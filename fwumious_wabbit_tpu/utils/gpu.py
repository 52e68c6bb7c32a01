"""The accelerator the measurement paths run on: a guard that refuses any
backend but the GPU, and the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load,
so every number is kept beside the limit it was taken at)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one per
    line; a note instead when the tool is absent or fails."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if r.returncode != 0:
        return f"nvidia-smi failed (rc={r.returncode}): {r.stderr.strip()}"
    return r.stdout.strip()


def require_gpu():
    """The JAX devices, if they are GPUs; raises RuntimeError otherwise. A
    measurement that found no card must fail, not fall back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devices[0].platform!r} "
            f"({len(devices)} device(s)); this path measures the card only")
    return devices
