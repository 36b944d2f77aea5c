"""The one backend decision: how the Pallas raster kernels run.

- CPU: interpret mode. The kernels run through the Pallas interpreter and
  the Renderer composes the frame eagerly, one jit per stage — the test
  oracle (the reference's "validation layers on a null driver" analog).
- GPU: the kernels are compiled through Pallas' Triton route and the frame
  is one jit.
- Any other platform has no kernel route and raises.
"""

from __future__ import annotations

import jax


def interpret_mode(platform: str | None = None) -> bool:
    """True when the raster kernels must run in the Pallas interpreter
    (CPU), False when they compile for the device (GPU)."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform in ("gpu", "cuda"):
        return False
    raise RuntimeError(
        f"no raster kernel route for the {platform!r} backend: the frame "
        "runs on a CUDA GPU (compiled kernels) or on the CPU (interpret "
        "mode)")
