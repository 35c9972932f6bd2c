"""Device dispatch for the kernel wrappers.

The one rule of the port: a wrapper given CPU tensors runs its kernel's
plain torch version; given CUDA tensors it launches the hand-written
kernel. Nothing else is allowed — no other device, no mix of devices, and
no fallback from a kernel that fails to build or launch (those raise).
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one CUDA device (launch the kernel),
    False when they all lie on the CPU (run the plain version)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel and no plain version for device {device}")


def check_tensor(
    t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int
) -> None:
    """Raise on a tensor a kernel does not take."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        from airjax_torch._build import error_string

        raise RuntimeError(f"{what}: CUDA error {rc} ({error_string(rc)})")
