"""Device choice for every entry point of the port.

The port runs on the card: ``device=None`` means CUDA, and without a CUDA
device it raises rather than quietly running on the CPU. The CPU is used
only when the caller asks for it by name (``device="cpu"``), as the tests
do; there every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else is taken as given, and a CUDA device is checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pathway_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def to_device(x, device, dtype=None) -> torch.Tensor:
    """Host data (or a tensor) on ``device``. A host-to-card copy goes
    through pinned memory without blocking, so the host never waits for the
    work already queued on the card."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
