"""Device policy of the port.

Every entry point takes a ``device`` argument.  The default is the CUDA
card; the CPU is used only when the caller asks for it (``device="cpu"``),
as the CPU tests do.  When no card is present and the CPU was not asked
for, the entry point raises instead of running somewhere else.

Float32 products are kept in full float32 on the card: TF32 keeps about
three decimal digits, and the retrieval scores are compared against the
reference's float32 products.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card; raises when CUDA is missing and the CPU
    was not asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "covins_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def check_cuda(name: str, *tensors: Optional[torch.Tensor]) -> torch.device:
    """Common wrapper check: every tensor on the same CUDA device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is not None and t.device != dev:
            raise RuntimeError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
    return dev


def check_f64(name: str, *named) -> None:
    """Common wrapper check: every (what, tensor, shape) is a contiguous
    float64 tensor of that shape; a None tensor passes."""
    for what, t, shape in named:
        if t is not None and (t.shape != shape or t.dtype != torch.float64
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {shape} float64 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
