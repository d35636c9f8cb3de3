"""Device handling: the port's entry points run on the card unless the
caller asks for the CPU (``device="cpu"``), and never fall back to it."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Validate an entry point's ``device=`` (default: the card); a CUDA
    device must exist.

    Raises instead of falling back to the CPU: a run that asked for the card
    and silently ran on the host would report host numbers as device ones."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


def require_full_f32(device: torch.device) -> None:
    """Raise if f32 matmuls on `device` may run as TF32.

    The port's f32 products mirror the JAX package's full-f32 ones. TF32 is
    a process-wide choice of the caller (PyTorch's default leaves it off),
    so the library checks it rather than changing it."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "f32 products need full f32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype string -> torch dtype (the compute type)."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute dtype {name!r}")
