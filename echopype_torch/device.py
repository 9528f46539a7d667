"""Device selection for the port.

Every public entry point takes ``device=`` (default ``"cuda"``) and resolves
it here.  There is no silent fall-back: asking for CUDA where
``torch.cuda.is_available()`` is false raises, and the CPU path is taken
only when the caller passes ``device="cpu"``.

TF32 is switched off for matmuls and cuDNN alike: the bin sums are float32
data against 0/1 membership, and TF32 keeps ~3 decimal digits (the TPU's
default bf16 pass cost ~1e-3 dB per bin the same way).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["device_name", "no_tf32", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it cannot run here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the matmuls inside the block, whatever the caller set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def device_name(dev: torch.device) -> str:
    """The card's name for a CUDA device, else "cpu" (an output's
    ``attrs["device"]``)."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
