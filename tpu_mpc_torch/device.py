"""Device selection: the card by default, the CPU only on request."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") -> torch.device.  Raises when CUDA is asked
    for and absent: nothing carries on silently on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_mpc_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def to_numpy(t) -> "object":
    """Tensor (any device) or array-like -> numpy array."""
    import numpy as np

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def device_key(device) -> torch.device:
    """The device `device` names, with its index: "cuda" is the current
    card, so that "cuda" and "cuda:0" key one cache entry, not two."""
    dev = device if isinstance(device, torch.device) else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
