"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on the GPU: ``None`` means
``cuda``, and asking for ``cuda`` on a host without a usable GPU raises
instead of quietly running on the CPU. The CPU is used only when the caller
names it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dynamo_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
