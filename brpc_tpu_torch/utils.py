"""Device selection shared by the package's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when no card is visible. An explicit
    device (``"cpu"`` in the tests) is returned as given. There is no
    fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "brpc_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions")
    return dev
