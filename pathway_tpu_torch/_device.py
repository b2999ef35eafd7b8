"""Device policy of the port.

Every entry point takes ``device=``. ``None`` means the card: when CUDA is
missing the entry point raises instead of running quietly on the CPU, so a
measurement can never come from the wrong device. On a CUDA device TF32 is
switched off for matmuls and cuDNN, so f32 products (the KNN scores, the f32
encoder) are true f32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
