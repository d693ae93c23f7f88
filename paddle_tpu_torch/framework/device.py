"""Device and dtype resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
no ``device`` argument they take ``cuda`` and raise when there is no
card, so a run can never carry on quietly on the CPU. The tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name such as 'bfloat16'."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} (want one of "
                         f"{'/'.join(_DTYPES)})") from None
