"""Linear layer with PyTorch weight layout ``[out, in]`` (counterpart of
``burn_depth_tpu/ops/linear.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))
