"""2-D convolution and transposed convolution in NCHW with PyTorch weight
layouts (counterpart of ``burn_depth_tpu/ops/conv.py``: ``conv2d`` and
``conv_transpose2d``).  ``Conv2d`` weights are ``[O, I/g, kh, kw]`` and
``ConvTranspose2d`` weights ``[I, O, kh, kw]`` — both native here, so
checkpoints carry over with no remap.  Only the NCHW parity path is ported;
the NHWC serving variants come with the serving slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    padding=0,
    dilation=1,
    groups: int = 1,
) -> torch.Tensor:
    """``x: [N,C,H,W]``, ``weight: [O,I/g,kh,kw]``."""
    return F.conv2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride=stride, padding=padding, dilation=dilation, groups=groups,
    )


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    padding=0,
) -> torch.Tensor:
    """``x: [N,I,H,W]``, ``weight: [I,O,kh,kw]``."""
    return F.conv_transpose2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride=stride, padding=padding,
    )
