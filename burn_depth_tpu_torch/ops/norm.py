"""LayerNorm (counterpart of ``burn_depth_tpu/ops/norm.py::layer_norm``).

The norm computes in f32 whatever the surrounding dtype and casts back —
the f32 island the parity thresholds rely on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim (torch ``nn.LayerNorm`` semantics)."""
    y = F.layer_norm(
        x.float(),
        (x.shape[-1],),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(),
        eps,
    )
    return y.to(x.dtype)
