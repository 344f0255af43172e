"""Activations (counterpart of ``burn_depth_tpu/ops/activations.py``).

Only the parity forms are ported: exact erf GELU and ReLU.  The ``BDT_GELU``
serving forms and DA3's head-activation table come with later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, torch ``nn.GELU()`` default."""
    return F.gelu(x, approximate="none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)
