"""Dtype policy (counterpart of ``burn_depth_tpu/core/dtypes.py``).

Only the parity form is ported: f32 weights, f32 compute, f32 accumulation —
the numerics the reference's correctness gate is defined on.  The bf16 and
int8 serving policies come with the serving slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.dtype == self.compute_dtype else x.to(self.compute_dtype)

    def cast_f32(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.dtype == torch.float32 else x.float()


PARITY = Policy()
