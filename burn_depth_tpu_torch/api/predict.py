"""Preprocessing and the prediction type (counterpart of
``burn_depth_tpu/api/predict.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# ImageNet statistics used by the DINO encoders.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@dataclasses.dataclass
class DepthPrediction:
    depth: torch.Tensor  # [B, H, W] metric depth
    focallength_px: Optional[torch.Tensor] = None  # [B]
    fovy_rad: Optional[torch.Tensor] = None  # [B]

    @property
    def has_intrinsics(self) -> bool:
        return self.focallength_px is not None or self.fovy_rad is not None


def normalize_image(rgb01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an NCHW float image in [0, 1]."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(rgb01.device).reshape(1, 3, 1, 1)
    std = torch.from_numpy(IMAGENET_STD).to(rgb01.device).reshape(1, 3, 1, 1)
    return (rgb01 - mean) / std


def rgb_to_input_tensor(rgb, width: int, height: int, device="cuda") -> torch.Tensor:
    """Packed row-major RGB u8 (bytes or array) → normalized ``[1, 3, H, W]``
    f32 tensor on ``device``.  Raises ``ValueError`` naming both sizes when
    the buffer length is not ``width·height·3``."""
    if isinstance(rgb, (bytes, bytearray)):
        buf = np.frombuffer(rgb, dtype=np.uint8)
    else:
        buf = np.asarray(rgb, dtype=np.uint8).ravel()
    expected = width * height * 3
    if buf.size != expected:
        raise ValueError(f"expected {expected} RGB bytes for {width}x{height}, got {buf.size}")
    hwc = torch.from_numpy(buf.copy()).to(device).reshape(height, width, 3)
    chw = (hwc.float() / 255.0).permute(2, 0, 1)[None]
    return normalize_image(chw)


def infer_from_rgb(model, rgb, width: int, height: int) -> DepthPrediction:
    """Preprocess on the model's device, then ``model.infer_depth``."""
    return model.infer_depth(rgb_to_input_tensor(rgb, width, height, device=model.device))
