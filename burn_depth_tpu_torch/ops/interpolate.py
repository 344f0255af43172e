"""Bilinear and bicubic resizes as two matmuls (counterpart of
``burn_depth_tpu/ops/interpolate.py``).

The separable ``[out, in]`` sampling matrices are built with the same numpy
formulas as the JAX package, so both packages sample identically at the
borders (``F.interpolate`` clamps differently at the edges and is not used).
Weights are applied in f32 and the result is cast back to the input dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense ``[out_size, in_size]`` row-stochastic bilinear sampling matrix
    with PyTorch ``F.interpolate(mode="bilinear")`` semantics:
    ``align_corners=False`` samples ``src = (o + 0.5)·in/out − 0.5`` with
    index clamping; ``align_corners=True`` samples ``src = o·(in−1)/(out−1)``."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    i0f = np.floor(src)
    frac = src - i0f
    i0 = np.clip(i0f.astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0f.astype(np.int64) + 1, 0, in_size - 1)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, i0), 1.0 - frac)
    np.add.at(mat, (rows, i1), frac)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_bicubic(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense ``[out_size, in_size]`` bicubic sampling matrix with PyTorch
    ``F.interpolate(mode="bicubic")`` semantics: Keys kernel with A=−0.75,
    4 taps, replicate-clamped borders."""
    a = -0.75

    def cubic(t):
        t = np.abs(t)
        return np.where(
            t <= 1.0,
            (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
            np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
        )

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = out_idx * ((in_size - 1) / (out_size - 1)) if out_size > 1 else np.zeros((1,))
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    i0f = np.floor(src)
    frac = src - i0f
    rows = np.arange(out_size)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0f.astype(np.int64) + tap, 0, in_size - 1)
        np.add.at(mat, (rows, idx), cubic(frac - tap))
    return mat.astype(np.float32)


def _resize(x: torch.Tensor, size, align_corners: bool, matrix) -> torch.Tensor:
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if in_h == out_h and in_w == out_w:
        return x
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size must be positive, got {size}")
    y = x.float()
    if in_h != out_h:  # [..., H, W] -> [..., out_h, W]
        mh = torch.from_numpy(matrix(in_h, out_h, align_corners)).to(x.device)
        y = torch.matmul(mh, y)
    if in_w != out_w:  # [..., H, W] -> [..., H, out_w]
        mw = torch.from_numpy(matrix(in_w, out_w, align_corners)).to(x.device)
        y = torch.matmul(y, mw.t())
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of the trailing two dims of ``x`` (``[..., H, W]``)."""
    return _resize(x, size, align_corners, _resize_matrix)


def resize_bicubic(x: torch.Tensor, size: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of the trailing two dims (DINOv2 pos-embed semantics)."""
    return _resize(x, size, align_corners, _resize_matrix_bicubic)


def _scale_output_size(in_size: int, scale: float) -> int:
    """Floor-based output size, the reference's rule."""
    return max(int(np.floor(in_size * scale)), 1)


def resize_bilinear_scale(x: torch.Tensor, scale: tuple[float, float], align_corners: bool = False) -> torch.Tensor:
    """Scale-factor resize with the floor-based output-size rule."""
    out_h = _scale_output_size(x.shape[-2], scale[0])
    out_w = _scale_output_size(x.shape[-1], scale[1])
    return resize_bilinear(x, (out_h, out_w), align_corners)
