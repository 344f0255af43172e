"""Depth Pro FOV (focal-length) network (counterpart of
``burn_depth_tpu/models/depth_pro/fov.py``).

A third ViT pass on the 0.25× input, projected and fused with downsampled
decoder features, then a conv head ending in a 6×6 valid conv → one fovx
in degrees per image.
"""

from __future__ import annotations

from typing import Optional

import torch

from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.ops.activations import relu
from burn_depth_tpu_torch.ops.conv import conv2d
from burn_depth_tpu_torch.ops.interpolate import resize_bilinear, resize_bilinear_scale
from burn_depth_tpu_torch.ops.linear import linear
from burn_depth_tpu_torch.vit.dinov2 import dinov2_forward


def init_fov(init: ParamInit, num_features: int, fov_encoder_dim: Optional[int]) -> dict:
    """``fov_encoder_dim`` is the ViT embed dim when the encoder variant is
    used (the default config), else None."""
    nf = num_features
    params: dict = {"downsample_blocks": [], "head_blocks": []}
    if fov_encoder_dim is not None:
        params["encoder_proj"] = init.linear(nf // 2, fov_encoder_dim)
        params["downsample_blocks"].append(init.conv(nf // 2, nf, 3, 3))
        head_dims = [(nf // 2, nf // 4), (nf // 4, nf // 8), (nf // 8, 1)]
    else:
        head_dims = [(nf, nf // 2), (nf // 2, nf // 4), (nf // 4, nf // 8), (nf // 8, 1)]
    for in_c, out_c in head_dims[:-1]:
        params["head_blocks"].append(init.conv(out_c, in_c, 3, 3))
    in_c, out_c = head_dims[-1]
    params["head_blocks"].append(init.conv(out_c, in_c, 6, 6))
    return params


def _ensure_min_spatial(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Resize guard for feature maps smaller than the kernel."""
    h, w = x.shape[-2:]
    if h >= kh and w >= kw:
        return x
    return resize_bilinear(x, (max(h, kh), max(w, kw)), align_corners=False)


def _apply_blocks(blocks: list, x: torch.Tensor) -> torch.Tensor:
    """Strided 3×3 conv + relu for all but the final 6×6 valid conv, which
    has no relu."""
    for p in blocks:
        kh, kw = p["weight"].shape[-2:]
        x = _ensure_min_spatial(x, kh, kw)
        if kh == 6:
            x = conv2d(x, p["weight"], p["bias"])
        else:
            x = relu(conv2d(x, p["weight"], p["bias"], stride=2, padding=1))
    return x


def fov_forward(params: dict, vit_params: Optional[dict], vit_cfg, x: torch.Tensor,
                lowres_feature: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
    """``[B]`` fovx in degrees."""
    if vit_params is None:
        out = _apply_blocks(params["head_blocks"], lowres_feature)
        return out.reshape(out.shape[0])

    features = lowres_feature
    for p in params["downsample_blocks"]:
        features = _ensure_min_spatial(features, 3, 3)
        features = relu(conv2d(features, p["weight"], p["bias"], stride=2, padding=1))

    x_small = resize_bilinear_scale(x, (0.25, 0.25), align_corners=False)
    tokens = dinov2_forward(vit_params, x_small, vit_cfg, attn_impl=attn_impl).x_norm_patchtokens
    projected = linear(tokens, params["encoder_proj"]["weight"], params["encoder_proj"]["bias"])
    encoded = projected.transpose(1, 2).reshape(features.shape)

    out = _apply_blocks(params["head_blocks"], features + encoded)
    return out.reshape(out.shape[0])
