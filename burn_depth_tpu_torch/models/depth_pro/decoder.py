"""Depth Pro DPT-style multires conv decoder, NCHW parity path (counterpart
of ``burn_depth_tpu/models/depth_pro/decoder.py``).

Five-level top-down fusion: level 4 (lowest resolution) is projected and
fused with no lateral; levels 3→0 fuse the running features with a
projected lateral, deconv-upsampling at every level except 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.ops.activations import relu
from burn_depth_tpu_torch.ops.conv import conv2d, conv_transpose2d


def init_decoder(init: ParamInit, dims_encoder: Sequence[int], dim_decoder: int) -> dict:
    """Projection convs (identity at level 0 when dims match, else 1×1; 3×3
    for levels ≥ 1, all bias-free) and per-level fusion blocks."""
    convs: list[Optional[dict]] = [
        None if dims_encoder[0] == dim_decoder else init.conv(dim_decoder, dims_encoder[0], 1, 1, bias=False)
    ]
    convs += [init.conv(dim_decoder, dim, 3, 3, bias=False) for dim in dims_encoder[1:]]

    def resnet():
        return {
            "conv1": init.conv(dim_decoder, dim_decoder, 3, 3),
            "conv2": init.conv(dim_decoder, dim_decoder, 3, 3),
        }

    fusions = [
        {
            "resnet1": resnet(),
            "resnet2": resnet(),
            "deconv": init.conv_t(dim_decoder, dim_decoder, 2, 2, bias=False) if index != 0 else None,
            "out_conv": init.conv(dim_decoder, dim_decoder, 1, 1),
        }
        for index in range(len(dims_encoder))
    ]
    return {"convs": convs, "fusions": fusions}


def _residual_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """relu → conv → relu → conv, plus the skip."""
    out = conv2d(relu(x), p["conv1"]["weight"], p["conv1"].get("bias"), padding=1)
    out = conv2d(relu(out), p["conv2"]["weight"], p["conv2"].get("bias"), padding=1)
    return out + x


def _fusion(p: dict, x0: torch.Tensor, x1: Optional[torch.Tensor]) -> torch.Tensor:
    """The lateral goes through resnet1; the running features do not."""
    x = x0
    if x1 is not None:
        x = x + _residual_block(p["resnet1"], x1)
    x = _residual_block(p["resnet2"], x)
    if p["deconv"] is not None:
        x = conv_transpose2d(x, p["deconv"]["weight"], p["deconv"].get("bias"), stride=2)
    return conv2d(x, p["out_conv"]["weight"], p["out_conv"].get("bias"))


def decoder_forward(params: dict, encodings: Sequence[torch.Tensor]):
    """Returns ``(features, lowres_features, fusion_outputs)``, the fusion
    outputs per level, level 0 first."""
    n = len(encodings)
    if n != len(params["convs"]):
        raise ValueError(f"got {n} encoder levels, expected {len(params['convs'])}")

    def project(level, x):
        conv = params["convs"][level]
        if conv is None:
            return x
        k = conv["weight"].shape[-1]
        return conv2d(x, conv["weight"], None, padding=(k - 1) // 2)

    features = project(n - 1, encodings[n - 1])
    lowres_features = features
    features = _fusion(params["fusions"][n - 1], features, None)
    fusion_outputs = [features]
    for level in range(n - 2, -1, -1):
        projected = project(level, encodings[level])
        features = _fusion(params["fusions"][level], features, projected)
        fusion_outputs.append(features)
    fusion_outputs.reverse()
    return features, lowres_features, fusion_outputs
