"""Depth Pro multi-scale encoder: 3-scale pyramid → 35 batched 384² tiles →
one ViT pass → split/merge → 5 feature maps (counterpart of
``burn_depth_tpu/models/depth_pro/encoder.py``).

Split/merge geometry: overlap 0.25 → stride 288 → 5×5 tiles, seam pad 3;
overlap 0.5 → stride 192 → 3×3 tiles, seam pad 6.  Tiles are stacked
image-major (each image's tiles contiguous on dim 0), as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.ops.conv import conv2d, conv_transpose2d
from burn_depth_tpu_torch.ops.interpolate import resize_bilinear_scale
from burn_depth_tpu_torch.vit.dinov2 import dinov2_forward


def split_geometry(image_size: int, patch_size: int, overlap: float) -> tuple[int, int]:
    """``(steps, stride)`` for a square split."""
    stride = max(int(math.floor(patch_size * (1.0 - overlap))), 1)
    stride = min(stride, patch_size)
    if patch_size >= image_size:
        return 1, stride
    steps = 1 + -(-(image_size - patch_size) // stride)  # div_ceil
    return steps, stride


def feature_padding(patch_size: int, stride: int, feature_patch_size: int) -> int:
    """Seam trim in feature pixels, integer-rounded."""
    if feature_patch_size == 0 or patch_size == 0:
        return 0
    denom = max(patch_size, 1)
    feature_stride = (stride * feature_patch_size + denom // 2) // denom
    return max(feature_patch_size - feature_stride, 0) // 2


def split(x: torch.Tensor, patch_size: int, overlap: float) -> tuple[torch.Tensor, int, int]:
    """Tile ``[B,C,S,S]`` into ``[B·steps², C, p, p]``, image-major (tiles
    row-outer, column-inner within each image)."""
    size = x.shape[-1]
    steps, stride = split_geometry(size, patch_size, overlap)
    if steps == 1:
        return x, steps, stride
    tiles = [
        x[:, :, j * stride : j * stride + patch_size, i * stride : i * stride + patch_size]
        for j in range(steps)
        for i in range(steps)
    ]
    stacked = torch.stack(tiles, dim=1)  # [B, steps², C, p, p]
    return stacked.reshape(x.shape[0] * steps * steps, *stacked.shape[2:]), steps, stride


def merge(x: torch.Tensor, batch_size: int, padding: int) -> torch.Tensor:
    """Reassemble an image-major tile stack ``[B·steps², C, h, w]``, trimming
    ``padding`` px at interior seams."""
    total, _, height, width = x.shape
    steps = int(round(math.sqrt(total / batch_size)))
    if steps <= 1:
        return x
    grid = x.reshape(batch_size, steps * steps, *x.shape[1:])
    rows = []
    for j in range(steps):
        row = []
        for i in range(steps):
            top = 0 if j == 0 else padding
            bottom = height - (0 if j == steps - 1 else padding)
            left = 0 if i == 0 else padding
            right = width - (0 if i == steps - 1 else padding)
            row.append(grid[:, j * steps + i, :, top:bottom, left:right])
        rows.append(torch.cat(row, dim=3))
    return torch.cat(rows, dim=2)


def reshape_feature(tokens: torch.Tensor, width: int, height: int, cls_offset: int) -> torch.Tensor:
    """``[B,T,D] → [B,D,height,width]`` dropping ``cls_offset`` leading tokens."""
    b, t, d = tokens.shape
    spatial = width * height
    offset = cls_offset if t - cls_offset >= spatial else t - spatial
    sel = tokens[:, offset : offset + spatial]
    return sel.reshape(b, height, width, d).permute(0, 3, 1, 2)


def init_project_upsample(init: ParamInit, dim_in: int, dim_out: int, upsample_layers: int,
                          dim_int: int | None = None) -> dict:
    inter = dim_int if dim_int is not None else dim_out
    return {
        "projection": init.conv(inter, dim_in, 1, 1, bias=False),
        "upsample": [
            init.conv_t(inter if layer == 0 else dim_out, dim_out, 2, 2, bias=False)
            for layer in range(upsample_layers)
        ],
    }


def project_upsample_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = conv2d(x, p["projection"]["weight"])
    for layer in p["upsample"]:
        x = conv_transpose2d(x, layer["weight"], stride=2)
    return x


def init_encoder(init: ParamInit, cfg) -> dict:
    """The non-ViT encoder params (``cfg`` is a DepthProConfig)."""
    dims = cfg.encoder_feature_dims
    embed = cfg.patch_encoder.embed_dim
    return {
        "upsample_latent0": init_project_upsample(init, embed, cfg.decoder_features, 3, dims[0]),
        "upsample_latent1": init_project_upsample(init, embed, dims[0], 2),
        "upsample0": init_project_upsample(init, embed, dims[1], 1),
        "upsample1": init_project_upsample(init, embed, dims[2], 1),
        "upsample2": init_project_upsample(init, embed, dims[3], 1),
        "upsample_lowres": init.conv_t(cfg.image_encoder.embed_dim, dims[3], 2, 2, bias=True),
        "fuse_lowres": init.conv(dims[3], dims[3] * 2, 1, 1, bias=True),
    }


def encoder_forward(params: dict, vit_params: dict, image_vit_params: dict, x: torch.Tensor,
                    cfg, debug: bool = False):
    """Returns ``(features, debug)``: the 5 feature maps, and with
    ``debug=True`` a dict of the encoder's intermediates (else None)."""
    batch = x.shape[0]
    patch_size = cfg.patch_encoder.img_size  # 384
    out_size = cfg.patch_encoder.grid_size  # 24

    x0 = x
    x1 = resize_bilinear_scale(x, (0.5, 0.5), align_corners=False)
    x2 = resize_bilinear_scale(x, (0.25, 0.25), align_corners=False)

    x0_tiles, steps0, stride0 = split(x0, patch_size, 0.25)
    x1_tiles, steps1, stride1 = split(x1, patch_size, 0.5)
    x2_tiles = x2

    n0, n1 = steps0 * steps0, steps1 * steps1
    total_tiles = n0 + n1 + 1
    tile_shape = x0_tiles.shape[1:]
    pyramid = torch.cat(
        [
            x0_tiles.reshape(batch, n0, *tile_shape),
            x1_tiles.reshape(batch, n1, *tile_shape),
            x2_tiles[:, None],
        ],
        dim=1,
    ).reshape(batch * total_tiles, *tile_shape)

    def _scale_group(stack: torch.Tensor, start: int, count: int) -> torch.Tensor:
        """One scale's tiles out of an image-major ``[B·total, ...]`` stack."""
        g = stack.reshape(batch, total_tiles, *stack.shape[1:])
        return g[:, start : start + count].reshape(batch * count, *stack.shape[1:])

    # one batched ViT pass over all 35 tiles: the hot loop
    out = dinov2_forward(vit_params, pyramid, cfg.patch_encoder, hook_ids=cfg.hook_ids,
                         attn_impl=cfg.attn_impl)
    encodings = reshape_feature(out.x_norm_patchtokens, out_size, out_size, 0)
    x0_enc = _scale_group(encodings, 0, n0)
    x1_enc = _scale_group(encodings, n0, n1)
    x2_enc = _scale_group(encodings, n0 + n1, 1)

    latent0_merge_input = reshape_feature(out.hooks[0].tokens, out_size, out_size, 1)
    latent1_merge_input = reshape_feature(out.hooks[1].tokens, out_size, out_size, 1)
    latent0_enc = _scale_group(latent0_merge_input, 0, n0)
    latent1_enc = _scale_group(latent1_merge_input, 0, n0)

    high_pad = feature_padding(patch_size, stride0, out_size)
    mid_pad = feature_padding(patch_size, stride1, out_size)
    merged_latent0 = merge(latent0_enc, batch, high_pad)
    merged_latent1 = merge(latent1_enc, batch, high_pad)
    merged_x0 = merge(x0_enc, batch, high_pad)
    merged_x1 = merge(x1_enc, batch, mid_pad)
    merged_x2 = x2_enc

    # global image encoder on the 384² thumbnail
    image_patchtokens = dinov2_forward(
        image_vit_params, x2_tiles, cfg.image_encoder, attn_impl=cfg.attn_impl
    ).x_norm_patchtokens
    global_features = reshape_feature(image_patchtokens, out_size, out_size, 0)
    global_features = conv_transpose2d(
        global_features, params["upsample_lowres"]["weight"], params["upsample_lowres"]["bias"], stride=2
    )
    upsampled_x2 = project_upsample_forward(params["upsample2"], merged_x2)
    global_features = conv2d(
        torch.cat([upsampled_x2, global_features], dim=1),
        params["fuse_lowres"]["weight"],
        params["fuse_lowres"]["bias"],
    )

    features = [
        project_upsample_forward(params["upsample_latent0"], merged_latent0),
        project_upsample_forward(params["upsample_latent1"], merged_latent1),
        project_upsample_forward(params["upsample0"], merged_x0),
        project_upsample_forward(params["upsample1"], merged_x1),
        global_features,
    ]
    if not debug:
        return features, None
    dbg = {
        "latent0": merged_latent0,
        "latent1": merged_latent1,
        "latent0_tokens": latent0_enc,
        "latent1_tokens": latent1_enc,
        "latent0_merge_input": latent0_merge_input,
        "latent1_merge_input": latent1_merge_input,
        "x0_tokens": x0_enc,
        "x1_tokens": x1_enc,
        "x2_tokens": x2_enc,
        "split_x0": x0_tiles,
        "split_x1": x1_tiles,
        "split_x2": x2_tiles,
        "merged_x0": merged_x0,
        "merged_x1": merged_x1,
        "merged_x2": merged_x2,
    }
    return features, dbg
