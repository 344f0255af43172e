"""Depth Pro top-level model (counterpart of
``burn_depth_tpu/models/depth_pro/model.py``), parity form: f32, erf GELU,
NCHW.

``infer``: input resize → 3-scale encoder with the batched 35-tile ViT pass
→ decoder → depth head and FOV head → focal math → output resize →
``1 / clamp(inverse_depth, 1e-4, 1e4)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from burn_depth_tpu_torch.core.dtypes import PARITY
from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.io.checkpoint import unflatten_into
from burn_depth_tpu_torch.models.depth_pro import encoder as enc_mod
from burn_depth_tpu_torch.models.depth_pro.decoder import decoder_forward, init_decoder
from burn_depth_tpu_torch.models.depth_pro.fov import fov_forward, init_fov
from burn_depth_tpu_torch.ops.activations import relu
from burn_depth_tpu_torch.ops.conv import conv2d, conv_transpose2d
from burn_depth_tpu_torch.ops.interpolate import resize_bilinear
from burn_depth_tpu_torch.vit.dinov2 import DinoViTConfig, init_dinov2


def _l16_vit(img_size: int) -> DinoViTConfig:
    """The ``dinov2l16_384`` preset family: ViT-L/16, no quiet softmax, no
    register tokens."""
    return DinoViTConfig.vitl(img_size, 16)


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    patch_encoder: DinoViTConfig = dataclasses.field(default_factory=lambda: _l16_vit(384))
    image_encoder: DinoViTConfig = dataclasses.field(default_factory=lambda: _l16_vit(384))
    fov_encoder: Optional[DinoViTConfig] = dataclasses.field(default_factory=lambda: _l16_vit(384))
    decoder_features: int = 256
    encoder_feature_dims: tuple[int, int, int, int] = (256, 512, 1024, 1024)
    hook_ids: tuple[int, int] = (5, 11)
    use_fov_head: bool = True
    # "auto" (CUDA kernel on a CUDA tensor, plain on CPU), "cuda" or "plain"
    attn_impl: str = "auto"

    @property
    def img_size(self) -> int:
        """Full working resolution = 4× the patch window."""
        return self.patch_encoder.img_size * 4

    @staticmethod
    def dinov2_l16_384() -> "DepthProConfig":
        return DepthProConfig()

    @staticmethod
    def tiny_test(depth: int = 2, embed_dim: int = 64, heads: int = 2) -> "DepthProConfig":
        """A miniature config for fast CPU tests (not a reference preset):
        patch 16, window 128, grid 8, so the split/merge seams line up; only
        the transformer is shrunk."""
        vit = DinoViTConfig(img_size=128, patch_size=16, embed_dim=embed_dim, depth=depth, num_heads=heads)
        return DepthProConfig(
            patch_encoder=vit,
            image_encoder=vit,
            fov_encoder=vit,
            decoder_features=16,
            encoder_feature_dims=(16, 24, 32, 32),
            hook_ids=(0, 1),
        )


@dataclasses.dataclass
class DepthProInference:
    depth: torch.Tensor  # [B, H, W] metric depth
    focallength_px: torch.Tensor  # [B]
    fovx_deg: torch.Tensor  # [B]
    fovy_rad: torch.Tensor  # [B]


def fovy_from_fovx_rad(fovx_rad: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``fovy = 2·atan((H/W)·tan(fovx/2))``."""
    return 2.0 * torch.atan((h / w) * torch.tan(fovx_rad * 0.5))


def _init_depth_head(init: ParamInit, dim_decoder: int) -> dict:
    head = {
        "conv0": init.conv(dim_decoder // 2, dim_decoder, 3, 3),
        "deconv": init.conv_t(dim_decoder // 2, dim_decoder // 2, 2, 2),
        "conv1": init.conv(32, dim_decoder // 2, 3, 3),
        "conv_out": init.conv(1, 32, 1, 1),
    }
    head["conv_out"]["bias"] = init.zeros((1,))
    return head


def _depth_head_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = conv2d(x, p["conv0"]["weight"], p["conv0"]["bias"], padding=1)
    x = conv_transpose2d(x, p["deconv"]["weight"], p["deconv"]["bias"], stride=2)
    x = conv2d(x, p["conv1"]["weight"], p["conv1"]["bias"], padding=1)
    x = relu(x)
    x = conv2d(x, p["conv_out"]["weight"], p["conv_out"]["bias"])
    return relu(x)


def _init_params(init: ParamInit, config: DepthProConfig) -> dict:
    decoder_dims = [config.decoder_features, *config.encoder_feature_dims]
    params = {
        "encoder": {
            "patch_encoder": init_dinov2(init, config.patch_encoder),
            "image_encoder": init_dinov2(init, config.image_encoder),
            **enc_mod.init_encoder(init, config),
        },
        "decoder": init_decoder(init, decoder_dims, config.decoder_features),
        "head": _init_depth_head(init, config.decoder_features),
    }
    if config.use_fov_head:
        fov_dim = None if config.fov_encoder is None else config.fov_encoder.embed_dim
        params["fov"] = {
            "encoder": None if config.fov_encoder is None else init_dinov2(init, config.fov_encoder),
            **init_fov(init, config.decoder_features, fov_dim),
        }
    return params


class DepthPro:
    """Holds ``(config, params)``; the forward is plain functions on the
    param tree, whose keys and layouts are the JAX package's."""

    def __init__(self, config: DepthProConfig, params: dict):
        self.config = config
        self.params = params

    @staticmethod
    def init(generator: torch.Generator, config: DepthProConfig, device="cuda") -> "DepthPro":
        """Random weights drawn from ``generator`` (on its own device) and
        placed on ``device``."""
        return DepthPro(config, _init_params(ParamInit(generator, device, PARITY.param_dtype), config))

    @staticmethod
    def template(config: DepthProConfig) -> dict:
        """The param tree as shape-only ``meta`` tensors."""
        return _init_params(ParamInit(None, dtype=PARITY.param_dtype), config)

    @property
    def img_size(self) -> int:
        return self.config.img_size

    @property
    def device(self) -> torch.device:
        return self.params["head"]["conv0"]["weight"].device

    def _forward_internal(self, params: dict, x: torch.Tensor, debug: bool = False):
        cfg = self.config
        enc = params["encoder"]
        features, enc_dbg = enc_mod.encoder_forward(
            enc, enc["patch_encoder"], enc["image_encoder"], x, cfg, debug=debug
        )
        feats, lowres, fusion_outputs = decoder_forward(params["decoder"], features)
        canonical = _depth_head_forward(params["head"], feats)
        fov_deg = None
        if "fov" in params:
            fov_deg = fov_forward(params["fov"], params["fov"].get("encoder"), cfg.fov_encoder, x,
                                  lowres, attn_impl=cfg.attn_impl)
        if debug:
            return canonical, feats, lowres, fusion_outputs, fov_deg, enc_dbg
        return canonical, feats, lowres, fusion_outputs, fov_deg

    def forward(self, x: torch.Tensor):
        """``(canonical_inverse_depth [B,1,S,S], fovx_deg [B] | None)``."""
        canonical, _, _, _, fov = self._forward_internal(self.params, x)
        return canonical, fov

    def encoder_forward_debug(self, x: torch.Tensor):
        enc = self.params["encoder"]
        return enc_mod.encoder_forward(enc, enc["patch_encoder"], enc["image_encoder"], x,
                                       self.config, debug=True)

    @torch.no_grad()
    def infer(self, x: torch.Tensor) -> DepthProInference:
        """resize → forward → focal ``0.5·W/tan(0.5·fovx)`` → inverse-depth
        scale → resize back → ``1 / clamp(inv, 1e-4, 1e4)``."""
        return self._infer_fn(self.params, x)

    def _infer_fn(self, params: dict, x: torch.Tensor) -> DepthProInference:
        _, _, height, width = x.shape
        size = self.img_size
        resize_needed = height != size or width != size
        if resize_needed:
            x = resize_bilinear(x, (size, size), align_corners=False)

        canonical, _, _, _, fov_deg = self._forward_internal(params, x)
        if fov_deg is None:
            raise ValueError("FOV head required for focal length (use_fov_head=False)")

        fovx_rad = fov_deg * (math.pi / 180.0)
        focal_px = (width * 0.5) / torch.tan(fovx_rad * 0.5)  # [B]
        inverse_depth = canonical * (width / focal_px)[:, None, None, None]
        if resize_needed:
            inverse_depth = resize_bilinear(inverse_depth, (height, width), align_corners=False)
        depth = 1.0 / torch.clamp(inverse_depth, 1e-4, 1e4)
        return DepthProInference(
            depth=depth[:, 0],
            focallength_px=focal_px,
            fovx_deg=fov_deg,
            fovy_rad=fovy_from_fovx_rad(fovx_rad, height, width),
        )


def params_from_flat(flat: dict, config: DepthProConfig, device="cuda") -> DepthPro:
    """Build a model from a flat ``{'/'-joined path: array}`` dict, such as
    the JAX package's ``flatten_tree(model.params)`` or a native checkpoint.
    Raises if a key is missing, unexpected, or of the wrong shape."""
    return DepthPro(config, unflatten_into(DepthPro.template(config), flat, device))
