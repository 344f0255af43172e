"""DINOv2 vision transformer, plain form (counterpart of
``burn_depth_tpu/vit/dinov2.py``).

Ported: the patch embed, cls/register tokens and position embedding (with
bicubic interpolation to a new grid), the pre-norm LayerScale block with the
power-of-two softmax scale folded into q, per-block hook taps (raw block
outputs) and the final norm.  The DA3-small variants (RoPE, qk-norm, camera
token, ``cat_token``, alternating blocks) and the weight-stacked pass come
with later slices; the config has no fields for them yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.ops.activations import gelu
from burn_depth_tpu_torch.ops.attention import fold_softmax_scale, multi_head_attention
from burn_depth_tpu_torch.ops.conv import conv2d
from burn_depth_tpu_torch.ops.interpolate import resize_bicubic
from burn_depth_tpu_torch.ops.linear import linear
from burn_depth_tpu_torch.ops.norm import layer_norm


@dataclasses.dataclass(frozen=True)
class DinoViTConfig:
    img_size: int = 518
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layerscale_init: float = 1e-5
    ln_eps: float = 1e-6
    num_register_tokens: int = 0
    quiet_softmax: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @staticmethod
    def vitl(img_size: int, patch_size: int, **kw) -> "DinoViTConfig":
        base = dict(img_size=img_size, patch_size=patch_size, embed_dim=1024, depth=24, num_heads=16)
        base.update(kw)
        return DinoViTConfig(**base)


@dataclasses.dataclass
class DinoHook:
    """One intermediate tap: the raw (un-normalized) block output."""

    tokens: torch.Tensor  # [B, prefix+N, D]
    patches: torch.Tensor  # [B, N, D]


@dataclasses.dataclass
class DinoOutput:
    x_norm_clstoken: torch.Tensor  # [B, D]
    x_norm_patchtokens: torch.Tensor  # [B, N, D]
    hooks: list  # list[DinoHook] in hook_ids order


def init_dinov2(init: ParamInit, cfg: DinoViTConfig) -> dict:
    """Parameter tree with the PyTorch DINOv2 state-dict names and shapes."""
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def norm():
        return {"weight": init.full((d,), 1.0), "bias": init.zeros((d,))}

    params: dict = {
        "cls_token": init.normal((1, 1, d), 0.02),
        "pos_embed": init.normal((1, 1 + cfg.num_patches, d), 0.02),
        "patch_embed": {
            "proj": {
                "weight": init.normal((d, cfg.in_chans, cfg.patch_size, cfg.patch_size), 0.02),
                "bias": init.zeros((d,)),
            }
        },
        "norm": norm(),
    }
    if cfg.num_register_tokens:
        params["register_tokens"] = init.normal((1, cfg.num_register_tokens, d), 0.02)
    params["blocks"] = [
        {
            "norm1": norm(),
            "attn": {
                "qkv": {
                    "weight": init.normal((3 * d, d), 0.02),
                    "bias": init.zeros((3 * d,)) if cfg.qkv_bias else None,
                },
                "proj": {"weight": init.normal((d, d), 0.02), "bias": init.zeros((d,))},
            },
            "ls1": {"gamma": init.full((d,), cfg.layerscale_init)},
            "norm2": norm(),
            "mlp": {
                "fc1": {"weight": init.normal((hidden, d), 0.02), "bias": init.zeros((hidden,))},
                "fc2": {"weight": init.normal((d, hidden), 0.02), "bias": init.zeros((d,))},
            },
            "ls2": {"gamma": init.full((d,), cfg.layerscale_init)},
        }
        for _ in range(cfg.depth)
    ]
    return params


def _interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """Resize the patch part of a ``[1, 1+N0, D]`` pos embed to a new grid
    (bicubic, half-pixel: upstream DINOv2's ``interpolate_pos_encoding``)."""
    n0 = pos_embed.shape[1] - 1
    g0 = int(round(n0**0.5))
    if g0 * g0 != n0:
        raise ValueError(f"pos_embed has non-square patch count {n0}")
    if g0 == grid_h == grid_w:
        return pos_embed
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    d = patch_pe.shape[-1]
    patch_pe = patch_pe.reshape(1, g0, g0, d).permute(0, 3, 1, 2)
    patch_pe = resize_bicubic(patch_pe, (grid_h, grid_w), align_corners=False)
    patch_pe = patch_pe.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, d)
    return torch.cat([cls_pe, patch_pe], dim=1)


def _block_forward(bp: dict, x: torch.Tensor, cfg: DinoViTConfig, attn_impl: str) -> torch.Tensor:
    """Pre-norm block: ``x += ls1·attn(norm1(x)); x += ls2·mlp(norm2(x))``."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    y = layer_norm(x, bp["norm1"]["weight"], bp["norm1"]["bias"], cfg.ln_eps)
    qkv = linear(y, bp["attn"]["qkv"]["weight"], bp["attn"]["qkv"]["bias"])  # [B,T,3D]
    qkv = qkv.reshape(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)  # [3,B,H,T,hd]
    q, scale = fold_softmax_scale(qkv[0], float(hd) ** -0.5)
    attn = multi_head_attention(
        q.contiguous(), qkv[1].contiguous(), qkv[2].contiguous(),
        scale=scale, quiet_softmax=cfg.quiet_softmax, impl=attn_impl,
    )
    attn = attn.permute(0, 2, 1, 3).reshape(b, t, d)
    attn = linear(attn, bp["attn"]["proj"]["weight"], bp["attn"]["proj"]["bias"])
    x = x + attn * bp["ls1"]["gamma"].to(x.dtype)

    y = layer_norm(x, bp["norm2"]["weight"], bp["norm2"]["bias"], cfg.ln_eps)
    y = linear(y, bp["mlp"]["fc1"]["weight"], bp["mlp"]["fc1"]["bias"])
    y = gelu(y)
    y = linear(y, bp["mlp"]["fc2"]["weight"], bp["mlp"]["fc2"]["bias"])
    return x + y * bp["ls2"]["gamma"].to(x.dtype)


def dinov2_forward(
    params: dict,
    x: torch.Tensor,
    cfg: DinoViTConfig,
    hook_ids: Sequence[int] = (),
    attn_impl: str = "auto",
) -> DinoOutput:
    """Run the ViT on ``x: [B, 3, H, W]`` (H, W divisible by the patch size).

    ``hook_ids`` are 0-based block indices; each tap is the block's raw
    output.
    """
    b, _, height, width = x.shape
    gh, gw = height // cfg.patch_size, width // cfg.patch_size
    d = cfg.embed_dim

    pe = params["patch_embed"]["proj"]
    tokens = conv2d(x, pe["weight"], pe["bias"], stride=cfg.patch_size)  # [B,D,gh,gw]
    tokens = tokens.reshape(b, d, gh * gw).transpose(1, 2)  # [B,N,D]

    cls = params["cls_token"].to(tokens.dtype).expand(b, 1, d)
    pos = _interpolate_pos_embed(params["pos_embed"], gh, gw).to(tokens.dtype)
    nreg = cfg.num_register_tokens
    if nreg:
        # pos embed applies to cls + patches; registers get no positional term
        regs = params["register_tokens"].to(tokens.dtype).expand(b, nreg, d)
        x_seq = torch.cat([cls + pos[:, :1], regs, tokens + pos[:, 1:]], dim=1)
    else:
        x_seq = torch.cat([cls, tokens], dim=1) + pos
    num_prefix = 1 + nreg

    hook_ids = list(hook_ids)
    hooks_raw: dict[int, torch.Tensor] = {}
    for i in range(cfg.depth):
        x_seq = _block_forward(params["blocks"][i], x_seq, cfg, attn_impl)
        if i in hook_ids:
            hooks_raw[i] = x_seq

    x_norm = layer_norm(x_seq, params["norm"]["weight"], params["norm"]["bias"], cfg.ln_eps)
    hooks = [DinoHook(tokens=hooks_raw[i], patches=hooks_raw[i][:, num_prefix:]) for i in hook_ids]
    return DinoOutput(
        x_norm_clstoken=x_norm[:, 0],
        x_norm_patchtokens=x_norm[:, num_prefix:],
        hooks=hooks,
    )
