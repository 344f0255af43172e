"""Port parity, DINOv2: the port's ``dinov2_forward`` against the JAX
package's on the same numpy weights and input, on the CPU in f32, with hook
taps.  Weights are drawn with numpy in the shapes of the port's template
tree and handed to both.  Tolerance 1e-5 absolute: f32 on both sides, sums
in different orders."""

import dataclasses

import numpy as np
import pytest
import torch

from burn_depth_tpu.vit import dinov2 as jax_dinov2

from burn_depth_tpu_torch.core.init import ParamInit
from burn_depth_tpu_torch.io.checkpoint import map_tree
from burn_depth_tpu_torch.vit.dinov2 import DinoViTConfig, dinov2_forward, init_dinov2


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    template = init_dinov2(ParamInit(None), cfg)
    return map_tree(lambda path, t: (rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32), template)


def _to_jax_cfg(cfg):
    return jax_dinov2.DinoViTConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("regs,img", [(0, 32), (2, 32), (0, 48)])
def test_dinov2_forward_matches_jax(regs, img):
    """img 48 on a 32-px config runs the bicubic pos-embed interpolation."""
    cfg = DinoViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=3, num_heads=2,
                        num_register_tokens=regs, layerscale_init=0.5)
    params = _numpy_params(cfg)
    x = np.random.default_rng(1).standard_normal((2, 3, img, img)).astype(np.float32)
    hooks = (0, 2)
    ref = jax_dinov2.dinov2_forward(params, x, _to_jax_cfg(cfg), hook_ids=hooks, attn_impl="jnp")
    ours = dinov2_forward(map_tree(lambda _, a: torch.from_numpy(a), params), torch.from_numpy(x), cfg,
                          hook_ids=hooks)
    np.testing.assert_allclose(ours.x_norm_clstoken.numpy(), np.asarray(ref.x_norm_clstoken), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.x_norm_patchtokens.numpy(), np.asarray(ref.x_norm_patchtokens),
                               atol=1e-5, rtol=0)
    assert len(ours.hooks) == len(ref.hooks) == 2
    for a, b in zip(ours.hooks, ref.hooks):
        np.testing.assert_allclose(a.tokens.numpy(), np.asarray(b.tokens), atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.patches.numpy(), np.asarray(b.patches), atol=1e-5, rtol=0)
