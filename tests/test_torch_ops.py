"""Port parity, ops: the torch port's ops against the JAX package's on the
same numpy inputs, on the CPU in f32.  Tolerance 1e-5 absolute and 1e-5
relative unless a test states otherwise (both sides compute in f32; XLA
and ATen sum in different orders, a few ulp apart on O(1) outputs)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from burn_depth_tpu.api.predict import rgb_to_input_tensor as jax_rgb_to_input_tensor
from burn_depth_tpu.ops import activations as jax_act
from burn_depth_tpu.ops import conv as jax_conv
from burn_depth_tpu.ops import interpolate as jax_interp
from burn_depth_tpu.ops.norm import layer_norm as jax_layer_norm

from burn_depth_tpu_torch.api.predict import rgb_to_input_tensor
from burn_depth_tpu_torch.io.checkpoint import load_safetensors, save_checkpoint
from burn_depth_tpu_torch.ops import activations, conv, interpolate
from burn_depth_tpu_torch.ops.linear import linear
from burn_depth_tpu_torch.ops.norm import layer_norm

ATOL = 1e-5
RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def test_layer_norm_matches_jax():
    x, w, b = _rand(2, 7, 48), _rand(48, seed=1), _rand(48, seed=2)
    ours = layer_norm(_t(x), _t(w), _t(b), 1e-6).numpy()
    ref = np.asarray(jax_layer_norm(x, w, b, 1e-6))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_linear_gelu_relu_match_jax():
    from burn_depth_tpu.ops.linear import linear as jax_linear

    x, w, b = _rand(3, 5, 16), _rand(24, 16, seed=1), _rand(24, seed=2)
    np.testing.assert_allclose(linear(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jax_linear(x, w, b)), atol=ATOL, rtol=RTOL)
    y = _rand(4, 33, seed=3) * 3
    np.testing.assert_allclose(activations.gelu(_t(y)).numpy(), np.asarray(jax_act.gelu(y)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(activations.relu(_t(y)).numpy(), np.asarray(jax_act.relu(y)))


@pytest.mark.parametrize("stride,padding,groups,k", [(1, 1, 1, 3), (2, 1, 1, 3), (1, 0, 1, 6), (16, 0, 1, 16),
                                                     (1, 0, 4, 1)])
def test_conv2d_matches_jax(stride, padding, groups, k):
    x = _rand(2, 8, 32, 32)
    w = _rand(12, 8 // groups, k, k, seed=1) * 0.1
    b = _rand(12, seed=2)
    ours = conv.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=padding, groups=groups).numpy()
    ref = np.asarray(jax_conv.conv2d(x, w, b, stride=stride, padding=padding, groups=groups))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k,stride,padding,bias", [(2, 2, 0, True), (2, 2, 0, False), (4, 4, 0, True),
                                                   (3, 2, 1, True)])
def test_conv_transpose2d_matches_jax(k, stride, padding, bias):
    x = _rand(2, 6, 9, 7)
    w = _rand(6, 5, k, k, seed=1) * 0.2  # [I, O, kh, kw]
    b = _rand(5, seed=2) if bias else None
    ours = conv.conv_transpose2d(_t(x), _t(w), None if b is None else _t(b), stride=stride,
                                 padding=padding).numpy()
    ref = np.asarray(jax_conv.conv_transpose2d(x, w, b, stride=stride, padding=padding))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 5), (16, 11)), ((33, 20), (9, 14)), ((1, 4), (3, 8)),
                                          ((12, 12), (12, 5))])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    x = _rand(2, 3, *in_hw)
    ours = interpolate.resize_bilinear(_t(x), out_hw, align_corners).numpy()
    ref = np.asarray(jax_interp.resize_bilinear(x, out_hw, align_corners))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("scale", [0.5, 0.25])
@pytest.mark.parametrize("hw", [(37, 53), (15, 9)])
def test_resize_bilinear_scale_matches_jax(scale, hw):
    x = _rand(1, 3, *hw)
    ours = interpolate.resize_bilinear_scale(_t(x), (scale, scale)).numpy()
    ref = np.asarray(jax_interp.resize_bilinear_scale(x, (scale, scale)))
    assert ours.shape == ref.shape == (1, 3, max(int(hw[0] * scale), 1), max(int(hw[1] * scale), 1))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (7, 9)), ((24, 24), (8, 32))])
def test_resize_bicubic_matches_jax(in_hw, out_hw):
    x = _rand(1, 5, *in_hw)
    ours = interpolate.resize_bicubic(_t(x), out_hw).numpy()
    ref = np.asarray(jax_interp.resize_bicubic(x, out_hw))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_resize_half_pixel_golden():
    # the reference's golden values: 2x2 [1,2,3,4] -> 4x4, half-pixel
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).reshape(1, 1, 2, 2)
    out = interpolate.resize_bilinear(x, (4, 4), align_corners=False)[0, 0].numpy()
    np.testing.assert_allclose(out[0], [1.0, 1.25, 1.75, 2.0], atol=1e-6)
    np.testing.assert_allclose(out[3], [3.0, 3.25, 3.75, 4.0], atol=1e-6)


def test_rgb_to_input_tensor_golden_and_contract():
    x = rgb_to_input_tensor(bytes([0, 255, 128, 255, 0, 128]), 1, 2, device="cpu")
    assert x.shape == (1, 3, 2, 1) and x.dtype == torch.float32 and x.device.type == "cpu"
    np.testing.assert_allclose(x.numpy().ravel()[:2], [-2.1179039, 2.2489083], atol=1e-5)
    with pytest.raises(ValueError, match="expected 6 RGB bytes for 1x2, got 5"):
        rgb_to_input_tensor(bytes(5), 1, 2, device="cpu")
    rgb = np.random.default_rng(0).integers(0, 256, (5 * 7 * 3,), dtype=np.uint8)
    np.testing.assert_allclose(rgb_to_input_tensor(rgb, 7, 5, device="cpu").numpy(),
                               np.asarray(jax_rgb_to_input_tensor(rgb, 7, 5)), atol=1e-6, rtol=0)


def test_checkpoint_roundtrip_and_jax_readable(tmp_path):
    from burn_depth_tpu.io.checkpoint import load_safetensors as jax_load_safetensors

    tree = {"a": {"weight": torch.randn(3, 4), "bias": None}, "blocks": [{"g": torch.arange(5)}],
            "h": torch.randn(2, 2).to(torch.bfloat16)}
    path = str(tmp_path / "c.safetensors")
    save_checkpoint(path, tree)
    back = load_safetensors(path)
    assert sorted(back) == ["a/weight", "blocks/0/g", "h"]
    assert torch.equal(back["a/weight"], tree["a"]["weight"])
    assert torch.equal(back["blocks/0/g"], tree["blocks"][0]["g"])
    assert torch.equal(back["h"], tree["h"])
    theirs = jax_load_safetensors(path)
    np.testing.assert_array_equal(theirs["a/weight"], tree["a"]["weight"].numpy())
    np.testing.assert_array_equal(theirs["h"].astype(np.float32), tree["h"].float().numpy())


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax or
    any part of burn_depth_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import burn_depth_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'burn_depth_tpu_torch.')]\n"
        "assert len(mods) > 15, mods\n"
        "[importlib.import_module(m) for m in mods]\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'burn_depth_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
