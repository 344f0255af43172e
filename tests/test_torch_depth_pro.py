"""Port parity, the whole slice: Depth Pro ``tiny_test`` with the JAX
package's own random weights carried across (``DepthPro.init`` →
``flatten_tree`` → the port's ``params_from_flat``), on the CPU in f32.

Gate: the reference's ``DEPTH_PRO_THRESHOLDS`` (mean_abs 1e-3, max_abs
5e-3, max_rel 5e-3, FOV 1e-3°) on every encoder tap, decoder output and
``infer`` output, with ``rel_floor=1e-3`` as the JAX package's own
random-weight fixtures use it (random thin models have features near zero,
where relative error is float cancellation noise)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from burn_depth_tpu.io.checkpoint import flatten_tree, save_checkpoint
from burn_depth_tpu.models.depth_pro import DepthPro as JaxDepthPro
from burn_depth_tpu.models.depth_pro import DepthProConfig as JaxDepthProConfig
from burn_depth_tpu.models.depth_pro import encoder as jax_enc
from burn_depth_tpu.verify.depth_pro import DEPTH_PRO_THRESHOLDS
from burn_depth_tpu.verify.stats import compute_stats

from burn_depth_tpu_torch.api import infer_from_rgb, load_model, rgb_to_input_tensor
from burn_depth_tpu_torch.models.depth_pro import DepthProConfig, params_from_flat
from burn_depth_tpu_torch.models.depth_pro import encoder as enc

TH = DEPTH_PRO_THRESHOLDS
REL_FLOOR = 1e-3
H, W = 200, 300  # non-square, so the input and output resizes both run


def _check(name, ours, ref):
    s = compute_stats(name, ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours,
                      np.asarray(ref), rel_floor=REL_FLOOR)
    assert s.within(TH["mean_abs"], TH["max_abs"], TH["max_rel"]), s.line()


@pytest.fixture(scope="module")
def pair():
    """(jax model, port model, input) with the same weights."""
    cfg = JaxDepthProConfig.tiny_test()
    params = jax.jit(lambda k: JaxDepthPro.init(k, cfg).params)(jax.random.PRNGKey(0))
    jmodel = JaxDepthPro(cfg, params)
    tmodel = params_from_flat(flatten_tree(params), DepthProConfig.tiny_test(), device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 3, H, W)).astype(np.float32)
    return jmodel, tmodel, x


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """The JAX side's infer and debug forward, one compiled program."""
    jmodel, _, x = pair
    from burn_depth_tpu.ops.interpolate import resize_bilinear

    def fn(p, x):
        m = JaxDepthPro(jmodel.config, p)
        xs = resize_bilinear(x, (m.img_size, m.img_size))
        e = p["encoder"]
        features, _ = jax_enc.encoder_forward(e, e["patch_encoder"], e["image_encoder"], xs, m.config)
        return m._infer_fn(p, x), m._forward_internal(p, xs, debug=True), xs, features

    return jax.jit(fn)(jmodel.params, x)


def test_config_mirrors_jax():
    for name in ("tiny_test", "dinov2_l16_384"):
        ours = dataclasses.asdict(getattr(DepthProConfig, name)())
        ref = dataclasses.asdict(getattr(JaxDepthProConfig, name)())
        for key, value in ours.items():
            if isinstance(value, dict):
                assert value == {k: ref[key][k] for k in value}, key
            else:
                assert value == ref[key], key


@pytest.mark.parametrize("size,patch,overlap", [(1536, 384, 0.25), (768, 384, 0.5), (512, 128, 0.25)])
def test_split_merge_match_jax(size, patch, overlap):
    assert enc.split_geometry(size, patch, overlap) == jax_enc.split_geometry(size, patch, overlap)
    x = np.random.default_rng(0).standard_normal((2, 3, size // 8, size // 8)).astype(np.float32)
    ours, steps, stride = enc.split(torch.from_numpy(x), patch // 8, overlap)
    ref, rsteps, rstride = jax_enc.split(x, patch // 8, overlap)
    assert (steps, stride) == (rsteps, rstride)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    pad = enc.feature_padding(patch // 8, stride, 6)
    np.testing.assert_array_equal(enc.merge(ours, 2, pad).numpy(), np.asarray(jax_enc.merge(ref, 2, pad)))


def test_encoder_taps_and_features_match(pair, jax_outputs):
    _, tmodel, _ = pair
    _, (_, _, _, _, _, jdbg), xs, jfeatures = jax_outputs
    features, dbg = tmodel.encoder_forward_debug(torch.from_numpy(np.array(xs)))
    assert sorted(dbg) == sorted(jdbg) and len(dbg) == 15
    for key in dbg:
        _check(key, dbg[key], jdbg[key])
    assert len(features) == len(jfeatures) == 5
    for i, (a, b) in enumerate(zip(features, jfeatures)):
        _check(f"encoder_feature_{i}", a, b)


def test_decoder_and_heads_match(pair, jax_outputs):
    _, tmodel, _ = pair
    _, (jcanon, jfeats, jlowres, jfusions, jfov, _), xs, _ = jax_outputs
    canon, feats, lowres, fusions, fov = tmodel._forward_internal(tmodel.params, torch.from_numpy(np.array(xs)))
    _check("decoder_feature", feats, jfeats)
    _check("decoder_lowres_feature", lowres, jlowres)
    assert len(fusions) == len(jfusions) == 5
    for i, (a, b) in enumerate(zip(fusions, jfusions)):
        _check(f"decoder_fusion_{i}", a, b)
    _check("canonical_inverse_depth", canon, jcanon)
    assert abs(float(fov[0]) - float(jfov[0])) <= TH["fov_deg"]


def test_infer_matches(pair, jax_outputs):
    _, tmodel, x = pair
    jout = jax_outputs[0]
    out = tmodel.infer(torch.from_numpy(x))
    assert out.depth.shape == (1, H, W) and bool(torch.isfinite(out.depth).all())
    _check("metric_depth", out.depth, jout.depth)
    assert abs(float(out.fovx_deg[0]) - float(jout.fovx_deg[0])) <= TH["fov_deg"]
    np.testing.assert_allclose(out.focallength_px.numpy(), np.asarray(jout.focallength_px), rtol=1e-4)
    np.testing.assert_allclose(out.fovy_rad.numpy(), np.asarray(jout.fovy_rad), rtol=1e-4)


def test_jax_checkpoint_loads_through_load_model(pair, tmp_path):
    jmodel, tmodel, x = pair
    path = str(tmp_path / "depth_pro_tiny.safetensors")
    save_checkpoint(path, jmodel.params)
    loaded = load_model("depth-pro", path, device="cpu", config=DepthProConfig.tiny_test())
    rgb = np.random.default_rng(2).integers(0, 256, (H * W * 3,), dtype=np.uint8)
    a = infer_from_rgb(loaded, rgb.tobytes(), W, H)
    b = tmodel.infer(rgb_to_input_tensor(rgb, W, H, device="cpu"))
    torch.testing.assert_close(a.depth, b.depth, rtol=0, atol=0)
    torch.testing.assert_close(a.focallength_px, b.focallength_px, rtol=0, atol=0)


def test_params_from_flat_is_strict(pair):
    flat = flatten_tree(pair[0].params)
    cfg = DepthProConfig.tiny_test()
    missing = dict(flat)
    missing.pop("head/conv0/weight")
    with pytest.raises(KeyError, match="1 missing"):
        params_from_flat(missing, cfg, device="cpu")
    with pytest.raises(KeyError, match="1 unexpected"):
        params_from_flat({**flat, "head/extra": np.zeros(1, np.float32)}, cfg, device="cpu")
    bad = {**flat, "head/conv0/weight": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="head/conv0/weight: shape"):
        params_from_flat(bad, cfg, device="cpu")
