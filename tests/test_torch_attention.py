"""Port parity, attention: the port's plain attention against the JAX
package's Pallas flash kernel run in interpret mode on the CPU (as
tests/test_attention.py runs it), and the dispatch contract.  Tolerance
1e-5 absolute and relative, the JAX package's own for this kernel."""

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from burn_depth_tpu.ops.attention import fold_softmax_scale as jax_fold
from burn_depth_tpu.ops.attention import multi_head_attention as jax_mha

from burn_depth_tpu_torch import _build
from burn_depth_tpu_torch.ops.attention import (
    attention_plain,
    flash_attention_cuda,
    fold_softmax_scale,
    multi_head_attention,
)


def _qkv(b=1, h=2, t=17, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("t", [64, 130, 577])
def test_plain_matches_pallas_kernel_interpret(t, quiet):
    q, k, v = _qkv(t=t, seed=t)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_mha(q, k, v, quiet_softmax=quiet, impl="pallas"))
    ours = attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           64.0**-0.5, quiet).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [0.125, 0.1])
def test_fold_softmax_scale_matches_jax(scale):
    (q,) = _qkv(t=5)[:1]
    ours, ours_res = fold_softmax_scale(torch.from_numpy(q), scale)
    ref, ref_res = jax_fold(q, scale, "jnp")
    assert ours_res == ref_res
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_auto_on_cpu_takes_plain_without_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=9))
    before = dict(_build.LAUNCH_COUNTS)
    out = multi_head_attention(q, k, v)
    torch.testing.assert_close(out, attention_plain(q, k, v, 0.125, False), rtol=0, atol=0)
    assert _build.LAUNCH_COUNTS == before


def test_cuda_impl_raises_on_cpu_tensor():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=9))
    with pytest.raises(ValueError, match="not a CUDA device"):
        multi_head_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_cuda(q, k, v, 0.125, False)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="pallas")
