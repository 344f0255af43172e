"""Card-only: the CUDA flash-attention kernel against the plain PyTorch
version on the same CUDA tensors.  Marked ``cuda``; each test skips with a
reason where no CUDA device is present (decided in the fixture, so every
pytest worker collects the same tests).  Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda_attention.py -m cuda -q``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
This file does not import JAX."""

import pytest
import torch

from burn_depth_tpu_torch import _build
from burn_depth_tpu_torch.ops.attention import (
    KERNEL,
    attention_plain,
    flash_attention_cuda,
    multi_head_attention,
)

F32_ATOL = 1e-5
BF16_REL = 2.0**-8  # one bf16 rounding of the output, doubled for margin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("shape", [(35, 16, 577, 64), (1, 16, 577, 64), (2, 16, 130, 64),
                                   (1, 16, 1374, 64), (2, 2, 65, 32), (1, 1, 1, 64)])
def test_kernel_matches_plain_f32(cuda, shape, quiet):
    q, k, v = _qkv(shape, torch.float32, cuda)
    scale = shape[-1] ** -0.5
    before = _build.LAUNCH_COUNTS.get(KERNEL, 0)
    out = multi_head_attention(q, k, v, scale, quiet)
    torch.cuda.synchronize()
    assert _build.LAUNCH_COUNTS[KERNEL] == before + 1
    ref = attention_plain(q, k, v, scale, quiet)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= F32_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(35, 16, 577, 64), (1, 16, 577, 64), (2, 2, 65, 32)])
def test_kernel_bf16_within_one_rounding_of_f32(cuda, shape):
    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    scale = shape[-1] ** -0.5
    out = flash_attention_cuda(q, k, v, scale, False)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    ref = attention_plain(q.float(), k.float(), v.float(), scale, False)
    excess = (out.float() - ref).abs() - BF16_REL * ref.abs()
    assert float(excess.max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 8, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.125, False)
    with pytest.raises(TypeError, match="not supported"):
        flash_attention_cuda(q.half(), k.half(), v.half(), 0.125, False)
    q48, k48, v48 = _qkv((1, 2, 8, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_cuda(q48, k48, v48, 0.125, False)
    with pytest.raises(ValueError, match="differs from q"):
        flash_attention_cuda(q, k[:, :, :4].contiguous(), v, 0.125, False)
