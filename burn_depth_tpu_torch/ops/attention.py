"""Multi-head attention: a hand-written CUDA flash-attention kernel on the
card, the plain PyTorch version on the CPU (counterpart of
``burn_depth_tpu/ops/attention.py``).

``flash_attention_cuda`` launches ``csrc/flash_attn_fwd.cu``, the Hopper
port of the TPU kernel ``_flash_kernel``.  ``attention_plain`` is the math
of the JAX package's ``_attention_jnp``: the CPU tests hold it against the
TPU kernel run in interpret mode, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.

Dispatch (``multi_head_attention``): ``"auto"`` launches the kernel for every
CUDA tensor (the JAX package's T >= 128 gate exists for Mosaic and does not
apply here) and takes the plain version for a CPU tensor; ``"cuda"`` launches
the kernel or raises; ``"plain"`` forces the plain version.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from burn_depth_tpu_torch import _build

KERNEL = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_MAX_Q_TILES = 65535  # grid.y limit; one tile is 64 query rows


def fold_softmax_scale(q: torch.Tensor, scale: float):
    """Fold a power-of-two softmax scale into q (exact in any float format:
    a pure exponent shift).  Returns ``(q', residual_scale)``."""
    if math.log2(scale).is_integer():
        return q * scale, 1.0
    return q, scale


def attention_plain(q, k, v, scale: float, quiet_softmax: bool) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over ``[B, H, T, hd]``: f32 scores and softmax,
    the probabilities cast to v's dtype before the f32-accumulated product,
    output in v's dtype.  ``quiet_softmax`` adds the unshifted ``+1``
    (``exp(-m)``) to the denominator."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if quiet_softmax:
        denom = denom + torch.exp(-m)
    p = p / denom
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _lib():
    fn = _build.load(KERNEL).bdt_flash_attn_fwd
    # (q, k, v, o, bh, t, hd, dtype, scale, quiet, stream): pointers and the
    # stream as c_void_p, or ctypes would pass them as 32-bit ints.
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, scale: float, quiet_softmax: bool) -> torch.Tensor:
    """Launch the CUDA flash-attention kernel on ``[B, H, T, hd]`` CUDA
    tensors (f32 or bf16, hd 32 or 64, contiguous).  Raises on anything the
    kernel does not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, not a CUDA device")
        if x.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be [B,H,T,hd], got {tuple(x.shape)}")
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention_cuda: {name} {tuple(x.shape)} {x.dtype} {x.device} differs from "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not supported (float32, bfloat16)")
    b, h, t, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not supported {_HEAD_DIMS}")
    if b * h == 0 or t == 0:
        raise ValueError(f"flash_attention_cuda: empty input {tuple(q.shape)}")
    if -(-t // 64) > _MAX_Q_TILES or b * h > 2**31 - 1:
        raise ValueError(f"flash_attention_cuda: input {tuple(q.shape)} exceeds the launch grid")
    fn = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, hd,
                _DTYPE_CODES[q.dtype], float(scale), int(bool(quiet_softmax)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with cudaError {rc}")
    _build.count_launch(KERNEL)
    return out


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    quiet_softmax: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Scaled-dot-product self-attention over ``[B, H, T, hd]`` tensors.

    ``impl``: ``"auto"`` (the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor), ``"cuda"`` (the kernel, or raise), ``"plain"``.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "plain"
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, scale, quiet_softmax)
    if impl == "plain":
        return attention_plain(q, k, v, scale, quiet_softmax)
    raise ValueError(f"unknown attention impl `{impl}` (want auto|cuda|plain)")
