"""burn_depth_tpu_torch: the PyTorch/CUDA port of ``burn_depth_tpu`` for one
NVIDIA H100.

It imports ``torch`` and never ``jax`` nor anything of ``burn_depth_tpu``.
Module paths mirror the JAX package's (``vit/dinov2.py`` ↔
``vit/dinov2.py``), parameters are the same ``/``-keyed trees in PyTorch
layouts, and every Pallas kernel of a ported path becomes a hand-written
CUDA kernel under ``csrc/`` (built on first use by ``_build.py``).

Ported so far: Depth Pro ``infer`` in the parity form (f32, erf GELU, NCHW),
with the flash-attention forward as a CUDA kernel.  Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the plain versions on the
CPU.
"""

__version__ = "0.1.0"

from burn_depth_tpu_torch.api import (  # noqa: F401
    AnyDepthModel,
    DepthModelKind,
    DepthPrediction,
    infer_from_rgb,
    load_model,
    rgb_to_input_tensor,
)
