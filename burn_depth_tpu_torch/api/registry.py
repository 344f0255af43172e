"""Model registry, Depth Pro branch (counterpart of
``burn_depth_tpu/api/registry.py``).

``load_model("depth-pro")`` builds the flagship config with random weights
from a fixed seed; ``load_model("depth-pro", path)`` loads a native
flattened-safetensors checkpoint (``/``-joined keys, as the JAX package
writes them).  Depth Anything 3 and the import of upstream PyTorch files
come with later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

import torch

from burn_depth_tpu_torch.api.predict import DepthPrediction
from burn_depth_tpu_torch.io.checkpoint import is_native_checkpoint, load_safetensors
from burn_depth_tpu_torch.models.depth_pro.model import DepthPro, DepthProConfig, params_from_flat

SEED = 0


class DepthModelKind(enum.Enum):
    DEPTH_PRO = "depth-pro"
    DEPTH_ANYTHING3 = "depth-anything-3"

    @staticmethod
    def from_str(s: str) -> "DepthModelKind":
        for k in DepthModelKind:
            if k.value == s:
                return k
        raise ValueError(f"unknown model kind {s!r}; expected one of {[k.value for k in DepthModelKind]}")


class AnyDepthModel:
    """A loaded model of one kind, with the unified ``infer_depth``."""

    def __init__(self, kind: DepthModelKind, model):
        self._kind = kind
        self.model = model

    @property
    def kind(self) -> DepthModelKind:
        return self._kind

    @property
    def device(self) -> torch.device:
        return self.model.device

    def infer_depth(self, x: torch.Tensor) -> DepthPrediction:
        out = self.model.infer(x)
        return DepthPrediction(depth=out.depth, focallength_px=out.focallength_px, fovy_rad=out.fovy_rad)


def load_model(kind: Union[DepthModelKind, str], checkpoint: Optional[str] = None,
               device="cuda", config: Optional[DepthProConfig] = None) -> AnyDepthModel:
    """Kind (+ optional native checkpoint) → model on ``device``.  With no
    checkpoint the weights are random, drawn from a generator seeded with
    ``SEED`` on ``device``.  ``config`` defaults to the flagship
    ``dinov2_l16_384``."""
    kind = DepthModelKind.from_str(kind) if isinstance(kind, str) else kind
    if kind != DepthModelKind.DEPTH_PRO:
        raise NotImplementedError(f"{kind.value} is not ported to burn_depth_tpu_torch yet")
    config = config or DepthProConfig.dinov2_l16_384()
    if checkpoint is None:
        generator = torch.Generator(device=device).manual_seed(SEED)
        return AnyDepthModel(kind, DepthPro.init(generator, config, device))
    if not is_native_checkpoint(checkpoint):
        raise NotImplementedError(
            f"{checkpoint}: importing upstream PyTorch checkpoints is not ported yet; "
            "convert it with the JAX package's importer to a native .safetensors file"
        )
    return AnyDepthModel(kind, params_from_flat(load_safetensors(checkpoint), config, device))
