"""User surface: preprocessing, the prediction type and the model registry."""

from burn_depth_tpu_torch.api.predict import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    DepthPrediction,
    infer_from_rgb,
    normalize_image,
    rgb_to_input_tensor,
)
from burn_depth_tpu_torch.api.registry import AnyDepthModel, DepthModelKind, load_model  # noqa: F401
