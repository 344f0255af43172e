from burn_depth_tpu_torch.models.depth_pro.model import (  # noqa: F401
    DepthPro,
    DepthProConfig,
    DepthProInference,
    params_from_flat,
)
