"""Parameter factory for random init (the port's counterpart of the JAX
package's ``jax.random`` init helpers: ``models/da3/dpt.py::_conv_init``,
``_convT_init`` and ``models/da3/camera.py::_linear_init``).

One factory serves two uses: with a ``torch.Generator`` it draws seeded
random weights on the generator's device and places them on ``device``;
with ``generator=None`` it makes
shape-only tensors on the ``meta`` device, the template that a checkpoint is
checked against.  ``torch`` and ``jax.random`` draw different numbers from
the same seed, so parity tests carry weights across rather than re-seed.
"""

from __future__ import annotations

from typing import Optional

import torch


class ParamInit:
    def __init__(self, generator: Optional[torch.Generator], device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = torch.device(device) if generator is not None else torch.device("meta")
        self.dtype = dtype

    def _kw(self):
        return dict(device=self.device, dtype=self.dtype)

    def _draw(self, fn, shape) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, **self._kw())
        out = fn(shape, generator=self.generator, device=self.generator.device, dtype=self.dtype)
        return out.to(self.device)

    def normal(self, shape, std: float) -> torch.Tensor:
        return self._draw(torch.randn, shape) * std

    def uniform(self, shape, bound: float) -> torch.Tensor:
        return (self._draw(torch.rand, shape) * 2.0 - 1.0) * bound

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, **self._kw())

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, **self._kw())

    def conv(self, out_c: int, in_c: int, kh: int, kw: int, bias: bool = True) -> dict:
        """torch ``Conv2d`` default init: U(±1/sqrt(fan_in)), ``[O,I,kh,kw]``."""
        bound = (1.0 / (in_c * kh * kw)) ** 0.5
        p = {"weight": self.uniform((out_c, in_c, kh, kw), bound)}
        if bias:
            p["bias"] = self.uniform((out_c,), bound)
        return p

    def conv_t(self, in_c: int, out_c: int, kh: int, kw: int, bias: bool = True) -> dict:
        """``ConvTranspose2d`` weights ``[I,O,kh,kw]``, U(±1/sqrt(in·kh·kw))."""
        bound = (1.0 / (in_c * kh * kw)) ** 0.5
        p = {"weight": self.uniform((in_c, out_c, kh, kw), bound)}
        if bias:
            p["bias"] = self.uniform((out_c,), bound)
        return p

    def linear(self, out_d: int, in_d: int) -> dict:
        bound = (1.0 / in_d) ** 0.5
        return {"weight": self.uniform((out_d, in_d), bound), "bias": self.uniform((out_d,), bound)}
