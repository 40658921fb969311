"""Random-init leaves shared by the models' ``init_*_params``.

The JAX package's rules: weights N(0, 0.02), biases 0, LayerNorm scale 1 and
bias 0. Values are drawn on the generator's device from one explicit
``torch.Generator`` (so a seed gives the same tree on any ``device``), then
moved to ``device`` in ``dtype``.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


def normal(gen: torch.Generator, shape: tuple, dtype, device, std: float = 0.02) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std
    return x.to(device=device, dtype=dtype)


def zeros(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape: tuple, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def dense(gen: torch.Generator, d_in: int, d_out: int, dtype, device, bias: bool = True,
          lead: tuple = ()) -> Params:
    """{"w" [*lead, d_in, d_out] ~ N(0, 0.02), "b" [*lead, d_out] = 0}
    (``lead``: the stacked [L] axis of per-layer leaves)."""
    p = {"w": normal(gen, (*lead, d_in, d_out), dtype, device)}
    if bias:
        p["b"] = zeros((*lead, d_out), dtype, device)
    return p


def layer_norm(d: int, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": ones((*lead, d), dtype, device), "bias": zeros((*lead, d), dtype, device)}
