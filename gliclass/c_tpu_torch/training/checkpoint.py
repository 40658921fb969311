"""Training checkpoints with ``torch.save``: parameters, the optimizer's
``state_dict`` and the step, in one file.

The JAX package writes Orbax checkpoints (``gliclass.c_tpu.training.
checkpoint``); Orbax and this format do not read each other. Weights pass
between the packages as bundles (``convert/bundle.py``).
"""

from __future__ import annotations

import torch

from .train import TrainState, param_leaves


def _flat(params, prefix: str = "") -> dict:
    if isinstance(params, dict):
        return {k: v for key in sorted(params) for k, v in _flat(params[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: params.detach()}


def save_train_state(path: str, state: TrainState) -> None:
    torch.save({"params": _flat(state.params), "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)


def restore_train_state(path: str, like: TrainState) -> TrainState:
    """Restore into the structure of ``like``, on its device: its params are
    overwritten in place (the tensors its optimizer holds), then the
    optimizer's state is loaded. Raises if the trees differ."""
    dev = param_leaves(like.params)[0].device
    saved = torch.load(path, map_location=dev, weights_only=True)
    flat = _flat(like.params)
    if saved["params"].keys() != flat.keys():
        raise ValueError(f"{path}: parameter tree differs from the state it is restored into")
    with torch.no_grad():
        for name, t in flat.items():
            t.copy_(saved["params"][name])
    like.optimizer.load_state_dict(saved["optimizer"])
    like.step = saved["step"]
    return like
