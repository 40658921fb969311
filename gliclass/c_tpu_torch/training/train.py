"""GLiClass fine-tuning on one device: the multi-label loss and the train step.

The port of ``gliclass.c_tpu.training.train`` without its sharded step (that
waits for ``torch.distributed``). The loss is multi-label BCE-with-logits over
the valid label slots with optional focal re-weighting (the gliclass
package's focal_loss_alpha/gamma); the step takes one optimizer update from
the mean gradient of ``accum_steps`` micro-batches.

The forward takes the plain formulations: ``attn_route="xla"`` (the score
path of both backbones) and unquantized weights, so every FFN composes plain
linears. No kernel of the port has a backward, as no Pallas kernel of the
JAX package has a VJP; a kernel wrapper that is reached with an input that
requires grad raises (``ops._build.refuse_grad``). Parameters and optimizer
moments stay fp32; with ``compute_dtype=torch.bfloat16`` each product casts
its operands (``ops.layers.linear``), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..config import GLiClassConfig
from ..convert.params import params_from_numpy
from ..engine import resolve_device
from ..models.gliclass import gliclass_forward

Params = dict[str, Any]


@dataclass
class TrainState:
    params: Params  # fp32 leaves that require grad
    optimizer: torch.optim.Optimizer  # over param_leaves(params), in that order
    step: int


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The tree's tensors, depth first in sorted key order (the order JAX
    flattens a dict in, so the global gradient norm sums alike)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [params]


def init_train_state(params: Params, optimizer: Callable[[list], torch.optim.Optimizer],
                     device=None) -> TrainState:
    """A numpy parameter tree (a bundle's ``load_params``, or the JAX
    package's params as numpy) -> fp32 leaves of its own on ``device`` (the
    card unless ``device="cpu"``), each requiring grad, and the optimizer that
    ``optimizer`` builds over them, e.g. ``functools.partial(torch.optim.AdamW,
    lr=3e-3, weight_decay=1e-4)``. Quantized trees are refused: INT8 weights
    have no gradient."""
    def own(node):
        if isinstance(node, dict):
            return {k: own(v) for k, v in node.items()}
        if not node.is_floating_point():
            raise ValueError("training needs unquantized weights (an INT8 leaf has no gradient)")
        # A copy: on the CPU params_from_numpy shares the caller's arrays.
        return node.clone().requires_grad_(True)

    tree = own(params_from_numpy(params, resolve_device(device), torch.float32))
    return TrainState(tree, optimizer(param_leaves(tree)), 0)


def multilabel_loss(
    logits: torch.Tensor,  # [B, L] f32 (padded slots are NEG_LOGIT)
    targets: torch.Tensor,  # [B, L] f32 in {0, 1}
    label_mask: torch.Tensor,  # [B, L] bool: valid label slots
    focal_alpha: float = -1.0,
    focal_gamma: float = -1.0,
) -> torch.Tensor:
    """Masked mean BCE-with-logits (optax's sigmoid_binary_cross_entropy
    formula); optional focal re-weighting."""
    logits = logits.float()
    targets = targets.float()
    per = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    if focal_gamma > 0:
        p = torch.sigmoid(logits)
        p_t = p * targets + (1 - p) * (1 - targets)
        per = per * (1 - p_t) ** focal_gamma
        if focal_alpha >= 0:
            per = per * (focal_alpha * targets + (1 - focal_alpha) * (1 - targets))
    m = label_mask.float()
    return (per * m).sum() / m.sum().clamp(min=1.0)


def make_train_step(
    cfg: GLiClassConfig,
    max_labels: int,
    compute_dtype=torch.float32,
    focal_alpha: float = -1.0,
    focal_gamma: float = -1.0,
    accum_steps: int = 1,
) -> Callable:
    """Returns step(state, ids, mask, targets, target_mask) -> (state,
    metrics): one optimizer update of ``state`` in place, ``state.step``
    advanced; metrics ``loss``, ``accuracy`` and the global ``grad_norm`` as
    0-d tensors on the device (no host sync). The batch arrays (numpy or
    tensors) move to the params' device.

    Unlike the JAX ``make_train_step`` this takes no optimizer: a torch
    optimizer holds the tensors it updates, so it lives in the state.

    ``accum_steps`` > 1 splits the leading batch axis into that many
    micro-batches and mirrors the JAX step: the gradients and metrics are
    the mean over micro-batches of each one's masked-mean loss (summed, then
    scaled by 1/k), not a mean over all slots; activation memory is one
    micro-batch's."""

    def loss_fn(params, ids, mask, targets, target_mask):
        logits = gliclass_forward(params, ids, mask, cfg, max_labels, compute_dtype, attn_route="xla")
        loss = multilabel_loss(logits, targets, target_mask, focal_alpha, focal_gamma)
        with torch.no_grad():
            preds = (torch.sigmoid(logits) > 0.5).float()
            m = target_mask.float()
            acc = ((preds == targets).float() * m).sum() / m.sum().clamp(min=1.0)
        return loss, acc

    def step(state: TrainState, ids, mask, targets, target_mask):
        leaves = param_leaves(state.params)
        dev = leaves[0].device
        ids, mask, targets, target_mask = (
            torch.as_tensor(a, device=dev) for a in (ids, mask, targets, target_mask)
        )
        B = ids.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
        mb = B // accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        loss = acc = 0.0
        for k in range(accum_steps):
            rows = slice(k * mb, (k + 1) * mb)
            l, a = loss_fn(state.params, ids[rows], mask[rows], targets[rows], target_mask[rows])
            l.backward()
            loss, acc = loss + l.detach(), acc + a
        for t in leaves:
            if t.grad is None:  # unused by the forward: a zero gradient, as JAX gives
                t.grad = torch.zeros_like(t)
            elif accum_steps > 1:
                t.grad.mul_(1.0 / accum_steps)
        if accum_steps > 1:
            loss, acc = loss * (1.0 / accum_steps), acc * (1.0 / accum_steps)
        gnorm = torch.sqrt(sum(t.grad.square().sum() for t in leaves))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc, "grad_norm": gnorm}

    return step
