"""GLiClass fine-tuning: the multi-label loss and the train step, on one
device or over a (dp, sp, tp) mesh of ``torch.distributed`` ranks.

The port of ``gliclass.c_tpu.training.train``. The loss is multi-label BCE-with-logits over
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

The sharded step (:func:`make_sharded_train_step`) gives one process's
update. Each data rank takes its rows of the batch (:func:`shard_batch`);
the loss divides by the valid slots of the whole batch, and the gradients
are summed over the data group. Each model rank holds its shards
(:func:`init_sharded_train_state`); their gradients come through the
collectives' f/g functions, the gradient norm sums the sharded leaves over
the model group and counts each replicated leaf once, and the optimizer,
elementwise, updates the local shards. Each seq rank encodes its block of
the tokens at a length sp divides (``models.gliclass.encode_backbone``)
and runs the head on the whole gathered sequence; every gather's backward
sums the ranks' gradients of each block, so a seq rank's encoder gradients
are sp times its tokens' part and its head gradients the whole: their sum
over the seq group divided by sp is the batch's gradient.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..config import GLiClassConfig
from ..convert.params import params_from_numpy
from ..engine import resolve_device
from ..models.gliclass import gliclass_forward
from ..parallel.collectives import all_reduce_sum, model_parallel, seq_parallel
from ..parallel.mesh import Mesh
from ..parallel.sharding import ShardPlan, apply_plan, local_shard_dims, shard_plan

Params = dict[str, Any]


@dataclass
class TrainState:
    params: Params  # fp32 leaves that require grad (this rank's shards on a mesh)
    optimizer: torch.optim.Optimizer  # over param_leaves(params), in that order
    step: int
    mesh: Mesh | None = None  # the mesh of a sharded state (init_sharded_train_state)
    plan: ShardPlan | None = None  # how its params are cut over the model axis


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
    tree = _own(params_from_numpy(params, "cpu", torch.float32), resolve_device(device))
    return TrainState(tree, optimizer(param_leaves(tree)), 0)


def _own(node, device: torch.device):
    """fp32 copies on ``device`` that require grad (on the CPU
    params_from_numpy shares the caller's arrays)."""
    if isinstance(node, dict):
        return {k: _own(v, device) for k, v in node.items()}
    if not node.is_floating_point():
        raise ValueError("training needs unquantized weights (an INT8 leaf has no gradient)")
    return node.to(device, copy=True).requires_grad_(True)


def init_sharded_train_state(params: Params, optimizer: Callable[[list], torch.optim.Optimizer], mesh: Mesh,
                             cfg: GLiClassConfig | None = None) -> TrainState:
    """:func:`init_train_state` on ``mesh``: this rank's fp32 shards
    (``parallel.sharding``, on ``mesh.device``), each requiring grad, with
    the optimizer built over them, so its moments are shards too. ``cfg``
    gives the head counts the attention is cut by (the JAX function reads
    the tree alone: XLA may cut anywhere; without ``cfg`` the attention stays
    replicated). A GQA cut that leaves ranks sharing a kv head is refused:
    their partial gradients of it would need a reduction of their own."""
    plan = shard_plan(params, mesh.tp, cfg)
    if plan.kv_share > 1:
        raise ValueError(
            f"tp={mesh.tp} leaves {plan.kv_share} ranks on each kv head; train at a tp that divides the kv heads"
        )
    local = apply_plan(params_from_numpy(params, "cpu", torch.float32), plan, mesh.model_rank)
    tree = _own(local, mesh.device)
    return TrainState(tree, optimizer(param_leaves(tree)), 0, mesh, plan)


def shard_batch(mesh: Mesh, ids, mask, *rest):
    """This data rank's rows of the batch arrays (numpy or tensors; the
    batch axis first): a contiguous slice of B / dp rows. The token axis is
    cut inside the forward, as the JAX function's ``seq_sharding`` cuts it
    (over seq where sp divides S, else replicated): every seq rank keeps the
    whole rows, since the head reads every token's id."""
    B = ids.shape[0]
    if B % mesh.dp:
        raise ValueError(f"batch {B} not divisible by dp {mesh.dp}")
    n = B // mesh.dp
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    out = tuple(a[rows] for a in (ids, mask, *rest))
    return out if len(out) > 1 else out[0]


def multilabel_loss(
    logits: torch.Tensor,  # [B, L] f32 (padded slots are NEG_LOGIT)
    targets: torch.Tensor,  # [B, L] f32 in {0, 1}
    label_mask: torch.Tensor,  # [B, L] bool: valid label slots
    focal_alpha: float = -1.0,
    focal_gamma: float = -1.0,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked mean BCE-with-logits (optax's sigmoid_binary_cross_entropy
    formula); optional focal re-weighting. ``count``: the number of valid
    slots the mean divides by (default this batch's; a data rank passes the
    whole batch's)."""
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
    return (per * m).sum() / (m.sum() if count is None else count).clamp(min=1.0)


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
    return _make_step(cfg, max_labels, compute_dtype, focal_alpha, focal_gamma, accum_steps, None)


def make_sharded_train_step(
    cfg: GLiClassConfig,
    max_labels: int,
    mesh: Mesh,
    compute_dtype=torch.float32,
    focal_alpha: float = -1.0,
    focal_gamma: float = -1.0,
    accum_steps: int = 1,
) -> Callable:
    """:func:`make_train_step` over ``mesh`` (the JAX function's arguments
    without the optimizer, which lives in the state): the state from
    :func:`init_sharded_train_state`, the batch from :func:`shard_batch`.
    Every rank calls it in step with the others; the metrics are the whole
    batch's on every rank. With ``accum_steps`` > 1, micro-batch k is the
    union of each data rank's k-th slice of its rows."""
    return _make_step(cfg, max_labels, compute_dtype, focal_alpha, focal_gamma, accum_steps, mesh)


def _make_step(cfg, max_labels, compute_dtype, focal_alpha, focal_gamma, accum_steps, mesh):
    data = mesh.data_group if mesh is not None else None

    def loss_fn(params, ids, mask, targets, target_mask):
        logits = gliclass_forward(params, ids, mask, cfg, max_labels, compute_dtype, attn_route="xla")
        # The valid slots of the whole micro-batch, over the data ranks.
        count = all_reduce_sum(target_mask.float().sum(), data) if data is not None else None
        loss = multilabel_loss(logits, targets, target_mask, focal_alpha, focal_gamma, count)
        with torch.no_grad():
            preds = (torch.sigmoid(logits) > 0.5).float()
            m = target_mask.float()
            acc = ((preds == targets).float() * m).sum() / (m.sum() if count is None else count).clamp(min=1.0)
        return loss, acc

    def _sum_grads(leaves, group, extra=(), scale=None):
        """Sum the leaves' gradients (and ``extra`` scalars) over ``group``,
        times ``scale``; returns the summed extras."""
        flat = all_reduce_sum(torch.cat([t.grad.reshape(-1) for t in leaves] + [e.reshape(1) for e in extra]), group)
        if scale is not None:
            flat.mul_(scale)
        off = 0
        for t in leaves:
            t.grad.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        return flat[off:]

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
        plan = state.plan or ShardPlan(1)
        tp = model_parallel(mesh.model_group, plan.pairs) if mesh is not None else contextlib.nullcontext()
        sp = seq_parallel(mesh.seq_group) if mesh is not None else contextlib.nullcontext()
        state.optimizer.zero_grad(set_to_none=True)
        loss = acc = 0.0
        with tp, sp:
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
        if mesh is not None and mesh.sp > 1 and ids.shape[1] % mesh.sp == 0:
            # The tokens ran sharded: the seq ranks' sum over sp (see the module docstring).
            _sum_grads(leaves, mesh.seq_group, scale=1.0 / mesh.sp)
        if data is not None:
            # Each rank's loss divides by the whole batch's slots: the sums over
            # the data ranks are the whole batch's loss, accuracy and gradients.
            loss, acc = _sum_grads(leaves, data, (loss, acc))
        gnorm = torch.sqrt(_grad_sq(state, leaves))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc, "grad_norm": gnorm}

    return step


def _grad_sq(state: TrainState, leaves: list[torch.Tensor]) -> torch.Tensor:
    """The squared global gradient norm: on a mesh, the sharded leaves'
    squares summed over the model group, each replicated leaf once."""
    if state.plan is None or not state.plan.pairs:
        return sum(t.grad.square().sum() for t in leaves)
    dims = param_leaves(local_shard_dims(state.params, state.plan))
    zero = torch.zeros((), device=leaves[0].device)
    sharded = sum((t.grad.square().sum() for t, d in zip(leaves, dims) if d is not None), zero)
    replicated = sum((t.grad.square().sum() for t, d in zip(leaves, dims) if d is None), zero)
    return all_reduce_sum(sharded, state.mesh.model_group) + replicated
