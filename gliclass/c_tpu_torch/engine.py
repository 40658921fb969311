"""InferenceEngine: shape-bucketed forward steps on one CUDA card.

Replaces the reference's model runtime layer (ORT session + per-batch ``Run``;
reference src/model.c:122-207) with the port's PyTorch forward. Batches are
padded to a (row bucket, seq bucket, label bucket) shape so the set of launch
geometries stays small; the forward is dispatched asynchronously on the
current CUDA stream and the host syncs only when it reads the probabilities.

The engine runs on the card unless the caller passes ``device="cpu"`` (the
tests do); with no GPU and no explicit device it raises rather than fall back.

Over a mesh of ``dp * sp * tp`` ranks (``parallel.mesh``; ``runtime.
dp_size``, ``sp_size`` and ``tp_size`` over an initialised world) every
rank builds the same engine and calls the same entry with the same inputs
(SPMD, the JAX package's multi-process lockstep). Each holds its shards of
the model (``parallel.sharding``), runs its contiguous slice of the batch
rows (the row bucket is a multiple of dp) and, at a seq bucket that sp
divides, its block of the tokens (``models.gliclass.encode_backbone``; other
buckets run seq-replicated, as the JAX package's ``seq_sharding``), and
gathers the whole [B, L] probabilities over its data group, as JAX's
replicated outputs.

Serving over a mesh is lockstep: one rank leads (:meth:`InferenceEngine.
lead`: rank 0 runs the scheduler and the HTTP server) and, before every
forward, broadcasts a header (op code, B, S, max_labels) and the padded ids
and mask over the mesh's gloo control group; every other rank runs
:meth:`InferenceEngine.follow`, which receives each header and runs the
same forward, until the leader's :meth:`InferenceEngine.stop_followers`.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import traceback
from typing import Any

import numpy as np
import torch

from .config import GLiClassConfig, RuntimeConfig
from .convert.params import params_from_numpy
from .models.gliclass import gliclass_forward, gliclass_probs
from .ops import fused_attention, fused_ffn
from .ops.fused_ffn import add_nk_weights
from .ops.layers import act_quant
from .parallel.collectives import all_gather_rows, broadcast, model_parallel, seq_parallel
from .parallel.mesh import Mesh, make_mesh, single_device_mesh
from .parallel.sharding import apply_plan, shard_plan
from .tokenization import TokenizedBatch
from .utils import metrics

# fp32 matmuls and convolutions run in full fp32 on the card (TF32 would keep
# about three decimal digits and break fp32 parity with the reference).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# Op codes of the lockstep header [op, B, S, max_labels].
OP_FORWARD, OP_STOP = 1, 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the GPU unless device='cpu' is given"
            )
        return torch.device("cuda")
    return torch.device(device)


def _concat_dense(parts: list[Params]) -> Params | None:
    """Concatenate dense params along the output dim ([K, N_i] -> [K, sum N_i],
    stacked [L, K, N] too); per-output-channel INT8 scales concatenate
    exactly. None if the parts are not homogeneous dense params."""
    wk = "w_q" if "w_q" in parts[0] else "w"
    if not all(wk in p for p in parts):
        return None
    fused: Params = {wk: torch.cat([p[wk] for p in parts], dim=-1)}
    if wk == "w_q":
        if not all("scale" in p for p in parts):
            return None
        fused["scale"] = torch.cat([p["scale"] for p in parts], dim=-1)
    if all(p.get("b") is not None for p in parts):
        fused["b"] = torch.cat([p["b"] for p in parts], dim=-1)
    elif any(p.get("b") is not None for p in parts):
        return None  # mixed bias/no-bias: keep unfused
    return fused


def fuse_qkv_params(params: Params, cfg: GLiClassConfig) -> Params:
    """Merge each attention block's q/k/v dense params into one "qkv" param
    ([H, 3H]: one wide matmul instead of three). Math-identical (disjoint
    output columns). Skipped when the position projections need separate q/k
    weights (relative attention without share_att_key and without pos_q/pos_k)."""
    bb = cfg.backbone
    if bb.model_type != "deberta-v2":
        return params
    attn = params["backbone"]["layers"]["attn"]
    if "qkv" in attn or not all(k in attn for k in ("q", "k", "v")):
        return params
    if bb.relative_attention and not bb.share_att_key and not ("pos_q" in attn and "pos_k" in attn):
        return params
    fused = _concat_dense([attn["q"], attn["k"], attn["v"]])
    if fused is None:
        return params
    new_attn = {k: v for k, v in attn.items() if k not in ("q", "k", "v")}
    new_attn["qkv"] = fused
    layers = dict(params["backbone"]["layers"], attn=new_attn)
    backbone = dict(params["backbone"], layers=layers)
    return dict(params, backbone=backbone)


def _place(tree: Any, device: torch.device) -> Any:
    """numpy leaves -> tensors on ``device``; tensor leaves are moved."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return params_from_numpy(tree, device)


class InferenceEngine:
    def __init__(
        self,
        cfg: GLiClassConfig,
        params: Params,
        runtime: RuntimeConfig | None = None,
        device=None,
        mesh: Mesh | None = None,
    ):
        """``mesh``: this rank's mesh; by default one of ``runtime.dp_size``
        x ``runtime.sp_size`` x ``runtime.tp_size`` ranks over the
        initialised world (a single device when all are 1). The tree is
        sharded before q/k/v are fused and before the [N, K] FFN weights are
        made."""
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        rt = self.runtime
        if mesh is None:
            dev = resolve_device(device)
            n = rt.dp_size * rt.sp_size * rt.tp_size
            mesh = single_device_mesh(dev) if n == 1 else make_mesh(rt.dp_size, rt.tp_size, rt.sp_size, dev)
        self.mesh = mesh
        self.device = mesh.device if device is None else resolve_device(device)
        self.compute_dtype = _DTYPES[rt.compute_dtype]
        # w8a8 (dynamic per-row INT8 activations on INT8 weights):
        # "int8-dynamic" mirrors the reference's ONNX dynamic quantization.
        self._act_quant = rt.quant_mode == "int8-dynamic"
        self.plan = shard_plan(params, mesh.tp, cfg)
        if mesh.tp > 1:
            # Cut on the host, then place only this rank's shards.
            params = apply_plan(_place(params, torch.device("cpu")), self.plan, mesh.model_rank)
        params = _place(params, self.device)
        if self._act_quant and self.device.type == "cuda":
            # The [N, K] FFN weights that K2's tensor-core variant reads, made once.
            params = add_nk_weights(params)
        if rt.fuse_qkv:
            params = fuse_qkv_params(params, cfg)
        self.params = params
        # Lockstep serving: whether this rank leads its mesh, and the lock that
        # keeps each header and its forward together when several threads
        # issue forwards.
        self._leading = False
        self._lock = threading.Lock()
        self._logits = False

    @contextlib.contextmanager
    def returning_logits(self):
        """Within this block every forward returns the logits before the
        sigmoid (fp32 [B, max_labels]; padded label slots -1e4) where it
        returns probabilities otherwise: the same params, quantization,
        dtype, route and buckets, one op fewer. The golden-logit check reads
        them (``utils.eval.golden_logit_check``). Over a mesh every rank
        enters it, as every rank runs ``selftest``."""
        self._logits = True
        try:
            yield
        finally:
            self._logits = False

    # ------------------------------------------------------------------
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor, max_labels: int) -> torch.Tensor:
        m = self.mesh
        forward = gliclass_forward if self._logits else gliclass_probs
        with (torch.inference_mode(), act_quant(self._act_quant), model_parallel(m.model_group, self.plan.pairs),
              seq_parallel(m.seq_group)):
            if m.dp > 1:  # this data rank's contiguous rows
                n = ids.shape[0] // m.dp
                ids, mask = ids[m.data_rank * n:(m.data_rank + 1) * n], mask[m.data_rank * n:(m.data_rank + 1) * n]
            out = forward(
                self.params, ids, mask, self.cfg, max_labels, self.compute_dtype,
                self.runtime.attn_route,
            )
            return all_gather_rows(out, m.data_group)

    def _step(self, ids: np.ndarray, mask: np.ndarray, max_labels: int, dev_inputs=None) -> torch.Tensor:
        """One forward of host arrays ``ids``/``mask`` [B, S] (``dev_inputs``:
        them on the device already); as the leader, broadcast first. With
        the recorder on, a ``forward`` span around all of it: the shape, the
        real rows and their tokens (the mask's count; a padded row holds
        one pad token) and the K1 and K2 launches it made."""
        rec = metrics.RECORDER
        if rec is None:
            with self._lock:
                if self._leading:
                    self._send(OP_FORWARD, ids, mask, max_labels)
                return self._forward(*(dev_inputs or self._device_inputs(ids, mask)), max_labels)
        per_row = np.asarray(mask).sum(axis=1)
        real = per_row > 1
        k1, k2 = fused_attention.launches, fused_ffn.launches
        with rec.span("forward", rows=int(ids.shape[0]), seq=int(ids.shape[1]), labels=int(max_labels),
                      real_rows=int(real.sum()), real_tokens=int(per_row[real].sum())) as sp, self._lock:
            if self._leading:
                self._send(OP_FORWARD, ids, mask, max_labels)
            out = self._forward(*(dev_inputs or self._device_inputs(ids, mask)), max_labels)
            sp.attrs.update(k1=fused_attention.launches - k1, k2=fused_ffn.launches - k2)
        return out

    # ------------------------------------------------------------------
    # Lockstep serving over a multi-rank mesh
    # ------------------------------------------------------------------
    def lead(self) -> None:
        """Make this rank (global rank 0) the leader of its mesh: from now
        on every forward of :meth:`run`, :meth:`run_async`,
        :meth:`run_stacked_async` and :meth:`warmup` first broadcasts its
        inputs to the followers. A no-op on one rank."""
        if self.mesh.size == 1:
            return
        if self.mesh.control_group is None:
            raise ValueError("lead: the mesh has no control group (parallel.mesh.make_mesh makes one)")
        self._leading = True

    def follow(self) -> int:
        """Every rank but the leader: run the leader's forwards, one for each
        header received, until the stop header (returns 0). A forward that
        raises is reported on stderr and the loop goes on, as the leader
        answers that batch with the error and goes on; a failed broadcast
        (the leader gone: gloo reports the closed connection) raises."""
        group = self.mesh.control_group
        header = torch.zeros(4, dtype=torch.int64)
        while True:
            op, B, S, max_labels = broadcast(header, group).tolist()
            if op == OP_STOP:
                return 0
            data = broadcast(torch.empty((2, B, S), dtype=torch.int32), group)
            try:
                self._forward(*(t.to(self.device) for t in data), max_labels)
            except Exception:  # the leader answers the batch with the error; stay in step
                traceback.print_exc(file=sys.stderr)

    def stop_followers(self) -> None:
        """As the leader: end every follower's :meth:`follow` (idempotent)."""
        with self._lock:
            if self._leading:
                self._leading = False
                broadcast(torch.tensor([OP_STOP, 0, 0, 0], dtype=torch.int64), self.mesh.control_group)

    def _send(self, op: int, ids: np.ndarray, mask: np.ndarray, max_labels: int) -> None:
        group = self.mesh.control_group
        B, S = ids.shape
        broadcast(torch.tensor([op, B, S, max_labels], dtype=torch.int64), group)
        broadcast(torch.from_numpy(np.stack([ids, mask]).astype(np.int32, copy=False)), group)

    def _device_inputs(self, ids: np.ndarray, mask: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(mask, dtype=np.int32)).to(self.device),
        )

    def _row_bucket(self, n: int) -> int:
        """Pad target for the batch dimension: the next power of two, clamped
        at ``runtime.batch_size`` (a full batch never pads past itself; sizes
        above batch_size keep their own count), rounded up to a multiple of
        dp. Bounds the variety of row counts to log2(batch_size) per (seq,
        labels) bucket; padded rows are fully masked and cost only device
        time."""
        bs = self.runtime.batch_size
        if n >= bs:
            target = n
        else:
            p = 1
            while p < n:
                p *= 2
            target = min(p, bs)
        return -(-target // self.mesh.dp) * self.mesh.dp

    def _pad_batch(self, batch: TokenizedBatch) -> tuple[np.ndarray, np.ndarray, int]:
        """Pad the batch dim to the row bucket; padded rows are masked except
        one pad token, so no attention row is empty."""
        n = batch.batch_size
        target = self._row_bucket(n)
        if target == n:
            return batch.input_ids, batch.attention_mask, n
        ids = np.zeros((target, batch.seq_length), dtype=batch.input_ids.dtype)
        mask = np.zeros((target, batch.seq_length), dtype=batch.attention_mask.dtype)
        ids[:n] = batch.input_ids
        ids[n:, 0] = self.cfg.backbone.pad_token_id
        mask[:n] = batch.attention_mask
        mask[n:, 0] = 1
        return ids, mask, n

    def stack_batches(
        self, batches: list[TokenizedBatch]
    ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """Stack same-seq-length batches into [nb, B0, S] host arrays for
        :meth:`run_stacked_async` (padded rows follow :meth:`_pad_batch`).
        Returns (ids, mask, valid-row counts)."""
        B0 = self._row_bucket(max(b.batch_size for b in batches))
        S = batches[0].seq_length
        ids = np.zeros((len(batches), B0, S), dtype=np.int32)
        mask = np.zeros((len(batches), B0, S), dtype=np.int32)
        rows: list[int] = []
        for i, b in enumerate(batches):
            n = b.batch_size
            ids[i, :n] = b.input_ids
            mask[i, :n] = b.attention_mask
            if n < B0:
                ids[i, n:, 0] = self.cfg.backbone.pad_token_id
                mask[i, n:, 0] = 1
            rows.append(n)
        return ids, mask, rows

    def warmup(self, seq_buckets=None, label_buckets=None, max_seq: int | None = None, log=None) -> int:
        """Run every (seq bucket, power-of-two row bucket, label bucket) step
        once, so the kernel build and the library handles are paid before
        traffic arrives. Each step goes through the forward the engine serves
        it with, so every bucket runs the attention route (``runtime.
        attn_route``, resolved per shape) that it will take. Stacked launches
        are loops of single steps, so the singles cover them. Returns the
        number of steps run."""
        rt = self.runtime
        seqs = [s for s in (seq_buckets or rt.seq_buckets) if max_seq is None or s <= max_seq]
        labels = list(label_buckets or rt.label_buckets)
        rows = sorted({self._row_bucket(r) for r in [2**i for i in range(rt.batch_size.bit_length())] + [rt.batch_size]})
        pad = self.cfg.backbone.pad_token_id
        n = 0
        last = None
        for s in seqs:
            for lb in labels:
                for b in rows:
                    ids = np.full((b, s), pad, dtype=np.int32)
                    mask = np.zeros((b, s), dtype=np.int32)
                    mask[:, 0] = 1
                    last = self._step(ids, mask, lb)
                    n += 1
            if log:
                log(f"warmup: seq {s} done ({n} steps)")
        if last is not None:
            last.cpu()
        return n

    def run(self, batch: TokenizedBatch, max_labels: int) -> np.ndarray:
        """Tokenized batch -> per-label probabilities [batch, max_labels] (f32).
        Padded label slots are exactly 0."""
        dev, n = self.run_async(batch, max_labels)
        return dev.cpu().numpy()[:n]

    def run_async(self, batch: TokenizedBatch, max_labels: int):
        """Dispatch without waiting; returns (device tensor [B, L], n_valid).
        The host can tokenize the next batch while the card computes."""
        ids, mask, n = self._pad_batch(batch)
        return self._step(ids, mask, max_labels), n

    def run_stacked_async(self, ids: np.ndarray, mask: np.ndarray, max_labels: int):
        """Dispatch ``nb`` same-shape batches ([nb, B, S], padded per
        :meth:`_pad_batch`) in one call; returns the device tensor
        [nb, B, max_labels]. Padded rows are garbage and padded label slots 0;
        the caller slices them off."""
        ids_t, mask_t = self._device_inputs(ids, mask)
        return torch.stack([self._step(ids[i], mask[i], max_labels, (ids_t[i], mask_t[i]))
                            for i in range(ids.shape[0])])

    # ------------------------------------------------------------------
    @classmethod
    def from_bundle(cls, bundle_path: str, runtime: RuntimeConfig | None = None, device=None,
                    mesh: Mesh | None = None) -> "InferenceEngine":
        from .convert import bundle as B

        runtime = runtime or RuntimeConfig()
        cfg = B.load_config(bundle_path)
        params = B.load_params(
            bundle_path, quantized=runtime.quant_mode in ("int8", "int8-dynamic")
        )
        return cls(cfg, params, runtime, device, mesh)
