"""InferenceEngine: shape-bucketed forward steps on one CUDA card.

Replaces the reference's model runtime layer (ORT session + per-batch ``Run``;
reference src/model.c:122-207) with the port's PyTorch forward. Batches are
padded to a (row bucket, seq bucket, label bucket) shape so the set of launch
geometries stays small; the forward is dispatched asynchronously on the
current CUDA stream and the host syncs only when it reads the probabilities.

The engine runs on the card unless the caller passes ``device="cpu"`` (the
tests do); with no GPU and no explicit device it raises rather than fall back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import GLiClassConfig, RuntimeConfig
from .convert.params import params_from_numpy
from .models.gliclass import gliclass_probs
from .ops.fused_ffn import add_nk_weights
from .ops.layers import act_quant
from .tokenization import TokenizedBatch

# fp32 matmuls and convolutions run in full fp32 on the card (TF32 would keep
# about three decimal digits and break fp32 parity with the reference).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


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
    ):
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        rt = self.runtime
        if (rt.dp_size, rt.tp_size, rt.sp_size) != (1, 1, 1):
            raise ValueError("the port runs on one card: dp_size, tp_size and sp_size must be 1")
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[rt.compute_dtype]
        # w8a8 (dynamic per-row INT8 activations on INT8 weights):
        # "int8-dynamic" mirrors the reference's ONNX dynamic quantization.
        self._act_quant = rt.quant_mode == "int8-dynamic"
        params = _place(params, self.device)
        if self._act_quant and self.device.type == "cuda":
            # The [N, K] FFN weights that K2's tensor-core variant reads, made once.
            params = add_nk_weights(params)
        if rt.fuse_qkv:
            params = fuse_qkv_params(params, cfg)
        self.params = params

    # ------------------------------------------------------------------
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor, max_labels: int) -> torch.Tensor:
        with torch.inference_mode(), act_quant(self._act_quant):
            return gliclass_probs(
                self.params, ids, mask, self.cfg, max_labels, self.compute_dtype,
                self.runtime.attn_route,
            )

    def _device_inputs(self, ids: np.ndarray, mask: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(mask, dtype=np.int32)).to(self.device),
        )

    def _row_bucket(self, n: int) -> int:
        """Pad target for the batch dimension: the next power of two, clamped
        at ``runtime.batch_size`` (a full batch never pads past itself; sizes
        above batch_size keep their own count). Bounds the variety of row
        counts to log2(batch_size) per (seq, labels) bucket; padded rows are
        fully masked and cost only device time."""
        bs = self.runtime.batch_size
        if n >= bs:
            return n
        p = 1
        while p < n:
            p *= 2
        return min(p, bs)

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
                    last = self._forward(*self._device_inputs(ids, mask), lb)
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
        return self._forward(*self._device_inputs(ids, mask), max_labels), n

    def run_stacked_async(self, ids: np.ndarray, mask: np.ndarray, max_labels: int):
        """Dispatch ``nb`` same-shape batches ([nb, B, S], padded per
        :meth:`_pad_batch`) in one call; returns the device tensor
        [nb, B, max_labels]. Padded rows are garbage and padded label slots 0;
        the caller slices them off."""
        ids_t, mask_t = self._device_inputs(ids, mask)
        return torch.stack([self._forward(ids_t[i], mask_t[i], max_labels) for i in range(ids.shape[0])])

    # ------------------------------------------------------------------
    @classmethod
    def from_bundle(cls, bundle_path: str, runtime: RuntimeConfig | None = None, device=None) -> "InferenceEngine":
        from .convert import bundle as B

        runtime = runtime or RuntimeConfig()
        cfg = B.load_config(bundle_path)
        params = B.load_params(
            bundle_path, quantized=runtime.quant_mode in ("int8", "int8-dynamic")
        )
        return cls(cfg, params, runtime, device)
