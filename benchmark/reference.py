"""The plain reference: GLiClass over DeBERTa-v3, from the text to the decision.

Plain PyTorch and Python, in fp32 with TF32 off, written from the published
descriptions and independent of the program (it imports nothing of it):

* tokenization: the ``tokenizer.json`` read as data; the added tokens cut
  out, ``Metaspace`` (spaces to "▁", "▁" prepended, split before each
  "▁"), Viterbi over the Unigram pieces' scores (unknown characters scored
  ``min - 10`` and fused), ``[CLS] ... [SEP]``, the first ``max_length``
  ids kept;
* prompt packing: ``<<LABEL>>l1<<LABEL>>l2...<<SEP>>text`` with the labels
  lower-cased in ASCII (the reference CLI's ``preprocessor.c``);
* DeBERTa-v3 (He et al., 2021, and ``transformers``' ``DebertaV2Model``):
  word embeddings and LayerNorm; the relative embeddings LayerNormed once;
  per post-LN layer disentangled attention, content-to-content plus
  content-to-position plus position-to-content over log-bucketed relative
  positions, shared keys, scaled by sqrt(3 d); an exact-erf gelu FFN;
* the GLiClass uni-encoder head: the first token pooled, the ``<<LABEL>>``
  states in order, two features projectors (Linear, gelu, Linear), the dot
  product, the sigmoid;
* the configuration's quantization, worked out again from the fp32
  weights: every dense layer but the embeddings with ``bits``-bit
  symmetric per-output-channel weights (absmax / qmax, rounded half to
  even) and, where ``quant_act`` (as ``int8-dynamic`` states, and not the
  weight-only ``int8``), ``bits``-bit symmetric per-row activations
  quantized on the fly. ``bits=None`` leaves every product in fp32.

The only departure from the published model is the quantization itself,
which the configuration states. The sigmoid's threshold is the decision.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

SPACE = "▁"


# ---------------------------------------------------------------- tokenizer
class PlainTokenizer:
    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model["type"] != "Unigram" or spec["pre_tokenizer"]["type"] != "Metaspace":
            raise ValueError("the plain tokenizer reads a Unigram model under Metaspace")
        if spec.get("normalizer") is not None:
            raise ValueError("the plain tokenizer reads no normalizer")
        self.pieces = {}
        self.scores = []
        for i, (p, s) in enumerate(model["vocab"]):
            self.pieces[p] = i
            self.scores.append(float(s))
        self.unk = model["unk_id"]
        self.unk_score = min(self.scores) - 10.0
        self.longest = max(len(p) for p in self.pieces)
        self.added = {t["content"]: t["id"] for t in spec["added_tokens"]}
        for t in spec["added_tokens"]:  # tokenizers' ids: the model's, else the next above it
            if t["content"] in self.pieces:
                self.added[t["content"]] = self.pieces[t["content"]]
        self.cls, self.sep = self.added["[CLS]"], self.added["[SEP]"]
        self._split = sorted(self.added, key=len, reverse=True)

    def _cut_added(self, text: str) -> list[tuple[str, int | None]]:
        out, buf, i = [], [], 0
        while i < len(text):
            for tok in self._split:
                if text.startswith(tok, i):
                    if buf:
                        out.append(("".join(buf), None))
                        buf = []
                    out.append((tok, self.added[tok]))
                    i += len(tok)
                    break
            else:
                buf.append(text[i])
                i += 1
        if buf:
            out.append(("".join(buf), None))
        return out

    def _viterbi(self, word: str) -> list[int]:
        n = len(word)
        best = [-math.inf] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if back[i] is None and i > 0:
                continue
            has_single = False
            for j in range(i + 1, min(n, i + self.longest) + 1):
                pid = self.pieces.get(word[i:j])
                if pid is None:
                    continue
                if j == i + 1:
                    has_single = True
                s = best[i] + self.scores[pid]
                if back[j] is None or s > best[j]:
                    best[j], back[j] = s, (i, pid)
            if not has_single:
                s = best[i] + self.unk_score
                if back[i + 1] is None or s > best[i + 1]:
                    best[i + 1], back[i + 1] = s, (i, self.unk)
        ids: list[int] = []
        end = n
        while end > 0:
            start, pid = back[end]
            if not (pid == self.unk and ids and ids[-1] == self.unk):  # fuse unknown runs
                ids.append(pid)
            end = start
        return ids[::-1]

    def encode(self, text: str, max_length: int) -> list[int]:
        ids = [self.cls]
        for seg, tid in self._cut_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            s = seg.replace(" ", SPACE)
            if not s.startswith(SPACE):
                s = SPACE + s
            cuts = [k for k, c in enumerate(s) if c == SPACE] + [len(s)]
            for a, b in zip(cuts[:-1], cuts[1:]):
                ids.extend(self._viterbi(s[a:b]))
        ids.append(self.sep)
        return ids[:max_length]


def ascii_lower(s: str) -> str:
    return "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in s)


def pack(text: str, labels, label_tag: str = "<<LABEL>>", sep_tag: str = "<<SEP>>") -> str:
    return "".join(label_tag + ascii_lower(l) for l in labels) + sep_tag + text


# -------------------------------------------------------------------- model
def log_bucket(rel: torch.Tensor, buckets: int, max_position: int) -> torch.Tensor:
    """DeBERTa-v2's make_log_bucket_position."""
    sign = torch.sign(rel)
    mid = buckets // 2
    abs_pos = torch.where((rel < mid) & (rel > -mid), torch.full_like(rel, mid - 1), rel.abs())
    log_pos = torch.ceil(torch.log(abs_pos.double() / mid) / math.log((max_position - 1) / mid) * (mid - 1)) + mid
    return torch.where(abs_pos <= mid, rel, (log_pos * sign).long())


def quantize_weight(w: torch.Tensor, bits: int | None):
    """(integer-valued fp32 weight, per-output-channel scale) over dim -2."""
    if bits is None:
        return w, None
    qmax = 2 ** (bits - 1) - 1
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -qmax, qmax), s


class Dense:
    def __init__(self, w: torch.Tensor, b: torch.Tensor, bits: int | None, quant_act: bool = True):
        self.bits, self.quant_act = bits, quant_act
        self.q, self.s = quantize_weight(w.float(), bits)
        self.b = b.float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return x @ self.q + self.b
        if not self.quant_act:
            return (x @ self.q) * self.s + self.b
        qmax = 2 ** (self.bits - 1) - 1
        sx = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / qmax, min=1e-10)
        xq = torch.clamp(torch.round(x / sx), -qmax, qmax)
        return (xq @ self.q) * sx * self.s + self.b


def layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


class PlainGLiClass:
    """The model of a configuration over the fp32 weight tree; ``bits`` and
    ``quant_act`` as the module docstring says."""

    def __init__(self, weights: dict, model: dict, bits: int | None, quant_act: bool = True):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.bb = bb = model["backbone"]
        self.eps = bb["layer_norm_eps"]
        self.h = bb["num_attention_heads"]
        self.L = bb["num_hidden_layers"]
        self.buckets = bb["position_buckets"]
        self.max_pos = bb["max_relative_positions"] if bb["max_relative_positions"] > 0 else bb["max_position_embeddings"]
        w = weights["backbone"]
        self.emb = w["embeddings"]
        self.rel = w["rel_embeddings"].float()
        self.rel_ln = w["rel_ln"]
        la = w["layers"]
        self.layers = []
        for i in range(self.L):
            dense = lambda p: Dense(p["w"][i], p["b"][i], bits, quant_act)  # noqa: E731
            d = {n: dense(la["attn"][n]) for n in ("q", "k", "v", "o")}
            d["up"], d["down"] = dense(la["ffn"]["up"]), dense(la["ffn"]["down"])
            d["ln1"] = {k: v[i] for k, v in la["attn"]["ln"].items()}
            d["ln2"] = {k: v[i] for k, v in la["ffn"]["ln"].items()}
            self.layers.append(d)
        hd = weights["head"]
        self.proj = {
            n: tuple(Dense(hd[n][m]["w"], hd[n][m]["b"], bits, quant_act) for m in ("linear_1", "linear_2"))
            for n in ("text_projector", "classes_projector")
        }

    def _attention(self, d, x, rel, mask):
        B, S, H = x.shape
        h, dh = self.h, H // self.h
        split = lambda t: t.view(*t.shape[:-1], h, dh).transpose(-2, -3)
        q, k, v = (split(d[n](x)) for n in ("q", "k", "v"))  # [B, h, S, d]
        pq, pk = split(d["q"](rel)), split(d["k"](rel))  # [h, 2K, d]
        pos = torch.arange(S, device=x.device)
        idx = torch.clamp(log_bucket(pos[:, None] - pos[None, :], self.buckets, self.max_pos) + self.buckets,
                          0, 2 * self.buckets - 1)  # [S(i), S(j)]
        scores = q @ k.transpose(-1, -2)
        c2p = torch.gather(q @ pk.transpose(-1, -2), -1, idx.expand(B, h, S, S))
        p2c = torch.gather(k @ pq.transpose(-1, -2), -1, idx.t().expand(B, h, S, S)).transpose(-1, -2)
        scores = (scores + c2p + p2c) / math.sqrt(3 * dh)
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        scores = scores.masked_fill(~pair, torch.finfo(torch.float32).min)
        ctx = torch.softmax(scores, dim=-1) @ v
        return d["o"](ctx.transpose(1, 2).reshape(B, S, H))

    def logits(self, ids: torch.Tensor, mask: torch.Tensor, label_id: int, n_labels: int) -> torch.Tensor:
        """ids, mask [B, S] (mask bool) -> fp32 logits [B, n_labels]."""
        x = self.emb["word"].float()[ids]
        x = layer_norm(x, self.emb["ln"], self.eps) * mask[..., None]
        rel = layer_norm(self.rel, self.rel_ln, self.eps)
        for d in self.layers:
            x = layer_norm(x + self._attention(d, x, rel, mask), d["ln1"], self.eps)
            x = layer_norm(x + d["down"](F.gelu(d["up"](x))), d["ln2"], self.eps)
        text = x[:, 0]
        is_label = ids == label_id
        rows = []
        for b in range(ids.shape[0]):
            lab = x[b, is_label[b]][:n_labels]
            rows.append(lab)
        labels = torch.stack(rows)  # [B, n_labels, H]
        t1, t2 = self.proj["text_projector"]
        c1, c2 = self.proj["classes_projector"]
        text = t2(F.gelu(t1(text)))
        labels = c2(F.gelu(c1(labels)))
        return torch.einsum("bh,blh->bl", text, labels)


def logits(model: PlainGLiClass, tok: PlainTokenizer, items, max_length: int, device,
           tokens_per_block: int = 65536) -> list[np.ndarray]:
    """``items``: [(text, labels)] -> one fp32 logit vector per item (the
    decision is ``sigmoid(logit) > threshold``), computed in blocks of
    similar length (padding is masked)."""
    label_id = tok.added["<<LABEL>>"]
    enc = [tok.encode(pack(t, labels), max_length) for t, labels in items]
    order = sorted(range(len(items)), key=lambda i: (len(items[i][1]), len(enc[i])))
    out: list[np.ndarray | None] = [None] * len(items)
    i = 0
    with torch.no_grad():
        while i < len(order):
            n_lab = len(items[order[i]][1])
            j = i
            while j < len(order) and len(items[order[j]][1]) == n_lab and (j - i + 1) * len(enc[order[j]]) <= tokens_per_block:
                j += 1
            j = max(j, i + 1)
            blk = order[i:j]
            S = max(len(enc[k]) for k in blk)
            ids = torch.zeros((len(blk), S), dtype=torch.long)
            mask = torch.zeros((len(blk), S), dtype=torch.bool)
            for r, k in enumerate(blk):
                ids[r, :len(enc[k])] = torch.tensor(enc[k])
                mask[r, :len(enc[k])] = True
            z = model.logits(ids.to(device), mask.to(device), label_id, n_lab).cpu().numpy()
            for r, k in enumerate(blk):
                out[k] = z[r]
            i = j
    return out
