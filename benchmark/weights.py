"""Random GLiClass weights made on the device from the seed.

One ``torch.Generator`` on the device draws every leaf in a single
``randn`` call, in fp32, the type the program's set-up quantizes from; the
leaves are views of that buffer, scaled. The tree is the layout that the
program and the plain reference both read (per-layer leaves stacked on a
leading [L] axis):

    backbone: embeddings {word [V, H], ln}, rel_embeddings [2 * buckets, H],
              rel_ln, layers {attn {q, k, v, o: {w [L, H, H], b [L, H]}, ln},
                              ffn {up {w [L, H, I], b}, down {w [L, I, H], b}, ln}}
    head:     text_projector / classes_projector {linear_1 [H, 4H], linear_2 [4H, H]}

Weights are N(0, w_std) (the head's projectors N(0, head_w_std)), biases N(0, b_std), LayerNorm scales 1 + N(0,
ln_std) and biases N(0, ln_std), embeddings N(0, emb_std): the
configuration's ``init`` block.
"""

from __future__ import annotations

import torch


def leaf_shapes(model: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf, kind one of w, head_w, b,
    ln_scale, ln_bias, emb; paths are "/"-joined keys."""
    bb = model["backbone"]
    H, I, L = bb["hidden_size"], bb["intermediate_size"], bb["num_hidden_layers"]
    V, span, Hh = bb["vocab_size"], bb["position_buckets"], model["hidden_size"]
    out = [("backbone/embeddings/word", (V, H), "emb")]
    out += [("backbone/embeddings/ln/scale", (H,), "ln_scale"), ("backbone/embeddings/ln/bias", (H,), "ln_bias")]
    out += [("backbone/rel_embeddings", (2 * span, H), "emb")]
    out += [("backbone/rel_ln/scale", (H,), "ln_scale"), ("backbone/rel_ln/bias", (H,), "ln_bias")]
    for n in ("q", "k", "v", "o"):
        out += [(f"backbone/layers/attn/{n}/w", (L, H, H), "w"), (f"backbone/layers/attn/{n}/b", (L, H), "b")]
    out += [("backbone/layers/attn/ln/scale", (L, H), "ln_scale"), ("backbone/layers/attn/ln/bias", (L, H), "ln_bias")]
    out += [("backbone/layers/ffn/up/w", (L, H, I), "w"), ("backbone/layers/ffn/up/b", (L, I), "b")]
    out += [("backbone/layers/ffn/down/w", (L, I, H), "w"), ("backbone/layers/ffn/down/b", (L, H), "b")]
    out += [("backbone/layers/ffn/ln/scale", (L, H), "ln_scale"), ("backbone/layers/ffn/ln/bias", (L, H), "ln_bias")]
    for proj in ("text_projector", "classes_projector"):
        out += [(f"head/{proj}/linear_1/w", (Hh, 4 * Hh), "head_w"), (f"head/{proj}/linear_1/b", (4 * Hh,), "b")]
        out += [(f"head/{proj}/linear_2/w", (4 * Hh, Hh), "head_w"), (f"head/{proj}/linear_2/b", (Hh,), "b")]
    return out


def make_weights(model: dict, init: dict, seed: int, device) -> dict:
    """The nested fp32 tree on ``device``, a pure function of ``seed``."""
    shapes = leaf_shapes(model)
    total = sum(_numel(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    std = {"w": init["w_std"], "head_w": init["head_w_std"], "b": init["b_std"], "ln_scale": init["ln_std"],
           "ln_bias": init["ln_std"], "emb": init["emb_std"]}
    tree: dict = {}
    pos = 0
    for path, shape, kind in shapes:
        n = _numel(shape)
        leaf = flat[pos:pos + n].view(shape).mul_(std[kind])
        if kind == "ln_scale":
            leaf.add_(1.0)
        pos += n
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def checksum(tree: dict) -> float:
    """A cheap fingerprint of the tree (to see that a regeneration matches)."""
    s = 0.0
    for v in _leaves(tree):
        s += float(v.double().sum()) + float(v.reshape(-1)[:: max(1, v.numel() // 1024)].double().abs().sum())
    return s


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
