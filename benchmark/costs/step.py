"""The work of one GLiClass forward over DeBERTa-v3, from its shape.

For a forward of ``rows`` sequences of ``seq`` tokens and ``labels`` label
slots, per encoder layer:

* int8 products (w8a8): the q, k, v and o projections (4 * 2 * rows * seq *
  H * H), the FFN's up and down products (2 * 2 * rows * seq * H * I), and
  the q and k projections of the 2 * buckets relative embeddings, which the
  batch shares (2 * 2 * (2 * buckets) * H * H);
* bf16 contractions of attention: for every query-key pair of each head,
  the content score, the content-to-position and position-to-content
  terms, and the weighted value (4 * 2 * rows * heads * seq^2 * d).

The head adds the two projectors' int8 products (Linear H -> 4H -> H) for
the pooled text and each label slot, and the dot products (bf16 operands).
Embedding gathers, norms, softmax and activations count nothing.
"""


def step_work(model: dict, rows: int, seq: int, labels: int) -> dict:
    """{"int8": operations, "bf16": operations} of one forward."""
    bb = model["backbone"]
    H, I, L = bb["hidden_size"], bb["intermediate_size"], bb["num_hidden_layers"]
    h = bb["num_attention_heads"]
    d = H // h
    rel = 2 * bb["position_buckets"]
    tokens = rows * seq
    int8 = L * (2 * tokens * H * (4 * H + 2 * I) + 2 * 2 * rel * H * H)
    bf16 = L * 4 * 2 * rows * h * seq * seq * d
    Hh = model["hidden_size"]
    int8 += (rows + rows * labels) * 2 * 2 * Hh * 4 * Hh
    bf16 += 2 * rows * labels * Hh
    return {"int8": int8, "bf16": bf16}


def step_seconds_at_peak(model: dict, rows: int, seq: int, labels: int, peaks: dict) -> float:
    """The least time of one forward on the chip: each kind of product at its
    published peak."""
    w = step_work(model, rows, seq, labels)
    return w["int8"] / peaks["int8_ops"] + w["bf16"] / peaks["bf16_flops"]
