"""The check that decides ``correct``: what the window produced against the
plain reference (``reference.py``), on a sample drawn from the seed.

After the window has closed and the program is freed, the weights are made
again from the seed (their fingerprint must match the program's set-up),
the reference reads the same ``tokenizer.json`` and works out the
configuration's quantization itself, and computes the logits of a sample of
the answered texts, the longest among them. The numbers compared, each
against the cell's limit in ``limits/<workload>.json``:

* ``logit_gap``: the largest |logit(p) - z_ref| over the sample's (text,
  label) pairs whose probability p the answer states and whose reference
  logit z_ref lies within +-``LOGIT_CAP`` (beyond it an fp32 probability no
  longer resolves the logit; the decision still counts there). Logits, not
  probabilities: the sigmoid's slope would make a probability's gap depend
  on where a seed's logits happen to lie;
* ``decision_flips``: (text, label) pairs decided otherwise than the
  reference decides, where the reference's logit lies farther than
  ``logit_gap``'s limit from the threshold's;
* ``few_compared``: 1 when fewer than half of the (text, label) pairs
  whose probability the answers state lie within +-``LOGIT_CAP`` and so
  reach ``logit_gap`` (a sample whose logits all lie beyond it would pass
  unread);
* ``misrouted``: answers whose text or index is not the one asked;
* ``failed``: texts (jobs) or requests (serving) that got no answer;
* ``reused_jobs`` (jobs): jobs of the pool run twice in the window;
* ``unanswered_sample``: 1 when no answer could be sampled;
* ``weights_differ``: 1 when the weights made again are not the program's.

The control (``control``) is the reference itself at 4-bit weights (and
activations, where the configuration quantizes them), the precision below
the configuration's int8, put in the program's place and judged by the same
numbers.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import reference, textgen, weights

CONTROL_BITS = 4
LOGIT_CAP = 9.0  # an fp32 probability resolves its logit to ~5e-4 here


# quant_mode -> (weight bits, activations quantized too), as the reference models them
QUANT = {"none": (None, False), "int8": (8, False), "int8-dynamic": (8, True)}


def quantization(config: dict) -> tuple[int | None, bool]:
    mode = config["runtime"]["quant_mode"]
    if mode not in QUANT:
        raise ValueError(f"the reference does not model quant_mode {mode!r}")
    return QUANT[mode]


def sample(cell, seed: int, win) -> tuple[list, list]:
    """([(text, labels)], [(p with NaN where unstated, decided set, echo ok)])."""
    n = int(cell.traffic["check_texts" if cell.traffic["kind"] == "job" else "check_requests"])
    rng = textgen.rng_for(seed, 30)
    items, got = [], []
    if cell.traffic["kind"] == "job":
        rows = win.answers  # (text, labels, p, decided, echo ok), each job's longest first
        longest = max(range(len(rows)), key=lambda k: len(rows[k][0]))
        pick = [k for k in rng.choice(len(rows), size=min(n, len(rows)), replace=False).tolist() if k != longest]
        for k in [longest] + pick:
            text, labels, p, decided, echo = rows[k]
            items.append((text, labels))
            got.append((p, decided, echo))
        return items, got
    done = [k for k, (_, rec) in enumerate(win.answers) if rec[3] == 200]
    if not done:
        return items, got
    longest = max(done, key=lambda k: sum(len(t) for t in win.answers[k][0][1]["texts"]))
    pick = [done[k] for k in rng.choice(len(done), size=min(n, len(done)), replace=False).tolist()]
    for k in ([longest] if longest not in pick else []) + pick:
        (_, body), rec = win.answers[k]
        results = json.loads(rec[4])["results"]
        labels = list(body["labels"])
        for t, text in enumerate(body["texts"]):
            r = results[t] if t < len(results) else {"text_index": -1, "text": None, "decisions": []}
            p = np.full(len(labels), np.nan)
            for d in r["decisions"]:
                if 0 <= d["index"] < len(labels) and d["label"] == labels[d["index"]]:
                    p[d["index"]] = d["score"]
            items.append((text, labels))
            got.append((p, {d["index"] for d in r["decisions"]}, r["text_index"] == t and r["text"] == text))
    return items, got


def to_logit(p: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(p) - np.log1p(-p)


def numbers(got: list, ref: list, threshold: float, margin: float) -> dict:
    """``got``: [(p, decided labels, echo ok)], ``ref``: reference logits."""
    gap, flips, misrouted, compared, stated = 0.0, 0, 0, 0, 0
    z_thr = to_logit(np.float64(threshold)) if threshold > 0 else -np.inf
    for (p, decided, echo), zr in zip(got, ref):
        zr = np.asarray(zr, dtype=np.float64)
        stated += int(np.sum(~np.isnan(p)))
        use = ~np.isnan(p) & (np.abs(zr) <= LOGIT_CAP)
        if use.any():
            gap = max(gap, float(np.max(np.abs(to_logit(p[use]) - zr[use]))))
            compared += int(use.sum())
        clear = np.abs(zr - z_thr) > margin
        want = zr > z_thr
        have = np.array([j in decided for j in range(len(zr))])
        flips += int(np.sum(clear & (want != have)))
        misrouted += int(not echo)
    return {"logit_gap": gap, "decision_flips": flips, "misrouted": misrouted, "compared": compared,
            "few_compared": int(2 * compared < stated)}


def check(cell, seed: int, win, tok_path: str, fingerprint: float, device, control: bool = False):
    """(checks {name: {"value", "limit"}}, the control's readings or None)."""
    limits = cell.limits
    items, got = sample(cell, seed, win)
    raw = weights.make_weights(cell.config["model"], cell.config["init"], seed, device)
    same = weights.checksum(raw) == fingerprint
    tok = reference.PlainTokenizer(tok_path)
    max_len = int(cell.config["runtime"]["max_length"])
    threshold = float(cell.traffic.get("threshold", cell.config["runtime"]["threshold"]))
    bits, quant_act = quantization(cell.config)
    ref_model = reference.PlainGLiClass(raw, cell.config["model"], bits, quant_act)
    ref = reference.logits(ref_model, tok, items, max_len, device)
    del ref_model
    readings = numbers(got, ref, threshold, float(limits["logit_gap"]))
    readings["failed"] = win.work["failed"]
    readings["reused_jobs"] = win.work.get("reused_jobs", 0)
    readings["unanswered_sample"] = 0 if items else 1
    readings["weights_differ"] = 0 if same else 1
    readings_ctl = None
    if control:
        ctl_model = reference.PlainGLiClass(raw, cell.config["model"], CONTROL_BITS, quant_act)
        ctl = reference.logits(ctl_model, tok, items, max_len, device)
        del ctl_model
        ctl_p = [1.0 / (1.0 + np.exp(-np.asarray(z, dtype=np.float64))) for z in ctl]
        readings_ctl = numbers([(p, set(np.flatnonzero(p > threshold).tolist()), True) for p in ctl_p],
                               ref, threshold, float(limits["logit_gap"]))
    del raw
    if device.type == "cuda":
        torch.cuda.empty_cache()
    names = ["logit_gap", "decision_flips", "few_compared", "misrouted", "failed", "unanswered_sample",
             "weights_differ"] + (["reused_jobs"] if cell.traffic["kind"] == "job" else [])
    checks = {k: {"value": readings[k], "limit": limits.get(k, 0)} for k in names}
    return checks, readings_ctl, readings["compared"]
