"""A run with the timed path broken underneath: ``correct`` comes out false.
The harness's look for a card is skipped (the CPU runs the program's plain
versions); the rest of the run is as on the card."""

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness


def _alter_one_answer(prog):
    """An answer altered where it is produced: row 0 of every forward."""
    step = prog.engine._step

    def broken(ids, mask, max_labels, dev_inputs=None):
        out = step(ids, mask, max_labels, dev_inputs).clone()
        out[0] = 1.0 - out[0]
        return out

    prog.engine._step = broken


def _drop_half_the_batch(prog):
    """Half of each batch left out: its rows answered with the mean of the rest."""
    step = prog.engine._step

    def broken(ids, mask, max_labels, dev_inputs=None):
        out = step(ids, mask, max_labels, dev_inputs).clone()
        half = max(1, out.shape[0] // 2)
        out[half:] = out[:half].mean(dim=0)
        return out

    prog.engine._step = broken


def _unchanged_weights(prog):
    """A step that leaves its state as it came: every layer's output
    projection zeroed, so attention adds nothing."""
    attn = prog.engine.params["backbone"]["layers"]["attn"]
    for k in ("w_q", "w"):
        if k in attn["o"]:
            attn["o"][k] = torch.zeros_like(attn["o"][k])


def _swap_texts(prog):
    """Answers returned for the wrong texts: rows reversed."""
    step = prog.engine._step

    def broken(ids, mask, max_labels, dev_inputs=None):
        return step(ids, mask, max_labels, dev_inputs).flip(0)

    prog.engine._step = broken


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch, _unchanged_weights, _swap_texts])
@pytest.mark.parametrize("kind", ["job", "serve"])
def test_broken_program_is_not_correct(kind, fault, cpu):
    cell = tiny_cell(kind)
    # The check reads every answer here, so a fault is seen however few
    # jobs or requests a slow host fits into the window.
    cell.traffic.update(check_per_job=cell.traffic.get("texts_per_job", 0), check_texts=10**6, check_requests=10**6)
    out = harness.run(cell, 77, 1.0, False, cpu, warm=False, fault=fault)
    assert out["correct"] is False, out["checks"]
