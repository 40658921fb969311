"""The port's trainer vs the JAX package's, on CPU: the loss, the first
step's loss and gradients, one SGD and one AdamW update against optax,
gradient accumulation, the data pipeline, checkpoints, and that training
learns and never reaches a kernel.

Both packages start from the same numpy parameters (JAX-initialised and
jittered, tests/test_torch_heads.py). Tolerances: the loss to 1e-5, every
gradient leaf to 1e-4 relative L2, parameters after an optimizer update to
1e-5 (the update formulas are the same; the sums run in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gliclass.c_tpu.models.gliclass import gliclass_forward as j_forward
from gliclass.c_tpu.training import train as jtrain
from gliclass.c_tpu_torch.ops import causal_attention, fused_attention, fused_ffn, int8_matmul
from gliclass.c_tpu_torch.training import train as ttrain
from gliclass.c_tpu_torch.training.checkpoint import restore_train_state, save_train_state

from test_torch_heads import COMBINED, DECODER, cfgs, init_params

SGD = functools.partial(torch.optim.SGD, lr=0.0)  # lr 0: read the gradients, keep the params


def make_batch(seed=0, n=8, s=16, L=4, ragged=False):
    """Label tokens at 1, 3, 5, 7; ragged rows and label counts if asked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 190, size=(n, s)).astype(np.int32)
    for k in range(L):
        ids[:, 1 + 2 * k] = 7
    mask = np.ones((n, s), dtype=np.int32)
    tmask = np.ones((n, L), dtype=bool)
    if ragged:
        for i in range(n):
            mask[i, s - i % 4 * 2:] = 0
            tmask[i, L - i % 3:] = False
        ids[mask == 0] = 0
    targets = ((rng.random((n, L)) > 0.5) & tmask).astype(np.float32)
    return ids, mask, targets, tmask


def jax_loss_and_grads(params, jc, batch, dtype=jnp.float32, max_labels=4):
    def loss_fn(p):
        logits = j_forward(p, *(jnp.asarray(a) for a in batch[:2]), jc, max_labels, dtype)
        return jtrain.multilabel_loss(logits, jnp.asarray(batch[2]), jnp.asarray(batch[3]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def grads_of(state):
    """{path: gradient} of a port train state after its step."""
    def rec(tree):
        return {k: rec(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.grad

    return flat(rec(state.params))


def rel_l2(a, b, floor=0.0):
    """||a - b|| / max(||b||, floor)."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor, 1e-30))


def assert_grads_close(got, want, tol):
    """Every leaf to ``tol`` relative L2. A leaf whose gradient vanishes
    analytically (the key bias: the softmax is invariant to it) holds only
    rounding noise, so each leaf's error is taken relative to at least 1e-3
    of the global gradient norm."""
    assert got.keys() == want.keys()
    floor = 1e-3 * np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for k in want:
        assert rel_l2(got[k], want[k], floor) < tol, (k, rel_l2(got[k], want[k], floor))


@pytest.mark.parametrize("alpha,gamma", [(-1.0, -1.0), (-1.0, 2.0), (0.25, 2.0), (0.75, 0.5)])
def test_multilabel_loss_matches_jax(alpha, gamma):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(5, 6)) * 4).astype(np.float32)
    logits[:, 5] = -1e4  # a padded slot's logit
    targets = (rng.random((5, 6)) > 0.5).astype(np.float32)
    mask = rng.random((5, 6)) > 0.3
    mask[:, 5] = False
    want = float(jtrain.multilabel_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask), alpha, gamma))
    got = ttrain.multilabel_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask),
                                 alpha, gamma).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a fully masked batch divides by 1, not 0
    assert ttrain.multilabel_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                  torch.zeros(5, 6, dtype=torch.bool)).item() == 0.0


BACKBONES = {
    "deberta-combined": dict(COMBINED),
    "llama-squeeze-mlp": dict(backbone=DECODER, squeeze_layers=True, scorer_type="mlp", prompt_first=False),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_first_step_loss_and_grads_match_jax(name):
    """The first step's loss and every gradient leaf against
    jax.value_and_grad of the JAX loss: DeBERTa with the BiLSTM, the layer
    fuser and the weighted-dot scorer, and a decoder with the fuser and the
    mlp scorer (both on the score path)."""
    jc, tc = cfgs(**BACKBONES[name])
    params = init_params(jc)
    batch = make_batch(ragged=True)
    want_loss, want = jax_loss_and_grads(params, jc, batch)
    state = ttrain.init_train_state(params, SGD, device="cpu")
    state, m = ttrain.make_train_step(tc, 4)(state, *batch)
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-5)
    got, want = grads_of(state), flat(want)
    assert_grads_close(got, want, 1e-4)
    gnorm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    np.testing.assert_allclose(m["grad_norm"].item(), gnorm, rtol=1e-5)


def test_train_steps_match_jax():
    """Two SGD steps of the port's train step against the JAX one: loss,
    accuracy and grad norm at each, the params after both."""
    jc, tc = cfgs(**COMBINED)
    params = init_params(jc)
    tx = optax.sgd(0.05)
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jax.jit(jtrain.make_train_step(jc, tx, 4))
    tstate = ttrain.init_train_state(params, functools.partial(torch.optim.SGD, lr=0.05), device="cpu")
    tstep = ttrain.make_train_step(tc, 4)
    for seed in (0, 1):
        batch = make_batch(seed, ragged=True)
        jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tm = tstep(tstate, *batch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5, err_msg=key)
    assert tstate.step == 2 == int(jstate.step)
    got, want = flat(tstate.params), flat(jax.tree.map(np.asarray, jstate.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_optimizer_update_matches_optax(opt):
    """torch's SGD and AdamW against optax's from the same gradients (the
    JAX loss's, at two batches), two updates so AdamW's moments and bias
    corrections count; every setting explicit on both sides (the weight-decay
    defaults differ: optax 1e-4, torch 1e-2). Fed the same gradients, so
    Adam's normalisation does not magnify the rounding noise of a gradient
    element near zero."""
    jc, _ = cfgs(**COMBINED)
    params = init_params(jc)
    if opt == "sgd":
        tx, make = optax.sgd(0.05), functools.partial(torch.optim.SGD, lr=0.05)
    else:
        tx = optax.adamw(3e-3, b1=0.9, b2=0.99, eps=1e-6, eps_root=0.0, weight_decay=0.05)
        make = functools.partial(torch.optim.AdamW, lr=3e-3, betas=(0.9, 0.99), eps=1e-6, weight_decay=0.05)
    state = ttrain.init_train_state(params, make, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for seed in (0, 1):
        grads = jax_loss_and_grads(params, jc, make_batch(seed, ragged=True))[1]
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, g in zip(ttrain.param_leaves(state.params), jax.tree.leaves(grads)):
            t.grad = torch.from_numpy(np.array(g))
        state.optimizer.step()
    got, want = flat(state.params), flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-7, rtol=1e-6, err_msg=k)


def test_grad_accumulation_equals_one_batch():
    """accum_steps = 4 over 8 rows with equal valid-slot counts equals the
    one-batch step: loss, gradients and the update."""
    jc, tc = cfgs(**COMBINED)
    params = init_params(jc)
    batch = make_batch()
    make = functools.partial(torch.optim.SGD, lr=0.05)
    s1, m1 = ttrain.make_train_step(tc, 4)(ttrain.init_train_state(params, make, device="cpu"), *batch)
    s4, m4 = ttrain.make_train_step(tc, 4, accum_steps=4)(ttrain.init_train_state(params, make, device="cpu"),
                                                           *batch)
    np.testing.assert_allclose(m4["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m4["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-5)
    assert_grads_close(grads_of(s4), grads_of(s1), 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.make_train_step(tc, 4, accum_steps=3)(ttrain.init_train_state(params, make, device="cpu"), *batch)


def test_grad_accumulation_mirrors_jax_on_ragged_slots():
    """With ragged label masks the step is the mean over micro-batches of
    each micro-batch's masked-mean loss (not a mean over all slots), as in
    JAX: loss to 1e-5 and gradients to 1e-4 against the JAX accumulated
    step's SGD update."""
    jc, tc = cfgs(**COMBINED)
    params = init_params(jc)
    batch = make_batch(3, ragged=True)
    lr = 1.0
    tx = optax.sgd(lr)
    js, jm = jax.jit(jtrain.make_train_step(jc, tx, 4, accum_steps=2))(
        jtrain.init_train_state(jax.tree.map(jnp.asarray, params), tx), *(jnp.asarray(a) for a in batch))
    ts, tm = ttrain.make_train_step(tc, 4, accum_steps=2)(ttrain.init_train_state(params, SGD, device="cpu"), *batch)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    _, m1 = ttrain.make_train_step(tc, 4)(ttrain.init_train_state(params, SGD, device="cpu"), *batch)
    assert abs(m1["loss"].item() - tm["loss"].item()) > 1e-4  # a mean over all slots would differ
    before, after = flat(params), flat(jax.tree.map(np.asarray, js.params))
    # SGD at lr 1: the JAX update is minus the gradient.
    assert_grads_close(grads_of(ts), {k: before[k] - after[k] for k in before}, 1e-4)


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Save after one AdamW step, restore into a fresh state, take one more
    step: the params and the optimizer's moments equal the uninterrupted
    run's bit for bit."""
    jc, tc = cfgs(**COMBINED)
    params = init_params(jc)
    make = functools.partial(torch.optim.AdamW, lr=3e-3, weight_decay=0.01)
    step = ttrain.make_train_step(tc, 4)
    a = ttrain.init_train_state(params, make, device="cpu")
    a, _ = step(a, *make_batch(0))
    path = str(tmp_path / "state.pt")
    save_train_state(path, a)
    a, _ = step(a, *make_batch(1))

    b = restore_train_state(path, ttrain.init_train_state(params, make, device="cpu"))
    assert b.step == 1
    b, _ = step(b, *make_batch(1))
    assert b.step == 2
    fa, fb = flat(a.params), flat(b.params)
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    for pa, pb in zip(ttrain.param_leaves(a.params), ttrain.param_leaves(b.params)):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    other, _ = cfgs(**dict(COMBINED, scorer_type="mlp"))
    with pytest.raises(ValueError, match="differs"):
        restore_train_state(path, ttrain.init_train_state(init_params(other), make, device="cpu"))


def test_overfit_tiny():
    """The JAX package's overfit test (tests/test_training.py) on the port:
    AdamW 3e-3, 60 steps on one batch of 8."""
    jc, tc = cfgs(vocab_size=64, max_position_embeddings=32, position_buckets=8)
    params = init_params(jc)
    state = ttrain.init_train_state(params, functools.partial(torch.optim.AdamW, lr=3e-3, weight_decay=1e-4),
                                    device="cpu")
    step = ttrain.make_train_step(tc, 4)
    batch = make_batch(0, s=16)
    batch = (np.minimum(batch[0], 60),) + batch[1:]
    losses, accs = [], []
    for _ in range(60):
        state, m = step(state, *batch)
        losses.append(m["loss"].item())
        accs.append(m["accuracy"].item())
    assert np.isfinite(losses).all()
    assert min(losses) < losses[0] * 0.2, losses[::12]
    assert max(accs) > 0.9


def test_bf16_learns_with_fp32_params():
    """bf16 compute with accumulation: the loss falls over 8 steps on one
    batch, and the params and their gradients stay fp32."""
    jc, tc = cfgs(**COMBINED)
    state = ttrain.init_train_state(init_params(jc, seed=1),
                                    functools.partial(torch.optim.Adam, lr=5e-3), device="cpu")
    step = ttrain.make_train_step(tc, 4, compute_dtype=torch.bfloat16, accum_steps=2)
    batch = make_batch(1)
    losses = []
    for _ in range(8):
        state, m = step(state, *batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0], losses
    leaves = ttrain.param_leaves(state.params)
    assert all(t.dtype == torch.float32 and t.grad.dtype == torch.float32 for t in leaves)


def test_init_train_state_copies_and_refuses_int8():
    jc, _ = cfgs()
    params = init_params(jc)
    before = flat(params)
    state = ttrain.init_train_state(params, functools.partial(torch.optim.SGD, lr=1.0), device="cpu")
    with torch.no_grad():
        for t in ttrain.param_leaves(state.params):
            t.add_(1.0)
    for k, v in flat(params).items():  # the caller's arrays are not the state's
        np.testing.assert_array_equal(v, before[k])
    from gliclass.c_tpu_torch.ops.quant import quantize_tree

    with pytest.raises(ValueError, match="unquantized"):
        ttrain.init_train_state(quantize_tree(params), SGD, device="cpu")


KERNEL_WRAPPERS = [
    (fused_attention, "flash_disentangled_attention"), (fused_attention, "abs_pos_table"),
    (fused_attention, "bias_fused_attention"), (fused_attention, "row_disentangled_attention"),
    (fused_attention, "windowed_pos_tables"), (fused_attention, "tiled_attention"),
    (fused_ffn, "fused_ffn_w8a8"), (fused_ffn, "fused_ffn_wonly"),
    (int8_matmul, "int8_matmul"), (causal_attention, "causal_flash_attention"),
]


@pytest.mark.parametrize("name", list(BACKBONES))
def test_trainer_never_reaches_a_kernel_entry(name, monkeypatch):
    """Every kernel wrapper replaced by one that raises: a train step in
    fp32 and in bf16 still runs (the score path and plain linears)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the trainer reached a kernel wrapper")

    from gliclass.c_tpu_torch.models import deberta, gliclass, llama

    for mod, fn in KERNEL_WRAPPERS:
        monkeypatch.setattr(mod, fn, refuse)
        for user in (deberta, llama):  # the names the models imported
            if hasattr(user, fn):
                monkeypatch.setattr(user, fn, refuse)
    jc, tc = cfgs(**BACKBONES[name])
    state = ttrain.init_train_state(init_params(jc), SGD, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        state, m = ttrain.make_train_step(tc, 4, compute_dtype=dtype)(state, *make_batch(ragged=True))
        assert np.isfinite(m["loss"].item())
    # The patch bites: the inference route reaches a kernel wrapper.
    ids, mask = (torch.from_numpy(a) for a in make_batch()[:2])
    with torch.no_grad(), pytest.raises(AssertionError, match="kernel wrapper"):
        gliclass.gliclass_forward(state.params, ids, mask, tc, 4)


GRAD_CALLS = {
    "flash_disentangled_attention": lambda x: fused_attention.flash_disentangled_attention(x, x, x, x, x, None, 8.0),
    "abs_pos_table": lambda x: fused_attention.abs_pos_table(x, 8),
    "bias_fused_attention": lambda x: fused_attention.bias_fused_attention(x, x, x, x, x, None, 8.0),
    "row_disentangled_attention": lambda x: fused_attention.row_disentangled_attention(x, x, x, x, x, None, 8.0),
    "windowed_pos_tables": lambda x: fused_attention.windowed_pos_tables(x, 32),
    "tiled_attention": lambda x: fused_attention.tiled_attention(x, x, x, x, x, None, 8.0),
    "fused_ffn_w8a8": lambda x: fused_ffn.fused_ffn_w8a8(x, None, x, x, None, x, x),
    "fused_ffn_wonly": lambda x: fused_ffn.fused_ffn_wonly(x, None, x, x, None, x, x),
    "int8_matmul": lambda x: int8_matmul.int8_matmul(x, None, x, x),
    "causal_flash_attention": lambda x: causal_attention.causal_flash_attention(x, x, x, None, 8.0),
}


@pytest.mark.parametrize("name", list(GRAD_CALLS))
def test_every_kernel_wrapper_refuses_grad(name):
    """Each of the ten wrappers raises first thing on an input that
    requires grad with grad enabled, on the CPU as on the card."""
    assert {fn for _, fn in KERNEL_WRAPPERS} == set(GRAD_CALLS)
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        GRAD_CALLS[name](torch.zeros(4, 64, requires_grad=True))


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """A wrapper reached with grad enabled and an input that requires grad
    raises on the CPU as on the card; under no_grad it runs its plain
    version."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 64, generator=g) for _ in range(3))
    rel = torch.randn(2, 15, 64, generator=g)
    mask = torch.ones(1, 8, dtype=torch.int32)
    args = (q, k, v, rel, rel, mask, 8.0)
    want = fused_attention.flash_disentangled_attention(*args)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_attention.flash_disentangled_attention(*args)
    with torch.no_grad():
        torch.testing.assert_close(fused_attention.flash_disentangled_attention(*args), want)
    x = torch.randn(4, 8, generator=g, requires_grad=True)
    w_q = torch.ones(8, 16, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="int8_matmul"):
        int8_matmul.int8_matmul(x, w_q, torch.ones(16))
    with torch.inference_mode():
        assert int8_matmul.int8_matmul(x.detach(), w_q, torch.ones(16)).shape == (4, 16)


# ---------------------------------------------------------------------------
# The data pipeline: bit-equal to the JAX package's
# ---------------------------------------------------------------------------
def records(n=23):
    return [{"text": f"fox number {i} " + "jumps " * (4 * (i % 6)),
             "all_labels": ["science", "sports", "format", "travel"][: 2 + i % 3],
             "true_labels": ["sports"] if i % 2 else ["science"]} for i in range(n)]


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_train_batches_bit_equal_to_jax(tiny_tokenizer_file, drop_remainder, shuffle):
    from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer
    from gliclass.c_tpu.training import data as jdata
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer
    from gliclass.c_tpu_torch.training import data as tdata

    kw = dict(batch_size=4, max_labels=4, max_length=64, seq_buckets=(16, 32, 64), encode_chunk=8,
              drop_remainder=drop_remainder)
    rng = (lambda: np.random.default_rng(5)) if shuffle else (lambda: None)
    want = list(jdata.train_batches(jdata.parse_train_records(records()), JTokenizer.from_file(tiny_tokenizer_file),
                                    shuffle_rng=rng(), **kw))
    got = list(tdata.train_batches(tdata.parse_train_records(records()), PromptTokenizer.from_file(tiny_tokenizer_file),
                                   shuffle_rng=rng(), **kw))
    assert len(got) == len(want) > 3
    assert len({b.input_ids.shape[1] for b in got}) > 1  # several buckets
    for a, b in zip(got, want):
        for field in ("input_ids", "attention_mask", "targets", "target_mask"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_parse_train_records_refuses_as_jax_does():
    from gliclass.c_tpu.training import data as jdata
    from gliclass.c_tpu_torch.training import data as tdata

    for bad, match in (([{"text": 1, "all_labels": ["a"]}], "text"),
                       ([{"text": "x", "all_labels": []}], "all_labels"),
                       ([{"text": "x", "all_labels": ["a"], "true_labels": "a"}], "true_labels"),
                       ([{"text": "x", "all_labels": ["a"], "true_labels": ["b"]}], "not in all_labels")):
        for mod in (jdata, tdata):
            with pytest.raises(ValueError, match=match):
                mod.parse_train_records(bad)
