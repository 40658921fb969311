"""The port's head and encoder features vs the JAX package, on CPU: the
``mlp`` and ``weighted-dot`` scorers, the BiLSTM (``use_lstm``), the layer
fuser (``squeeze_layers``), the DeBERTa conv stem and ``return_all_layers``
of both backbones.

Both packages get the same parameters: JAX-initialised (biases, norm
offsets, fuser weights and the head jittered so every term is exercised),
moved to numpy and handed to the port through ``params_from_numpy``.
Tolerances: fp32 (fp or INT8 weight-only) at 1e-5 with equal decisions
(probability > 0.5); bf16 INT8 at 5e-2 on probabilities, the bound of
tests/test_torch_model.py for the same reasons (the packages round bf16
intermediates at different places).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.models import deberta as jdeberta
from gliclass.c_tpu.models import heads as jheads
from gliclass.c_tpu.models import llama as jllama
from gliclass.c_tpu.models.gliclass import gliclass_forward as j_forward
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops.layers import act_quant as j_act_quant
from gliclass.c_tpu.ops.quant import quantize_tree as j_quantize_tree
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.models import deberta as tdeberta
from gliclass.c_tpu_torch.models import heads as theads
from gliclass.c_tpu_torch.models import llama as tllama
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward as t_forward
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops.layers import act_quant as t_act_quant

CLASS_TOKEN, SEP_TOKEN = 7, 9

DEBERTA = dict(
    model_type="deberta-v2", vocab_size=200, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64, max_position_embeddings=128,
    position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
    position_biased_input=False,
)
DECODER = dict(
    model_type="llama", vocab_size=200, hidden_size=32, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
    max_position_embeddings=128, hidden_act="silu", relative_attention=False,
)

# Every row of the JAX head matrix (tests/test_gliclass_model.py).
HEAD_MATRIX = [
    {},
    {"pooling_strategy": "mean"},
    {"pooling_strategy": "max"},
    {"scorer_type": "mlp"},
    {"scorer_type": "weighted-dot"},
    {"normalize_features": True},
    {"prompt_first": False},
    {"use_lstm": True},
    {"squeeze_layers": True},
    {"use_lstm": True, "squeeze_layers": True, "scorer_type": "weighted-dot"},
    {"extract_text_features": True},
    {"extract_text_features": True, "pooling_strategy": "mean"},
    {"extract_text_features": True, "prompt_first": False},
    {"extract_text_features": True, "prompt_first": False, "pooling_strategy": "max"},
]
COMBINED = HEAD_MATRIX[9]


def cfgs(backbone=None, **over):
    """The same config in both packages."""
    bb = dict(backbone or DEBERTA)
    head = dict(hidden_size=32, class_token_index=CLASS_TOKEN, text_token_index=SEP_TOKEN)
    for k, v in over.items():
        (head if k in {f.name for f in dataclasses.fields(jcfg.GLiClassConfig)} else bb)[k] = v
    return (jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**bb), **head),
            tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**bb), **head))


def make_batch(n=4, s=24, labels=3, seed=0):
    """Ragged batch: row i has s - 3*i valid tokens, label tokens at 1, 3, 5
    and the prompt separator at 8."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 190, size=(n, s)).astype(np.int32)
    for k in range(labels):
        ids[:, 1 + 2 * k] = CLASS_TOKEN
    ids[:, 8] = SEP_TOKEN
    mask = np.zeros((n, s), dtype=np.int32)
    for i in range(n):
        mask[i, : s - 3 * i] = 1
    ids[mask == 0] = 0
    return ids, mask


def jittered(params, seed=0):
    """A numpy tree with non-zero biases and norm offsets, random fuser
    weights, a livelier LSTM, and the head's weights scaled up so the logits
    spread over O(1)."""
    rng = np.random.default_rng(seed + 1)

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['bias']"):
            return (a + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        if name.endswith("['weights']"):
            return rng.normal(0, 1.0, a.shape).astype(np.float32)
        if name.startswith("['head']") and name.endswith("['w']"):
            return a * 12.0
        if name.startswith("['lstm']"):
            return (a + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, jax.tree.map(np.asarray, params))


def init_params(jc, seed=0):
    """JAX-initialised GLiClass params as numpy, :func:`jittered`."""
    return jittered(init_gliclass_params(jax.random.key(seed), jc), seed)


def jax_probs(params, ids, mask, cfg, dtype, act_q=False, max_labels=4):
    with j_act_quant(act_q):
        return np.asarray(j_probs(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                  jnp.asarray(mask), cfg, max_labels, dtype))


def torch_probs(params, ids, mask, cfg, dtype, act_q=False, max_labels=4):
    with t_act_quant(act_q):
        return t_probs(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                       torch.from_numpy(mask), cfg, max_labels, dtype).numpy()


def assert_probs_match(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


@pytest.mark.parametrize("head_over", HEAD_MATRIX, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "simple")
def test_head_matrix_fp32_matches_jax(head_over):
    """Logits to 1e-5 relative to their largest valid magnitude (some rows
    saturate the sigmoid, so probabilities alone would not bite), the
    probabilities to 1e-5, and equal decisions."""
    jc, tc = cfgs(**head_over)
    params = init_params(jc)
    ids, mask = make_batch()
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(ids), jnp.asarray(mask), jc, 4))
    got = t_forward(params_from_numpy(params, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask), tc, 4).numpy()
    scale = np.abs(want[:, :3]).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5)
    assert (got[:, 3] == -1e4).all()  # padded label slot
    assert got[:, :3].std() > 1e-2 * scale  # the logits spread: the comparison bites
    assert_probs_match(torch_probs(params, ids, mask, tc, torch.float32),
                       jax_probs(params, ids, mask, jc, jnp.float32))


@pytest.fixture(scope="module")
def combined_params():
    jc, tc = cfgs(**COMBINED)
    params = init_params(jc)
    return jc, tc, params, jax.tree.map(np.asarray, j_quantize_tree(params))


@pytest.mark.parametrize("n", [4, 1])
def test_combined_head_int8_fp32_matches_jax(combined_params, n):
    """INT8 weights in fp32 (weight-only in both packages: fp32 turns w8a8
    off), the scorer's projections and MLP among them; B = 1 too."""
    jc, tc, _, qparams = combined_params
    assert "w_q" in qparams["head"]["scorer"]["mlp_2"] and "w_q" in qparams["head"]["scorer"]["proj_text"]
    ids, mask = make_batch(n=n)
    assert_probs_match(torch_probs(qparams, ids, mask, tc, torch.float32, act_q=True),
                       jax_probs(qparams, ids, mask, jc, jnp.float32, act_q=True))


@pytest.mark.parametrize("quant_mode,n", [("int8-dynamic", 4), ("int8-dynamic", 1), ("int8", 4)])
def test_combined_head_bf16_int8_close_to_jax(combined_params, quant_mode, n):
    """bf16 with INT8 weights: w8a8 products at M = B or B * L rows (3 and 12
    at B = 1) in "int8-dynamic", the weight-only ones in "int8"."""
    jc, tc, _, qparams = combined_params
    ids, mask = make_batch(n=n)
    act_q = quant_mode == "int8-dynamic"
    got = torch_probs(qparams, ids, mask, tc, torch.bfloat16, act_q)
    want = jax_probs(qparams, ids, mask, jc, jnp.bfloat16, act_q)
    err = float(np.abs(got - want).max())
    print(f"bf16 {quant_mode} B={n}: max|port - jax| = {err:.3e}")
    assert np.isfinite(got).all() and err < 5e-2


def test_unknown_scorer_raises():
    _, tc = cfgs(scorer_type="cosine")
    ids, mask = make_batch()
    jc0, _ = cfgs()
    with pytest.raises(ValueError, match="scorer_type"):
        t_forward(params_from_numpy(init_params(jc0), "cpu"), torch.from_numpy(ids),
                  torch.from_numpy(mask), tc, 4)


# ---------------------------------------------------------------------------
# The BiLSTM and the layer fuser on their own
# ---------------------------------------------------------------------------
def lstm_params(H=32, seed=3):
    rng = np.random.default_rng(seed)
    h = H // 2

    def direction():
        return {"w_ih": rng.normal(0, 0.3, (H, 4 * h)).astype(np.float32),
                "w_hh": rng.normal(0, 0.3, (h, 4 * h)).astype(np.float32),
                "b": rng.normal(0, 0.3, (4 * h,)).astype(np.float32)}

    return {"fwd": direction(), "bwd": direction()}


RAGGED = [[12, 12, 12], [12, 7, 1], [5, 12, 3]]


@pytest.mark.parametrize("lengths", RAGGED)
def test_bilstm_matches_torch_lstm_pack_padded(lengths):
    """The masked scans against nn.LSTM over pack_padded_sequence, the
    upstream module, on right-padded rows: outputs equal at valid steps and
    0 at padded ones."""
    p = lstm_params()
    B, S, H = len(lengths), 12, 32
    x = np.random.default_rng(4).normal(size=(B, S, H)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int32)
    got = theads.bilstm(params_from_numpy(p, "cpu"), torch.from_numpy(x), torch.from_numpy(mask)).numpy()

    lstm = torch.nn.LSTM(H, H // 2, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(torch.from_numpy(p[d]["w_ih"].T))
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(torch.from_numpy(p[d]["w_hh"].T))
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(torch.from_numpy(p[d]["b"]))
            getattr(lstm, f"bias_hh_l0{suffix}").zero_()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            torch.from_numpy(x), torch.tensor(lengths), batch_first=True, enforce_sorted=False)
        out, _ = lstm(packed)
        want, _ = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=S)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
    assert (got[mask == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_matches_jax(dtype):
    """fp32 arithmetic whatever the input dtype, the result in x's dtype."""
    p = lstm_params()
    x = np.random.default_rng(5).normal(size=(3, 12, 32)).astype(np.float32)
    mask = (np.arange(12)[None] < np.array([[12], [7], [2]])).astype(np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jheads.bilstm(jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jdt),
                                    jnp.asarray(mask)).astype(jnp.float32))
    got = theads.bilstm(params_from_numpy(p, "cpu"), torch.from_numpy(x).to(dtype), torch.from_numpy(mask))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2  # bf16: one rounding of the output
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fuse_layers_matches_jax(dtype):
    rng = np.random.default_rng(6)
    states = rng.normal(size=(5, 2, 7, 32)).astype(np.float32)
    p = {"weights": rng.normal(size=(5,)).astype(np.float32)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jheads.fuse_layers(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(states).astype(jdt)).astype(jnp.float32))
    got = theads.fuse_layers(params_from_numpy(p, "cpu"), torch.from_numpy(states).to(dtype))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# Encoder and decoder features
# ---------------------------------------------------------------------------
def deberta_params(jb, seed=0):
    return jittered(jdeberta.init_deberta_params(jax.random.key(seed), jb), seed)


def j_deberta(params, ids, mask, jb, dtype=jnp.float32, all_layers=False):
    return np.asarray(jdeberta.deberta_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                              jnp.asarray(mask), jb, dtype,
                                              return_all_layers=all_layers).astype(jnp.float32))


def t_deberta(params, ids, mask, tb, dtype=torch.float32, all_layers=False, route="auto"):
    return tdeberta.deberta_encode(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                                   torch.from_numpy(mask), tb, dtype, route,
                                   return_all_layers=all_layers).float().numpy()


@pytest.mark.parametrize("k,act", [(3, "tanh"), (5, "gelu")])
def test_conv_stem_matches_jax(k, act):
    """The conv stem after layer 0, fp32, on a ragged batch."""
    jc, tc = cfgs(conv_kernel_size=k, conv_act=act)
    params = deberta_params(jc.backbone)
    assert params["conv"]["w"].shape == (k, 32, 32)
    ids, mask = make_batch()
    want = j_deberta(params, ids, mask, jc.backbone)
    got = t_deberta(params, ids, mask, tc.backbone)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)
    stem = t_deberta(params, ids, mask, tc.backbone, all_layers=True)[1]
    assert (stem[~valid] == 0).all()  # the stem masks the padded positions again


def test_conv_stem_bf16_close_to_jax():
    """bf16: the conv's inputs in bf16, its sums in fp32 in both packages."""
    jc, tc = cfgs(conv_kernel_size=3, conv_act="gelu")
    params = deberta_params(jc.backbone)
    ids, mask = make_batch()
    want = j_deberta(params, ids, mask, jc.backbone, jnp.bfloat16)
    got = t_deberta(params, ids, mask, tc.backbone, torch.bfloat16)
    valid = mask.astype(bool)
    err = np.abs(got[valid] - want[valid]).max() / np.abs(want[valid]).max()
    assert err < 3e-2, err


def test_conv_stem_even_kernel_raises():
    jc, tc = cfgs(conv_kernel_size=4)
    params = deberta_params(jc.backbone)
    ids, mask = make_batch()
    with pytest.raises(ValueError, match="odd"):
        j_deberta(params, ids, mask, jc.backbone)
    with pytest.raises(ValueError, match="odd"):
        t_deberta(params, ids, mask, tc.backbone)


@pytest.mark.parametrize("conv", [0, 3])
@pytest.mark.parametrize("route", ["auto", "xla"])
def test_deberta_return_all_layers_matches_jax(conv, route):
    """[embed, layer 0 (conv-merged), layers 1..L-1], the last equal to the
    plain forward's output; under the kernel route's plain version and the
    score path."""
    jc, tc = cfgs(conv_kernel_size=conv, conv_act="gelu", num_hidden_layers=3)
    params = deberta_params(jc.backbone)
    ids, mask = make_batch()
    want = j_deberta(params, ids, mask, jc.backbone, all_layers=True)
    got = t_deberta(params, ids, mask, tc.backbone, all_layers=True, route=route)
    assert got.shape == (4, 4, 24, 32) == want.shape
    valid = mask.astype(bool)
    for i in range(4):
        np.testing.assert_allclose(got[i][valid], want[i][valid], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[-1], t_deberta(params, ids, mask, tc.backbone, route=route))
    embed = tdeberta.embed(params_from_numpy(params["embeddings"], "cpu"), torch.from_numpy(ids),
                           torch.from_numpy(mask), tc.backbone, torch.float32).numpy()
    np.testing.assert_array_equal(got[0], embed)


def test_engine_leaves_conv_stem_alone():
    """The engine's weight rewrites (q/k/v fusion; the [N, K] FFN copies of
    ``int8-dynamic`` on the card) keep the stem's [k, H, H] kernel as it is,
    and the fused engine's states equal the unfused ones."""
    from gliclass.c_tpu_torch.engine import InferenceEngine, fuse_qkv_params
    from gliclass.c_tpu_torch.ops.fused_ffn import add_nk_weights

    jc, tc = cfgs(conv_kernel_size=3, conv_act="gelu")
    params = jax.tree.map(np.asarray, j_quantize_tree(init_params(jc)))
    t = params_from_numpy(params, "cpu")
    for rewritten in (fuse_qkv_params(t, tc), add_nk_weights(t)):
        assert rewritten["backbone"]["conv"] is t["backbone"]["conv"]
        assert rewritten is not t  # the rewrite did apply
    ids, mask = make_batch()
    probs = [InferenceEngine(tc, params, tcfg.RuntimeConfig(compute_dtype="float32", quant_mode="int8", fuse_qkv=f),
                             device="cpu")._forward(torch.from_numpy(ids), torch.from_numpy(mask), 4)
             for f in (False, True)]
    np.testing.assert_allclose(probs[1].numpy(), probs[0].numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def decoder():
    jc, tc = cfgs(backbone=DECODER, scorer_type="mlp", squeeze_layers=True, prompt_first=False)
    return jc, tc, init_params(jc)


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_llama_return_all_layers_matches_jax(decoder, route):
    """transformers' order: the embedding output, the inputs of layers
    1..L-1, the final-normed output (never the last layer's raw output)."""
    jc, tc, params = decoder
    ids, mask = make_batch()
    p = params["backbone"]
    want = np.asarray(jllama.llama_encode(jax.tree.map(jnp.asarray, p), jnp.asarray(ids), jnp.asarray(mask),
                                          jc.backbone, jnp.float32, return_all_layers=True))
    got = tllama.llama_encode(params_from_numpy(p, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask),
                              tc.backbone, torch.float32, route, return_all_layers=True).numpy()
    assert got.shape == (4, 4, 24, 32) == want.shape
    valid = mask.astype(bool)
    for i in range(4):
        np.testing.assert_allclose(got[i][valid], want[i][valid], atol=1e-5, rtol=1e-5)
    final = tllama.llama_encode(params_from_numpy(p, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask),
                                tc.backbone, torch.float32, route).numpy()
    np.testing.assert_array_equal(got[-1], final)


def test_llama_score_route_matches_kernel_route(decoder):
    """attn_route "xla" (the score path, the trainer's) and the K5 route's
    plain version give the same fp32 states."""
    _, tc, params = decoder
    ids, mask = make_batch()
    args = (params_from_numpy(params["backbone"], "cpu"), torch.from_numpy(ids), torch.from_numpy(mask),
            tc.backbone, torch.float32)
    valid = torch.from_numpy(mask).bool()
    a, b = tllama.llama_encode(*args, "xla"), tllama.llama_encode(*args, "auto")
    np.testing.assert_allclose(a[valid].numpy(), b[valid].numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="route"):
        tllama.llama_encode(*args, "bogus")


# ---------------------------------------------------------------------------
# JAX-exported bundles with each feature through classify_job
# ---------------------------------------------------------------------------
FEATURES = {
    "mlp": {"scorer_type": "mlp"},
    "weighted-dot": {"scorer_type": "weighted-dot"},
    "lstm": {"use_lstm": True},
    "squeeze": {"squeeze_layers": True},
    "conv": {"conv_kernel_size": 3, "conv_act": "gelu"},
}
RT = dict(batch_size=4, max_length=64, compute_dtype="float32", seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))
JOB = {"texts": ["the quick brown fox jumps over the lazy dog", "why are you running",
                 "onnx is an open-source format for ai models", "support ukraine", "the lazy dog"],
       "labels": [["science", "sports", "format", "question"]], "same_labels": True,
       "classification_type": "multi-label"}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_classify_job_feature_bundle_matches_jax(feature, tiny_tokenizer_file, tmp_path):
    """A bundle the JAX package's exporter writes from its torch reference
    model, read by the port's bundle reader: classify_job decisions equal to
    the JAX package's, probabilities to 1e-5, in fp32 with fp and with INT8
    weights."""
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass
    from gliclass.c_tpu.data import parse_job as j_parse_job
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

    tok = JTokenizer.from_file(tiny_tokenizer_file)
    over = FEATURES[feature]
    bb = {k: v for k, v in over.items() if k.startswith("conv")}
    jb = jcfg.BackboneConfig(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
                             position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
                             position_biased_input=False, **bb)
    head = {k: v for k, v in over.items() if k not in bb}
    cfg = jcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                              text_token_index=tok.sep_token_id, prompt_first=True, backbone=jb, **head)
    torch.manual_seed(0)
    path = str(tmp_path / "bundle")
    export_bundle(build_torch_gliclass(cfg), cfg, tok, path, quantize=True)
    for quant_mode in ("none", "int8"):
        jout = JPipeline.from_bundle(path, JRuntime(quant_mode=quant_mode, **RT)).classify_job(j_parse_job(JOB))
        tpipe = ZeroShotClassificationPipeline.from_bundle(
            path, tcfg.RuntimeConfig(quant_mode=quant_mode, **RT), device="cpu")
        for k, v in over.items():
            owner = tpipe.engine.cfg.backbone if k.startswith("conv") else tpipe.engine.cfg
            assert getattr(owner, k) == v
        tout = tpipe.classify_job(parse_job(JOB))
        assert tout.failures == [] and jout.failures == []
        np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)
        tj, jj = tout.to_json(), jout.to_json()
        assert [[d["label"] for d in a["decisions"]] for a in tj] == [[d["label"] for d in b["decisions"]] for b in jj]
