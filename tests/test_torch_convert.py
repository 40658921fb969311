"""The port's model-production toolchain against the JAX package's, on CPU:
random init (``models.*.init_*_params``), the numpy safetensors writer and
reader (``convert.bundle``), ``save_bundle``, the converter
(``convert.convert``: ``export_bundle``, ``load_checkpoint_state_dict``,
``convert_checkpoint_dir``) and the torch reference (``convert.torch_ref``).

Bundles and converted checkpoint directories are compared file by file,
byte for byte, with what the JAX package writes from the same model."""

import filecmp
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.convert import bundle as JB
from gliclass.c_tpu.convert.convert import export_bundle as j_export
from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass as j_build
from gliclass.c_tpu.fetch import convert_checkpoint_dir as j_convert_dir
from gliclass.c_tpu.models.gliclass import init_gliclass_params as j_init
from gliclass.c_tpu.tokenization import PromptTokenizer as JTok
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert import bundle as TB
from gliclass.c_tpu_torch.convert.convert import convert_checkpoint_dir as t_convert_dir
from gliclass.c_tpu_torch.convert.convert import export_bundle as t_export
from gliclass.c_tpu_torch.convert.convert import load_checkpoint_state_dict as t_load
from gliclass.c_tpu_torch.convert.torch_ref import build_torch_gliclass as t_build
from gliclass.c_tpu_torch.models import deberta as tdeberta
from gliclass.c_tpu_torch.models import heads as theads
from gliclass.c_tpu_torch.models import llama as tllama
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward, init_gliclass_params
from gliclass.c_tpu_torch.tokenization import PromptTokenizer as TTok

from test_real_checkpoint import _hf_base_config

# The verify skill's tiny DeBERTa, and tiny decoders over the same tokenizer.
DEBERTA = dict(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64, position_buckets=16, norm_rel_ebd="layer_norm",
               share_att_key=True, position_biased_input=False)
LLAMA = dict(model_type="llama", vocab_size=600, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128, hidden_act="silu",
             relative_attention=False)
QWEN2 = dict(LLAMA, model_type="qwen2", attention_bias=True)

# name -> (backbone kwargs, head kwargs)
CASES = {
    "deberta": (DEBERTA, {}),
    "llama": (LLAMA, {"prompt_first": False}),
    "qwen2": (QWEN2, {"prompt_first": False}),
    "mlp": (DEBERTA, {"scorer_type": "mlp"}),
    "weighted-dot": (DEBERTA, {"scorer_type": "weighted-dot"}),
    "use_lstm": (DEBERTA, {"use_lstm": True}),
    "squeeze_layers": (DEBERTA, {"squeeze_layers": True}),
    "conv": (dict(DEBERTA, conv_kernel_size=3, conv_act="gelu"), {}),
    "logit_scale": (DEBERTA, {"logit_scale_init_value": 2.6592}),
}


def cfgs(case: str, tok=None, **over):
    """The same configuration in both packages."""
    bb, head = CASES[case]
    kw = dict(dict(hidden_size=32, prompt_first=True), **head)
    if tok is not None:
        kw.update(class_token_index=tok.label_token_id, text_token_index=tok.sep_token_id)
    kw.update(over)
    return (jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**bb), **kw),
            tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**bb), **kw))


def assert_same_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def flat(tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in flat(v).items()})
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Random init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_init_gives_the_jax_tree(case):
    """Keys, shapes and dtypes as the JAX init's; its constant leaves (biases,
    LayerNorm/RMSNorm scales and biases, the fuser's weights) equal; the
    random leaves N(0, 0.02); the port's forward runs on the tree."""
    jc, tc = cfgs(case, class_token_index=5, text_token_index=6)
    want = flat(jax.tree.map(np.asarray, j_init(jax.random.key(0), jc)))
    got = flat(init_gliclass_params(torch.Generator().manual_seed(0), tc))
    assert sorted(got) == sorted(want)
    random = []
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and w.dtype == np.float32, k
        if np.all(w == w.reshape(-1)[0]):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        else:
            random.append(g.reshape(-1))
            if g.numel() >= 4096:
                assert abs(g.std().item() - 0.02) <= 0.001, k
            assert abs(g.mean().item()) <= 4 * 0.02 / g.numel() ** 0.5 + 1e-4, k
    pooled = torch.cat(random)
    assert abs(pooled.std().item() - 0.02) <= 0.001
    ids = torch.tensor([[1, 5, 40, 5, 41, 6, 50, 51, 2], [1, 5, 42, 5, 43, 6, 52, 2, 0]], dtype=torch.int32)
    mask = (ids != 0).to(torch.int32)
    mask[0, -1] = 1
    logits = gliclass_forward(init_gliclass_params(torch.Generator().manual_seed(0), tc), ids, mask, tc, 2)
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()


def test_init_is_one_draw_per_seed_and_takes_dtype_and_device():
    _, tc = cfgs("weighted-dot", use_lstm=True, squeeze_layers=True)
    a = flat(init_gliclass_params(torch.Generator().manual_seed(3), tc))
    b = flat(init_gliclass_params(torch.Generator().manual_seed(3), tc))
    c = flat(init_gliclass_params(torch.Generator().manual_seed(4), tc))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone/embeddings/word"], c["backbone/embeddings/word"])
    jc, _ = cfgs("weighted-dot", use_lstm=True, squeeze_layers=True)
    want = flat(jax.tree.map(lambda x: str(x.dtype), j_init(jax.random.key(0), jc, jnp.bfloat16)))
    bf = flat(init_gliclass_params(torch.Generator().manual_seed(3), tc, torch.bfloat16, "cpu"))
    assert {k: str(v.dtype).replace("torch.", "") for k, v in bf.items()} == want
    # dtype casts the same draw (made in fp32 on the generator's device)
    assert all(torch.equal(bf[k], a[k].to(torch.bfloat16)) for k in a)


@pytest.mark.parametrize("part", ["deberta", "llama", "qwen2", "head-mlp", "head-weighted-dot", "lstm"])
def test_init_parts_give_the_jax_trees(part):
    """Each init function of the port (deberta, llama, heads' head and
    lstm) gives its JAX counterpart's keys and shapes."""
    from gliclass.c_tpu.models import deberta as jd
    from gliclass.c_tpu.models import heads as jh
    from gliclass.c_tpu.models import llama as jl

    gen, key = torch.Generator().manual_seed(0), jax.random.key(0)
    if part in ("deberta", "llama", "qwen2"):
        jc, tc = cfgs(part)
        j_fn, t_fn = (jd.init_deberta_params, tdeberta.init_deberta_params) if part == "deberta" else (
            jl.init_llama_params, tllama.init_llama_params)
        want, got = j_fn(key, jc.backbone), t_fn(gen, tc.backbone)
    elif part == "lstm":
        want, got = jh.init_lstm_params(key, 32), theads.init_lstm_params(gen, 32)
    else:
        jc, tc = cfgs(part.removeprefix("head-"))
        want, got = jh.init_head_params(key, jc), theads.init_head_params(gen, tc)
    want = {k: tuple(v.shape) for k, v in flat(want).items()}
    assert {k: tuple(v.shape) for k, v in flat(got).items()} == want


# ---------------------------------------------------------------------------
# The numpy safetensors writer and reader
# ---------------------------------------------------------------------------
def mixed_tree(rng) -> dict:
    return {
        "a/w": rng.standard_normal((3, 5)).astype(np.float32),
        "a/half": rng.standard_normal(7).astype(np.float16),
        "q/w_q": rng.integers(-127, 128, (4, 6)).astype(np.int8),
        "ids": rng.integers(0, 1000, 9).astype(np.int32),
        "big": rng.integers(-2**40, 2**40, 3).astype(np.int64),
        "mask": rng.random(5) > 0.5,
        "scalar": np.array(2.6592, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "z/last": rng.standard_normal((2, 2)).astype(np.float32),
        "b/bias": np.zeros(3, np.float32),
    }


def test_writer_is_byte_equal_to_safetensors_and_reads_back(tmp_path):
    tree = mixed_tree(np.random.default_rng(0))
    st_save_numpy(tree, str(tmp_path / "ref.safetensors"))
    TB.write_safetensors(tree, str(tmp_path / "port.safetensors"))
    assert (tmp_path / "ref.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    back = TB.read_safetensors(str(tmp_path / "port.safetensors"))
    assert sorted(back) == sorted(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and np.array_equal(back[k], v), k
    # CPU tensors write the same bytes as their numpy arrays
    TB.write_safetensors({k: torch.from_numpy(v) for k, v in tree.items()}, str(tmp_path / "t.safetensors"))
    assert (tmp_path / "t.safetensors").read_bytes() == (tmp_path / "ref.safetensors").read_bytes()
    TB.write_safetensors({}, str(tmp_path / "empty.safetensors"))
    st_save_numpy({}, str(tmp_path / "empty_ref.safetensors"))
    assert (tmp_path / "empty.safetensors").read_bytes() == (tmp_path / "empty_ref.safetensors").read_bytes()


def test_reader_takes_bf16_as_safetensors_torch_writes_it(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16), "b": torch.randn(3, generator=g),
               "q": torch.randint(-127, 128, (2, 4), generator=g, dtype=torch.int8)}
    st_save_torch(tensors, str(tmp_path / "m.safetensors"))
    back = TB.read_safetensors(str(tmp_path / "m.safetensors"))
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], tensors["w"].float().numpy())
    np.testing.assert_array_equal(back["b"], tensors["b"].numpy())
    np.testing.assert_array_equal(back["q"], tensors["q"].numpy())
    TB.write_safetensors(tensors, str(tmp_path / "p.safetensors"))
    assert (tmp_path / "p.safetensors").read_bytes() == (tmp_path / "m.safetensors").read_bytes()


def test_save_bundle_byte_equal_to_jax(tmp_path):
    """save_bundle of the same tree (a 0-d leaf among them) and config: the
    same files as the JAX package's; CPU tensors give the same bytes."""
    jc, tc = cfgs("logit_scale", class_token_index=5, text_token_index=6)
    rng = np.random.default_rng(1)
    params = {"head": {"logit_scale": np.array(2.6592, np.float32),
                       "text_projector": {"linear_1": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                                                       "b": np.zeros(8, np.float32)}}},
              "backbone": {"embeddings": {"word": rng.standard_normal((6, 4)).astype(np.float32)}}}
    from gliclass.c_tpu_torch.ops.quant import quantize_tree

    q = quantize_tree(params)
    goldens = [{"texts": ["a b"], "labels": [["x", "y"]], "same_labels": True, "logits": [[0.5, -1.25]]}]
    JB.save_bundle(str(tmp_path / "j"), jc, params, tokenizer_json='{"t": 1}', goldens=goldens, int8_params=q)
    TB.save_bundle(str(tmp_path / "p"), tc, params, tokenizer_json='{"t": 1}', goldens=goldens, int8_params=q)
    assert_same_files(str(tmp_path / "j"), str(tmp_path / "p"))
    as_torch = lambda t: {k: as_torch(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t)
    TB.save_bundle(str(tmp_path / "t"), tc, as_torch(params), tokenizer_json='{"t": 1}', goldens=goldens,
                   int8_params=as_torch(q))
    assert_same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert TB.load_config(str(tmp_path / "p")) == tc
    assert TB.load_goldens(str(tmp_path / "p")) == goldens


# ---------------------------------------------------------------------------
# export_bundle and convert_checkpoint_dir against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_export_bundle_byte_equal_to_jax(case, tiny_tokenizer_file, tmp_path):
    """One torch reference model through the JAX package's export_bundle and
    the port's, with INT8: every file of the two bundles byte-equal. The
    port's build_torch_gliclass gives the same model for the seed."""
    jtok, ttok = JTok.from_file(tiny_tokenizer_file), TTok.from_file(tiny_tokenizer_file)
    jc, tc = cfgs(case, jtok)
    model = j_build(jc, seed=1)
    twin = t_build(tc, seed=1)
    sd, tsd = model.state_dict(), twin.state_dict()
    assert sorted(sd) == sorted(tsd) and all(torch.equal(sd[k], tsd[k]) for k in sd)
    j_export(model, jc, jtok, str(tmp_path / "j"), quantize=True)
    params = t_export(model, tc, ttok, str(tmp_path / "p"), quantize=True)
    assert_same_files(str(tmp_path / "j"), str(tmp_path / "p"))
    assert ("logit_scale" in params["head"]) == (case == "logit_scale")
    assert ("lstm" in params) == (case == "use_lstm") and ("layers_fuser" in params) == (case == "squeeze_layers")


def _write_ckpt(path, d: dict, tokenizer_file: str, sd: dict, weights: str) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)
    shutil.copy(tokenizer_file, os.path.join(path, "tokenizer.json"))
    if weights == "model.safetensors":
        st_save_torch(sd, os.path.join(path, weights))
    else:
        torch.save(sd, os.path.join(path, weights))
    return str(path)


@pytest.fixture(scope="module")
def published_state(tiny_tokenizer_file):
    """The real-schema fixture of tests/test_real_checkpoint.py: the
    published config schema and a state dict under the ``model.`` prefix."""
    tok = JTok.from_file(tiny_tokenizer_file)
    d = _hf_base_config()
    d["class_token_index"], d["text_token_index"] = tok.label_token_id, tok.sep_token_id
    model = j_build(jcfg.GLiClassConfig.from_dict(d), seed=7)
    return d, {f"model.{k}": v.contiguous() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("variant", ["model.safetensors", "pytorch_model.bin", "bf16 model.safetensors",
                                     "no logit_scale"])
def test_convert_checkpoint_dir_byte_equal_to_jax(variant, published_state, tiny_tokenizer_file, tmp_path):
    d, sd = published_state
    weights = "pytorch_model.bin" if variant == "pytorch_model.bin" else "model.safetensors"
    if variant.startswith("bf16"):
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    if variant == "no logit_scale":
        sd = {k: v for k, v in sd.items() if k != "model.logit_scale"}
    ckpt = _write_ckpt(tmp_path / "ckpt", d, tiny_tokenizer_file, sd, weights)
    j_convert_dir(ckpt, str(tmp_path / "j"), "knowledgator/gliclass-test", quantize=True)
    t_convert_dir(ckpt, str(tmp_path / "p"), "knowledgator/gliclass-test", quantize=True)
    assert_same_files(str(tmp_path / "j"), str(tmp_path / "p"))
    head = TB.load_params(str(tmp_path / "p"))["head"]
    assert ("logit_scale" in head) == (variant != "no logit_scale")
    assert TB.load_config(str(tmp_path / "p")).original_model_name == "knowledgator/gliclass-test"


def _bad(published_state, kind):
    d, sd = published_state
    d = json.loads(json.dumps(d))
    if kind == "wrong prefix":
        sd = {f"gliclass.{k}": v for k, v in sd.items()}
    elif kind == "shape mismatch":
        sd = dict(sd, **{"model.text_projector.linear_1.weight": torch.zeros(3, 3)})
    elif kind == "mismatched tokenizer":
        d["class_token_index"] = d["class_token_index"] + 1
    return d, sd


@pytest.mark.parametrize("kind,match", [("wrong prefix", "missing parameters"), ("shape mismatch", "shape mismatch"),
                                        ("mismatched tokenizer", "does not belong to this checkpoint")])
def test_converter_errors_loudly_where_jax_does(kind, match, published_state, tiny_tokenizer_file, tmp_path):
    d, sd = _bad(published_state, kind)
    ckpt = _write_ckpt(tmp_path / "ckpt", d, tiny_tokenizer_file, sd, "model.safetensors")
    with pytest.raises(ValueError, match=match):
        j_convert_dir(ckpt, str(tmp_path / "j"), "x", quantize=False)
    with pytest.raises(ValueError, match=match):
        t_convert_dir(ckpt, str(tmp_path / "p"), "x", quantize=False)
    assert not os.path.exists(tmp_path / "p")


def test_convert_checkpoint_dir_without_weights_raises(published_state, tiny_tokenizer_file, tmp_path):
    ckpt = _write_ckpt(tmp_path / "ckpt", published_state[0], tiny_tokenizer_file, {}, "model.safetensors")
    os.remove(os.path.join(ckpt, "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="no weights file"):
        t_convert_dir(ckpt, str(tmp_path / "p"), "x")


@pytest.mark.parametrize("with_scale", [True, False])
def test_logit_scale_evidence_rule_as_jax(with_scale, published_state):
    """The trained tensor present: loaded; absent: the parameter removed
    (never kept at its init value), in both packages."""
    from gliclass.c_tpu.convert.convert import load_checkpoint_state_dict as j_load

    d, sd = published_state
    if not with_scale:
        sd = {k: v for k, v in sd.items() if k != "model.logit_scale"}
    jm = j_build(jcfg.GLiClassConfig.from_dict(d), seed=0)
    tm = t_build(tcfg.GLiClassConfig.from_dict(d), seed=0)
    j_load(jm, sd)
    t_load(tm, sd)
    assert (jm.logit_scale is None) == (tm.logit_scale is None) == (not with_scale)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert sorted(jsd) == sorted(tsd) and all(torch.equal(jsd[k], tsd[k]) for k in jsd)
