"""The port's perf model (``utils/perf.py``), ``config.suggest_seq_buckets``
and ``utils.metrics.trace`` against the JAX package, on CPU.

The terms both cost models share are equal to the JAX package's. Where the
port's kernels move other data than the TPU kernels, the port prices its
own: K6 and K9 are copies (no operations, where the JAX package prices a
one-hot product), K10 reads q once and its windowed tables at block 32, and
K2's tensor-core variant sends its fp32 [M, I] up product through device
memory."""

import dataclasses
import json
import math

import numpy as np
import pytest

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.utils import perf as jperf
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.utils import perf

H100 = "NVIDIA H100 80GB HBM3"
SHARED = ("qkv_o_proj", "ffn", "attn_content_pv", "attn_rel_bias", "pos_proj", "head", "weights", "activations",
          "embeddings")
TINY_DEBERTA = dict(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64, max_position_embeddings=64, position_buckets=16,
                    norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False)
TINY_QWEN2 = dict(model_type="qwen2", vocab_size=600, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=96, max_position_embeddings=128, hidden_act="silu",
                  relative_attention=False, attention_bias=True)


def geometry(name: str):
    """(JAX config, port config) of a named geometry."""
    if name == "gliclass-base":
        jb, tb = jcfg.deberta_v3_config("base"), tcfg.deberta_v3_config("base")
    elif name == "qwen-1.5b":
        jb, tb = jcfg.qwen2_config("1.5b"), tcfg.qwen2_config("1.5b")
    elif name == "llama-1.3b":
        jb, tb = jcfg.llama_config("1.3b"), tcfg.llama_config("1.3b")
    else:
        kw = TINY_DEBERTA if name == "tiny-deberta" else TINY_QWEN2
        jb, tb = jcfg.BackboneConfig(**kw), tcfg.BackboneConfig(**kw)
    return (jcfg.GLiClassConfig(hidden_size=jb.hidden_size, backbone=jb),
            tcfg.GLiClassConfig(hidden_size=tb.hidden_size, backbone=tb))


@pytest.mark.parametrize("name", ["gliclass-base", "tiny-deberta", "qwen-1.5b", "llama-1.3b", "tiny-qwen2"])
@pytest.mark.parametrize("quant_mode", ["int8-dynamic", "int8", "none"])
@pytest.mark.parametrize("B,S", [(128, 56), (16, 512), (3, 100)])
def test_shared_step_terms_equal_jax(name, quant_mode, B, S):
    jc, tc = geometry(name)
    for act in (2, 4):
        want = jperf.gliclass_step_cost(jc, B, S, quant_mode, act)
        got = perf.gliclass_step_cost(tc, B, S, quant_mode, act)
        terms = [k for k in SHARED if k in want.flops or k in want.hbm_bytes]
        assert len(terms) >= 6
        for k in terms:
            table = "flops" if k in want.flops else "hbm_bytes"
            assert getattr(got, table)[k] == getattr(want, table)[k], (k, act)


@pytest.mark.parametrize("B,S", [(128, 56), (16, 512), (8, 512), (64, 128), (2, 96)])
def test_route_extras_against_jax(B, S):
    """flash and row: equal to JAX's; score: JAX's "relaxis" (the same
    materialized formulation); bias: JAX's bytes (tables, biases, q/k/v/o),
    no operations (K6 is a copy where JAX prices a one-hot product); tiled:
    K9's tables at block 32 written, K10 reading them once, q/k/v/o once."""
    jc, tc = geometry("gliclass-base")
    bb, jbb = tc.backbone, jc.backbone
    h, d = bb.num_attention_heads, bb.head_dim
    for act in (2, 4):
        for route, jroute in (("flash", "flash"), ("row", "row"), ("score", "relaxis")):
            assert perf._attn_path_extras(bb, B, S, act, route) == jperf._attn_path_extras(jbb, B, S, act, jroute)
        j_ops, j_bytes = jperf._attn_path_extras(jbb, B, S, act, "bias")
        assert perf._attn_path_extras(bb, B, S, act, "bias") == (0, j_bytes) and j_ops > 0
        io = 4 * B * h * S * d * act
        n_win = 2 * (S // 32) - 1
        want = io + 2 * h * d * S * S * act + 2 * h * n_win * d * 32 * 32 * act
        assert perf._attn_path_extras(bb, B, S, act, "tiled") == (0, want)
    with pytest.raises(ValueError, match="route"):
        perf._attn_path_extras(bb, B, S, 2, "relaxis")


def test_step_cost_prices_the_route_the_model_takes():
    from gliclass.c_tpu_torch.ops.fused_attention import attention_route

    _, tc = geometry("gliclass-base")
    bb = tc.backbone
    for route in ("auto", "flash", "bias", "row", "tiled", "xla"):
        for B, S in ((128, 56), (8, 512), (16, 512), (32, 100)):
            r = perf.attn_route_for(tc, B, S, route)
            assert r == attention_route(S, B, 64, route, "cuda")
            c = perf.gliclass_step_cost(tc, B, S, "int8-dynamic", 2, route)
            assert c.hbm_bytes["attn_path"] == bb.num_hidden_layers * perf._attn_path_extras(bb, B, S, 2, r)[1]
    # on the card a head width other than 64 takes the score path
    _, tiny = geometry("tiny-deberta")
    assert perf.attn_route_for(tiny, 8, 64) == "score" and perf.attn_route_for(tiny, 8, 64, device="cpu") == "flash"
    # a decoder's score path materializes [B, h, S, S]; K5 does not
    _, qc = geometry("qwen-1.5b")
    q = qc.backbone
    k5 = perf.gliclass_step_cost(qc, 64, 128, "int8-dynamic").hbm_bytes["attn_scores"]
    xla = perf.gliclass_step_cost(qc, 64, 128, "int8-dynamic", route="xla").hbm_bytes["attn_scores"]
    assert k5 == q.num_hidden_layers * 2 * 64 * (q.num_attention_heads + q.kv_heads) * 128 * q.head_dim * 2
    assert xla == q.num_hidden_layers * 4 * 64 * q.num_attention_heads * 128 * 128 * 2


def test_ffn_bytes_include_k2_round_trip():
    _, tc = geometry("gliclass-base")
    H, I, L = 768, 3072, 12
    M = 128 * 56
    base = 2 * H * I * 1 + 2 * M * H * 2
    assert perf._component_costs(tc, 128, 56, "int8-dynamic", 2)["ffn"][1] == base + 4 * M * I * 2
    assert perf._component_costs(tc, 128, 56, "int8", 2)["ffn"][1] == base + 2 * M * I * 2
    assert perf.gliclass_step_cost(tc, 128, 56, "int8-dynamic").hbm_bytes["ffn_intermediate"] == L * 8 * M * I
    # widths that are not multiples of 16 take the CUDA-core kernels, which keep it on chip
    odd = dataclasses.replace(tc, backbone=dataclasses.replace(tc.backbone, intermediate_size=3000 + 4))
    assert perf._component_costs(odd, 128, 56, "int8-dynamic", 2)["ffn"][1] == 2 * H * 3004 + 2 * M * H * 2
    # plain linears (bf16 weights, or fp32) write and read it in the compute dtype
    assert perf.gliclass_step_cost(tc, 128, 56, "none", 2).hbm_bytes["ffn_intermediate"] == L * 2 * M * I * 2
    assert perf.gliclass_step_cost(tc, 128, 56, "int8", 4).hbm_bytes["ffn_intermediate"] == L * 2 * M * I * 4


def test_speed_of_light_hand_computed():
    """gliclass-base, int8-dynamic at [128, 56], 10 ms, by hand: the dense
    products at int8's 1,979 TOP/s, the attention terms at bf16's 989
    TFLOP/s, the bytes at 3.35 TB/s."""
    _, tc = geometry("gliclass-base")
    B, S, H, I, L, h, d = 128, 56, 768, 3072, 12, 12, 64
    M = B * S
    dense = L * 8 * M * H * H + L * 4 * M * H * I + L * 4 * 512 * H * H + 4 * M * H * H
    attn = 2 * L * 4 * B * h * S * S * d
    nbytes = (L * (4 * H * H + 2 * H * I) + L * 16 * M * H + L * 8 * M * I + L * 4 * B * h * S * d * 2
              + M * H * 2)
    sol = max(dense / 1979e12 + attn / 989e12, nbytes / 3.35e12)
    r = perf.speed_of_light(tc, B, S, 0.010, H100, "int8-dynamic")
    assert r["sol_ms"] == pytest.approx(sol * 1e3, rel=1e-12)
    assert r["sol_frac"] == pytest.approx(sol / 0.010, rel=1e-12)
    assert r["bound_by"] == "bytes" and r["device"] == H100
    assert r["tflops"] == pytest.approx((dense + attn) / 0.010 / 1e12, rel=1e-12)
    assert r["hbm_util"] == pytest.approx(nbytes / 0.010 / 3.35e12, rel=1e-12)
    # weight-only INT8 prices the dense products at bf16's rate
    r8 = perf.speed_of_light(tc, B, S, 0.010, H100, "int8")
    c8 = perf.gliclass_step_cost(tc, B, S, "int8")
    assert r8["sol_ms"] == pytest.approx(max(c8.total_flops / 989e12, c8.total_bytes / 3.35e12) * 1e3, rel=1e-12)


def test_kernel_bound_and_the_peaks_table():
    """The kernels' bound is chip_smoke.py's arithmetic on the published
    H100 peaks; a device that is not in the table raises."""
    assert perf.kernel_bound_ms(2e12, "bf16", 1e9, H100) == (2e12 / 989e12 * 1e3, "operations")
    assert perf.kernel_bound_ms(1e9, "int8", 4.04e8, H100) == (4.04e8 / 3.35e12 * 1e3, "bytes")
    assert perf.kernel_bound_ms(0.0, "bf16", 0.0, H100) == (0.0, "operations")
    assert perf.kernel_bound_ms(6.7e10, "fp32", 1.0, H100) == (1.0, "operations")
    assert perf.device_peaks(H100) == {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "hbm_bytes_per_s": 3.35e12}
    for name in ("NVIDIA H100 PCIe", "TPU v5e", ""):
        with pytest.raises(ValueError, match="no published peaks"):
            perf.kernel_bound_ms(1.0, "bf16", 1.0, name)
    _, tc = geometry("gliclass-base")
    with pytest.raises(ValueError, match="no published peaks"):
        perf.speed_of_light(tc, 8, 64, 0.01, "v5e")


LENGTH_SETS = {
    "uniform": lambda rng: rng.integers(20, 200, 2000),
    "lognormal": lambda rng: np.exp(rng.normal(4.2, 0.5, 3000)).astype(int) + 1,
    "bimodal": lambda rng: np.concatenate([rng.integers(30, 60, 900), rng.integers(400, 520, 100)]),
    "constant": lambda rng: np.full(50, 77),
    "long": lambda rng: rng.integers(600, 3000, 500),
    "one": lambda rng: np.array([5]),
}


@pytest.mark.parametrize("dist", list(LENGTH_SETS))
@pytest.mark.parametrize("max_length,budget,granularity", [(512, 10, 16), (1024, 6, 32), (256, 3, 8), (512, 1, 4)])
def test_suggest_seq_buckets_gives_jax_ladders(dist, max_length, budget, granularity):
    lengths = LENGTH_SETS[dist](np.random.default_rng(0))
    want = jcfg.suggest_seq_buckets(lengths, max_length, budget, granularity)
    assert tcfg.suggest_seq_buckets(lengths, max_length, budget, granularity) == want
    assert tcfg.suggest_seq_buckets(list(lengths), max_length, budget, granularity) == want


def test_suggest_seq_buckets_refuses_as_jax():
    for bad in ([], [0, 0]):
        with pytest.raises(ValueError):
            jcfg.suggest_seq_buckets(bad)
        with pytest.raises(ValueError):
            tcfg.suggest_seq_buckets(bad)


@pytest.mark.parametrize("name", ["tiny-deberta", "tiny-qwen2"])
@pytest.mark.parametrize("quant_mode", ["int8-dynamic", "int8", "none"])
@pytest.mark.parametrize("route", ["auto", "bias", "tiled", "xla"])
def test_per_kernel_report_on_cpu(name, quant_mode, route):
    """The report runs the port's building blocks on the CPU (host clock),
    priced on the H100's peaks, and returns a finite row per component."""
    _, tc = geometry(name)
    rows = perf.per_kernel_report(tc, 2, 32, quant_mode, device="cpu", device_name=H100, iters=2, route=route)
    assert [r["component"] for r in rows] == ["qkv_o_proj", "ffn", "attn_total"]
    for r in rows:
        for k in ("ms", "sol_ms", "sol_frac", "tflops", "gbps"):
            assert math.isfinite(r[k]) and r[k] >= 0, (k, r)
        assert r["ms"] > 0 and r["clock"] == "host" and r["bound_by"] in ("operations", "bytes")
    want = {"auto": "flash", "bias": "bias", "tiled": "tiled", "xla": "score"}[route]
    assert rows[2]["route"] == (want if name == "tiny-deberta" else ("score" if route == "xla" else "causal"))
    text = perf.format_kernel_report(rows)
    assert len(text.splitlines()) == 4 and "attn_total" in text


def test_per_kernel_report_needs_a_device_name_off_the_card():
    _, tc = geometry("tiny-deberta")
    with pytest.raises(ValueError, match="device_name"):
        perf.per_kernel_report(tc, 2, 32, device="cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from gliclass.c_tpu_torch.utils.metrics import trace

    with trace(str(tmp_path / "t")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
