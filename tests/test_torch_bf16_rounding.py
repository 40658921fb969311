"""The port rounds bf16 where the JAX package's compiled graph rounds.

XLA on the CPU runs a bf16 elementwise op in fp32 and rounds its result,
so ``jax.nn.silu`` and the tanh ``jax.nn.gelu`` round after each of their
ops; where a bf16 result goes straight into an fp32 consumer, it feeds the
unrounded value: the residual sum ``h + attn`` into the decoders' MLP
norm, and (under w8a8) the SwiGLU product and the head's gelu product
into their linear's quantizer. Its w8a8 activation scale is ``absmax *
fp32(1/127)`` (the compiler's form of ``absmax / 127``). At the decoders'
width and depth the differences compound: the port's bf16 w8a8
probabilities sat 0.663 (max) from the JAX package's flash route, more
than the JAX package's own two routes differ (0.562;
``scripts/decoder_rounding_compare.py layers``).

Each test feeds the same bf16 inputs and INT8 params to one block of both
packages in ``int8-dynamic`` and asserts the outputs are equal bit for bit
(on these tiny geometries every op of the chain agrees), then the whole
decoder and head. Weight-only INT8 differs by design: the port scales the
fp32 accumulator, as the Pallas kernel does. The JAX side runs its flash
route (the Pallas kernel in interpret mode, fp32 scores as K5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu.models import heads as jheads
from gliclass.c_tpu.models import llama as jllama
from gliclass.c_tpu.models.gliclass import gliclass_forward as j_forward
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops import layers as jlayers
from gliclass.c_tpu.ops.quant import quantize_tree as j_quantize_tree
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.models import heads as theads
from gliclass.c_tpu_torch.models import llama as tllama
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward as t_forward
from gliclass.c_tpu_torch.ops import layers as tlayers

from test_torch_llama import _jitter, gliclass_cfgs, make_batch

BF = jnp.bfloat16


@pytest.fixture(autouse=True)
def _jax_flash_route(monkeypatch):
    monkeypatch.setenv("GLICLASS_TPU_CAUSAL_ATTN", "flash")


@pytest.fixture(scope="module", params=["qwen2", "llama"])
def model(request):
    """Both packages' configs, the INT8 tree (numpy; biases and norm scales
    jittered, head weights scaled) and the port's tensors."""
    jc, tc = gliclass_cfgs(request.param)
    q = jax.tree.map(np.asarray, j_quantize_tree(_jitter(init_gliclass_params(jax.random.key(0), jc))))
    return jc, tc, q, params_from_numpy(q, "cpu")


def _bf16(seed, shape, scale=1.0):
    """The same bf16 values for both packages: (jax array, torch tensor)."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(BF), t


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)))


def _one_step_apart(got: torch.Tensor, want, frac: float = 1e-4) -> None:
    """Equal but for at most ``frac`` of the elements, each one bf16 step
    (2^-8 relative) away: an fp32 last bit before the rounding (the
    compiler may fuse a product and a sum), not a rounding placed
    elsewhere."""
    g, w = got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    d = np.abs(g - w)
    assert (d <= np.abs(w) * 2.0 ** -7).all()
    assert np.mean(d > 0) <= frac


def _layer(model):
    jc, tc, q, tq = model
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), q["backbone"]["layers"]),
            tllama._layer(tq["backbone"]["layers"], 0))


def test_int8_dynamic_linear_bit_equal_to_jax(model):
    """The w8a8 linears in bf16 over 4,096 rows: the activation scale absmax
    * fp32(1/127) (with absmax / 127, 0.3% of the outputs moved, where some
    rows' int8 values moved a step)."""
    jl, tl = _layer(model)
    xj, xt = _bf16(1, (64, 64, 32), 2.0)
    with jlayers.act_quant(True), tlayers.act_quant(True):
        for name in ("q", "k", "v", "o"):
            want = jax.jit(lambda x, p=jl["attn"][name]: jlayers.linear(p, x, BF))(xj)
            _one_step_apart(tlayers.linear(tl["attn"][name], xt, torch.bfloat16), want)


def test_row_quant_reciprocal_scale_is_the_compiled_jax_scale():
    """``row_quant(x, reciprocal=True)`` is the JAX package's compiled w8a8
    quantizer bit for bit; the division form (K2's) differs in some rows."""
    xf = torch.from_numpy(np.random.default_rng(2).normal(size=(4096, 64)).astype(np.float32))
    s_j, q_j = jax.jit(lambda x: (lambda s: (s, jnp.round(x / s).astype(jnp.int8)))(
        jnp.maximum(jnp.max(jnp.abs(x), -1, keepdims=True) / 127.0, 1e-10)))(xf.numpy())
    q_t, s_t = tlayers.row_quant(xf, reciprocal=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    _, s_div = tlayers.row_quant(xf)
    assert (s_div != s_t).any()  # the two forms really differ on this data


def test_mlp_norm_takes_the_unrounded_residual_sum(model):
    """The decoders' MLP norm of h + attn: the fp32 sum of the two bf16
    terms; the norm of their bf16 sum differs in about a quarter of the
    outputs."""
    jc, tc, _, _ = model
    jl, tl = _layer(model)
    hj, ht = _bf16(3, (3, 17, 32))
    oj, ot = _bf16(4, (3, 17, 32))
    eps = jc.backbone.rms_norm_eps
    want = jax.jit(lambda h, o: jlayers.rms_norm(jl["mlp_norm"], h + o, eps))(hj, oj)
    _equal(tlayers.rms_norm(tl["mlp_norm"], ht, eps, residual=ot), want)


def test_swiglu_int8_dynamic_bit_equal_to_jax(model):
    """SwiGLU in bf16 w8a8: silu op by op, and the product gate * up goes
    unrounded into the down projection's quantizer."""
    jl, tl = _layer(model)
    xj, xt = _bf16(5, (3, 17, 32))
    with jlayers.act_quant(True), tlayers.act_quant(True), torch.inference_mode():
        want = jax.jit(lambda x: jllama.llama_mlp(jl["mlp"], x, BF))(xj)
        _equal(tllama.llama_mlp(tl["mlp"], xt, torch.bfloat16), want)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "gelu_pytorch_tanh", "silu", "swish", "relu", "tanh"])
def test_activation_per_op_bit_equal_to_jax(act):
    """The JAX package's activation of a bf16 array: the tanh gelu and silu
    round after each op (their constants rounded to bf16 too); rounded once
    more, the port's fp32 last product is JAX's bf16 result."""
    xj, xt = _bf16(7, (64, 256), 3.0)
    want = jax.jit(jlayers.activation(act))(xj)
    _equal(tlayers.activation_per_op(act)(xt).to(torch.bfloat16), want)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_features_projector_int8_dynamic_bit_equal_to_jax(model, act):
    """The head's projectors in bf16 w8a8: the activation op by op and its
    last product unrounded into linear_2's quantizer (the port computed the
    gelu in fp32 and rounded once)."""
    jc, tc, q, tq = model
    xj, xt = _bf16(6, (3, 4, 32))
    with jlayers.act_quant(True), tlayers.act_quant(True), torch.inference_mode():
        for name in ("text_projector", "classes_projector"):
            pj = jax.tree.map(jnp.asarray, q["head"][name])
            want = jax.jit(lambda x: jheads.features_projector(pj, x, act, BF))(xj)
            _equal(theads.features_projector(tq["head"][name], xt, act, torch.bfloat16), want)


def test_decoder_and_head_int8_dynamic_equal_to_jax_flash_route(model):
    """Two decoder layers and the head in bf16 w8a8, JAX's flash route:
    every hidden state of every layer equal bit for bit, and the logits to
    fp32 rounding (the scorer's fp32 sum may run in another order)."""
    jc, tc, q, tq = model
    ids, mask = make_batch()
    with jlayers.act_quant(True), tlayers.act_quant(True), torch.inference_mode():
        # Jitted, as the JAX engine runs it (op by op, JAX rounds every result).
        jq = jax.tree.map(jnp.asarray, q)
        want = jax.jit(lambda p, i, m: jllama.llama_encode(p, i, m, jc.backbone, BF, return_all_layers=True))(
            jq["backbone"], jnp.asarray(ids), jnp.asarray(mask))
        got = tllama.llama_encode(tq["backbone"], torch.from_numpy(ids), torch.from_numpy(mask), tc.backbone,
                                  torch.bfloat16, return_all_layers=True)
        _equal(got, want)
        want = np.asarray(jax.jit(lambda p, i, m: j_forward(p, i, m, jc, 4, BF))(jq, jnp.asarray(ids),
                                                                                 jnp.asarray(mask)))
        got = t_forward(tq, torch.from_numpy(ids), torch.from_numpy(mask), tc, 4, torch.bfloat16).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.abs(want[:, :3]).max() > 0.1  # the logits are not all near 0: the comparison bites
