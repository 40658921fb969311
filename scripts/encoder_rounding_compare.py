"""The port's bf16 DeBERTa encoder against the JAX package's, on the CPU, at
gliclass-base widths (deberta-v3-base: H 768, 12 heads, I 3072) and at the
deberta-v2-xlarge width with the conv stem (H 1536, 24 heads, I 6144,
``conv_kernel_size=3``, ``conv_act="gelu"``).

    python3 scripts/encoder_rounding_compare.py ops [--width base|xlarge] [--int8-dynamic] [--jitter] [--hlo DIR]
    python3 scripts/encoder_rounding_compare.py layers [--layers 1] [--width base|xlarge] [--int8-dynamic] [--jitter]

``ops``: one layer's blocks fed the same bf16 inputs in both packages (the
JAX side jitted, as its engine compiles it): the embeddings, the q/k/v
projections, ``rel_ln`` and the position projections; the attention on the
score path (the JAX package's route on the CPU, with one-hot position
tables; the port's "xla" route), again with the JAX package's projections
fed to the port's, the port's CPU route (K1's plain version) against it,
and K1 alone against the Pallas kernel in interpret mode; the attention's
post-LN, the FFN's up product, gelu and down product and the whole FFN,
the FFN's post-LN, and at the xlarge width the conv stem. For each: max
|delta|, the share of outputs that differ and the share more than one bf16
step (at the JAX value) apart. A linear block's line also gives the share
of its fp32 products (before any rounding to bf16) that differ between the
two CPUs' matmuls on the same bf16 operands: their sums run in another
order, which rounding cannot repair. ``--int8-dynamic``: the INT8 tree
under w8a8 (the q/k/v/o and position linears; the port's FFN is then K2's
plain version, which keeps its intermediate in fp32 as the TPU kernel
does, where the JAX package's CPU composes the bf16 path; K2 alone is held
to the Pallas kernel in interpret mode). ``--hlo DIR`` writes each JAX
block's compiled HLO (``jax.jit(f).lower(...).compile().as_text()``) to DIR
and prints its bf16/fp32 ``convert`` counts: where XLA rounds.

``layers``: the whole encoder, B 8, S 64, a ragged mask; the share of the
valid hidden states that differ after each layer, and their max and mean
|delta|, the port (``--route``: its CPU route by default, "xla" for the
score path) against the JAX package's jitted ``deberta_encode``.

Weights: the JAX package's ``init_gliclass_params(jax.random.key(0))``
(vocabulary 300), handed to the port through ``params_from_numpy``;
``--jitter`` adds N(0, 0.02) to every bias and norm parameter (zero and
one at init), so that every add is exercised. Needs JAX and the JAX
package; runs where the tests run, never on the card. ``ops`` at the base
width takes about half a minute, ``layers --layers 12`` a few minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import re
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTHS = {
    "base": {},
    "xlarge": dict(hidden_size=1536, num_attention_heads=24, intermediate_size=6144, conv_kernel_size=3,
                   conv_act="gelu"),
}


def _models(width: str, layers: int, jitter: bool):
    import jax
    import numpy as np

    from gliclass.c_tpu import config as jcfg
    from gliclass.c_tpu.models.gliclass import init_gliclass_params
    from gliclass.c_tpu.ops.quant import quantize_tree

    kw = dict(dataclasses.asdict(jcfg.deberta_v3_config("base")), vocab_size=300, num_hidden_layers=layers)
    kw.update(WIDTHS[width])
    g = dict(hidden_size=kw["hidden_size"], class_token_index=7)
    jc = jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**kw), **g)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(0), jc))
    if jitter:
        rng = np.random.default_rng(1)

        def jit_(path, a):
            name = jax.tree_util.keystr(path)
            if name.endswith(("['b']", "['bias']", "['scale']")) and "w_q" not in name:
                return (a + rng.normal(0, 0.02, a.shape)).astype(np.float32)
            return a

        params = jax.tree_util.tree_map_with_path(jit_, params)
    return jc, params, jax.tree.map(np.asarray, quantize_tree(params))


def _tcfg(jc):
    from gliclass.c_tpu_torch import config as tcfg

    return tcfg.BackboneConfig(**dataclasses.asdict(jc.backbone))


def _batch(n=8, s=64, seed=0):
    """Ragged: row i has s - 5 i valid tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 290, size=(n, s)).astype(np.int32)
    mask = np.zeros((n, s), dtype=np.int32)
    for i in range(n):
        mask[i, : s - 5 * i] = 1
    ids[mask == 0] = 0
    return ids, mask


def _shares(got, want):
    import numpy as np

    d = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)  # one bf16 step at each value
    return d, float(np.mean(d > 0)), float(np.mean(d > step))


def _line(name, got, want, extra=""):
    import numpy as np

    d, differ, beyond = _shares(got, want)
    print(f"{name:34s} max|d| {d.max():.3e}  differ {differ:.4%}  more than one bf16 step {beyond:.4%}{extra}",
          flush=True)


def _hlo_counts(text: str) -> str:
    up = len(re.findall(r"= f32\[[^\]]*\]\{[^}]*\} convert\([^)]*\)", text))
    down = len(re.findall(r"= bf16\[[^\]]*\]\{[^}]*\} convert\([^)]*\)", text))
    return f"  [HLO: {up} converts to f32, {down} to bf16]"


def ops(width: str, int8_dynamic: bool, jitter: bool, hlo: str | None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gliclass.c_tpu.models import deberta as jdeb
    from gliclass.c_tpu.ops import fused_attention as jfa
    from gliclass.c_tpu.ops import fused_ffn as jffn
    from gliclass.c_tpu.ops import layers as jl
    from gliclass.c_tpu_torch.convert.params import params_from_numpy
    from gliclass.c_tpu_torch.models import deberta as tdeb
    from gliclass.c_tpu_torch.ops import fused_attention as tfa
    from gliclass.c_tpu_torch.ops import fused_ffn as tffn
    from gliclass.c_tpu_torch.ops import layers as tl

    jc, params, q = _models(width, 1, jitter)
    tree = q if int8_dynamic else params
    cfg, tcfg = jc.backbone, _tcfg(jc)
    jp = jax.tree.map(jnp.asarray, tree)["backbone"]
    tp = params_from_numpy(tree, "cpu")["backbone"]
    lj = jax.tree.map(lambda a: a[0], jp["layers"])
    lt = tdeb._layer(tp["layers"], 0)
    ids, mask = _batch()
    B, S = ids.shape
    bf, tbf, eps = jnp.bfloat16, torch.bfloat16, cfg.layer_norm_eps
    if hlo:
        os.makedirs(hlo, exist_ok=True)

    def f32(a):
        return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))

    def T(a):
        return torch.from_numpy(np.array(f32(a))).to(tbf)

    def J(name, f, *args):
        """f jitted on args (parameters among them, as the engine passes
        them: never constants folded into the graph); its compiled HLO to
        DIR/name.txt with --hlo."""
        jf = jax.jit(f)
        note = ""
        if hlo:
            text = jf.lower(*args).compile().as_text()
            with open(os.path.join(hlo, re.sub(r"\W+", "_", name).strip("_") + ".txt"), "w") as fh:
                fh.write(text)
            note = _hlo_counts(text)
        return jf(*args), note

    def products(a, w):
        """The share of fp32 products a @ w (bf16 operands) that differ
        between XLA's CPU dot and torch's CPU matmul."""
        if "w_q" in w:
            return ""
        wa = jnp.asarray(w["w"]).astype(bf).astype(jnp.float32)
        x = jnp.asarray(a).astype(jnp.float32)
        j = np.asarray(jax.jit(lambda x, w: jnp.dot(x, w, precision="highest"))(x, wa))
        t = (torch.from_numpy(np.array(x)) @ torch.from_numpy(np.array(wa))).numpy()
        return f"  (fp32 products differ {np.mean(t != j):.4%})"

    def linear(name, wj, wt, a):
        y, note = J(name, lambda w, a: jl.linear(w, a, bf), wj, a)
        _line(name, f32(tl.linear(wt, T(a), tbf)), f32(y), products(a, wj) + note)
        return y

    mode = "bf16 int8-dynamic (w8a8 linears)" if int8_dynamic else "plain bf16"
    print(f"{width} width, {mode}, B {B} S {S}, one layer{', jittered biases and norms' if jitter else ''}")
    with jl.act_quant(int8_dynamic), tl.act_quant(int8_dynamic), torch.inference_mode():
        # Embeddings.
        jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
        x, note = J("embeddings", lambda p, i, m: jdeb.embed(p, i, m, cfg, bf), jp["embeddings"], jids, jmask)
        _line("embeddings", f32(tdeb.embed(tp["embeddings"], torch.from_numpy(ids), torch.from_numpy(mask),
                                           tcfg, tbf)), f32(x), note)
        # q/k/v.
        for n in ("q", "k", "v"):
            linear(f"{n} linear", lj["attn"][n], lt["attn"][n], x)
        # Relative embeddings and the position projections.
        rel, note = J("rel_ln", lambda p, r: jl.layer_norm(p, r.astype(bf), eps), jp["rel_ln"], jp["rel_embeddings"])
        _line("rel_ln", f32(tl.layer_norm(tp["rel_ln"], tp["rel_embeddings"].to(tbf), eps)), f32(rel), note)
        linear("pos_q linear (_pos_qk)", lj["attn"]["q"], lt["attn"]["q"], rel)
        linear("pos_k linear (_pos_qk)", lj["attn"]["k"], lt["attn"]["k"], rel)
        # Attention.
        max_rel = cfg.max_relative_positions if cfg.max_relative_positions >= 1 else cfg.max_position_embeddings
        span = cfg.position_buckets if cfg.position_buckets > 0 else max_rel
        c2p, p2c = jdeb.rel_bias_columns(S, span, cfg.position_buckets, max_rel)
        mb = jmask.astype(bool)
        pair = mb[:, :, None] & mb[:, None, :]
        tc2p, tp2c = torch.from_numpy(c2p.astype(np.int64)), torch.from_numpy(p2c.astype(np.int64))
        tmask = torch.from_numpy(mask)
        valid = mask.astype(bool)

        def t_attention(r):
            if r == "score":
                tb = tmask.bool()
                return tdeb.score_attention(lt["attn"], T(x), T(rel), tb[:, :, None] & tb[:, None, :], tc2p, tp2c,
                                            tcfg, tbf)
            return tdeb.disentangled_attention(lt["attn"], T(x), T(rel), tc2p, tp2c, tcfg, tbf, tmask.int(), r)

        # The JAX package on the CPU takes its score path at this shape; the
        # port's CPU route ("auto") is the flash route, K1's plain version.
        route = tfa.attention_route(S, B, cfg.head_dim, "auto", "cpu")
        a, note = J("attention", lambda p, x, r, pair, m: jdeb.disentangled_attention(
            p, x, r, pair, jnp.asarray(c2p), jnp.asarray(p2c), cfg, bf, key_mask=m), lj["attn"], x, rel, pair, jmask)
        table = "one-hot position tables" if S <= jdeb._TABLE_SKEW_MAX_SEQ else "relative axis"
        _line("attention: score path", f32(t_attention("score"))[valid], f32(a)[valid],
              f"  (port's score path vs JAX's, {table}; valid rows){note}")
        # The same with the q/k/v and position projections taken from the
        # JAX package (their fp32 sums differ, as the linears' lines show):
        # what the score path itself adds.
        jlin = jax.jit(lambda w, inp: jl.linear(w, inp, bf))
        proj = {(id(lt["attn"][n]), inp.ndim): T(jlin(lj["attn"][n], inp)) for n in ("q", "k", "v") for inp in (x, rel)}
        port_linear = tdeb.linear
        tdeb.linear = lambda p, inp, dt=None: proj.get((id(p), inp.ndim)) if (id(p), inp.ndim) in proj \
            else port_linear(p, inp, dt)
        try:
            same = t_attention("score")
        finally:
            tdeb.linear = port_linear
        _line("attention: score path, same q/k/v", f32(same)[valid], f32(a)[valid],
              "  (the JAX package's projections fed to the port's score path)")
        _line(f"attention: port {route} vs JAX score", f32(t_attention(route))[valid], f32(a)[valid],
              "  (the routes: fp32 scores and probabilities against bf16 ones; valid rows)")
        # K1 alone on the same bf16 q, k, v and position rows: the port's
        # plain version against the JAX package's Pallas kernel (interpret
        # mode, one key block of S).
        nh, hd = cfg.num_attention_heads, cfg.head_dim

        def heads(t):
            return jnp.moveaxis(t.reshape(B, S, nh, hd), 2, 1)

        qkv = [heads(jlin(lj["attn"][n], x)) for n in ("q", "k", "v")]
        pk = jnp.take(jlin(lj["attn"]["k"], rel).reshape(-1, nh, hd).transpose(1, 0, 2), jnp.asarray(c2p), axis=1)
        pq = jnp.take(jlin(lj["attn"]["q"], rel).reshape(-1, nh, hd).transpose(1, 0, 2), jnp.asarray(p2c), axis=1)
        kscale = math.sqrt(hd * (1 + len(cfg.pos_att_type)))
        ctx = jax.jit(lambda *t: jfa.flash_disentangled_attention(*t, kscale, blk=S))(*qkv, pk, pq, jmask)
        got = tfa.flash_disentangled_attention(*(T(t) for t in (*qkv, pk, pq)), tmask.int(), kscale)
        rows = np.broadcast_to(valid[:, None, :, None], got.shape)
        _line("K1: port plain vs JAX Pallas", f32(got)[rows], f32(ctx)[rows], "  (the kernel alone; valid rows)")
        # Post-LN of attn + x.
        y, note = J("attention post-LN", lambda p, a, x: jl.layer_norm(p, a + x, eps), lj["attn"]["ln"], a, x)
        _line("attention post-LN", f32(tl.layer_norm(lt["attn"]["ln"], T(a), eps, residual=T(x))), f32(y), note)
        # FFN.
        if not int8_dynamic:
            h = linear("FFN up linear", lj["ffn"]["up"], lt["ffn"]["up"], y)
            g, note = J("FFN gelu", lambda h: jl.activation(cfg.hidden_act)(h), h)
            _line(f"FFN {cfg.hidden_act}", f32(tl.activation(cfg.hidden_act)(T(h))), f32(g), note)
            linear("FFN down linear", lj["ffn"]["down"], lt["ffn"]["down"], g)
        f, note = J("FFN", lambda p, y: jffn.fused_ffn(p["up"], p["down"], y, cfg.hidden_act, bf), lj["ffn"], y)
        label = "FFN: port K2 plain vs JAX CPU" if int8_dynamic else "FFN (up, gelu, down)"
        _line(label, f32(tffn.fused_ffn(lt["ffn"]["up"], lt["ffn"]["down"], T(y), cfg.hidden_act, tbf)), f32(f),
              note)
        if int8_dynamic:
            k2, note = J("K2", lambda p, y: jffn.fused_ffn(p["up"], p["down"], y, cfg.hidden_act, bf, interpret=True),
                         lj["ffn"], y)
            _line("K2: port plain vs JAX Pallas", f32(tffn.fused_ffn(lt["ffn"]["up"], lt["ffn"]["down"], T(y),
                                                                      cfg.hidden_act, tbf)), f32(k2),
                  "  (the kernel alone, interpret mode)" + note)
        z, note = J("FFN post-LN", lambda p, f, y: jl.layer_norm(p, f + y, eps), lj["ffn"]["ln"], f, y)
        _line("FFN post-LN", f32(tl.layer_norm(lt["ffn"]["ln"], T(f), eps, residual=T(y))), f32(z), note)
        # The conv stem: the embeddings' output, layer 0's output.
        if cfg.conv_kernel_size > 0:
            c, note = J("conv stem", lambda p, x, z, m: jdeb.conv_layer(p, x, z, m, cfg, bf), jp["conv"], x, z, jmask)
            _line("conv stem", f32(tdeb.conv_layer(tp["conv"], T(x), T(z), tmask, tcfg, tbf)), f32(c), note)


def layers_cmp(width: str, layers: int, int8_dynamic: bool, jitter: bool, route: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gliclass.c_tpu.models import deberta as jdeb
    from gliclass.c_tpu.ops import layers as jl
    from gliclass.c_tpu_torch.convert.params import params_from_numpy
    from gliclass.c_tpu_torch.models import deberta as tdeb
    from gliclass.c_tpu_torch.ops import layers as tl

    jc, params, q = _models(width, layers, jitter)
    tree = q if int8_dynamic else params
    ids, mask = _batch()
    with jl.act_quant(int8_dynamic):
        want = jax.jit(lambda p, i, m: jdeb.deberta_encode(p, i, m, jc.backbone, jnp.bfloat16, return_all_layers=True))(
            jax.tree.map(jnp.asarray, tree)["backbone"], jnp.asarray(ids), jnp.asarray(mask))
        want = np.asarray(want.astype(jnp.float32))
    with tl.act_quant(int8_dynamic), torch.inference_mode():
        got = tdeb.deberta_encode(params_from_numpy(tree, "cpu")["backbone"], torch.from_numpy(ids),
                                  torch.from_numpy(mask), _tcfg(jc), torch.bfloat16, attn_route=route,
                                  return_all_layers=True).float().numpy()
    valid = mask.astype(bool)
    mode = "bf16 int8-dynamic" if int8_dynamic else "plain bf16"
    print(f"{width} width, {mode}, B {ids.shape[0]} S {ids.shape[1]}, {layers} layers; valid hidden states, "
          f"the port (attn_route {route!r}) against the JAX package (jitted, its CPU route: the score path)")
    for i in range(layers + 1):
        d, differ, beyond = _shares(got[i][valid], want[i][valid])
        print(f"{'embeddings' if i == 0 else f'layer {i}':10s} differ {differ:.4%}  more than one bf16 step "
              f"{beyond:.4%}  max|d| {d.max():.3e}  mean|d| {d.mean():.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["ops", "layers"])
    ap.add_argument("--width", choices=sorted(WIDTHS), default="base")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--int8-dynamic", action="store_true")
    ap.add_argument("--jitter", action="store_true", help="non-zero biases and norm parameters")
    ap.add_argument("--hlo", default=None, help="ops: write each JAX block's compiled HLO here")
    ap.add_argument("--route", default="auto", help="layers: the port's attn_route (auto: flash on the CPU; "
                    "xla: the score path, the JAX package's route on the CPU)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.what == "ops":
        ops(args.width, args.int8_dynamic, args.jitter, args.hlo)
    else:
        layers_cmp(args.width, args.layers, args.int8_dynamic, args.jitter, args.route)
    return 0


if __name__ == "__main__":
    sys.exit(main())
