"""Port parity for the encoder-decoder family (SeamlessM4T's backbone,
``repro_torch.models.encdec``) against the JAX package, on
``reduced(seamless-m4t-large-v2)`` (2 encoder + 2 decoder layers, d_model
64, 4 heads of 16, LayerNorm, an ungated GELU MLP of 96, QKV biases, tied
embeddings, vocab 256), params drawn with numpy from a seed (biases
nonzero) and bridged to both packages.

* the loss and every gradient against JAX's at 1e-5, masked on all five
  unit keys and not, on the kernel path (the family reaches no kernel)
  and the plain path; Eq. 1 scores and parameter-space masks on the
  encoder, self- and cross-attention keys;
* prefill and decode against JAX's at 1e-5, and prefill + decode against
  one longer prefill at the reference's tolerance (2e-3; rounding here);
  ``pad_cache`` grows the self cache and leaves the cross cache at the
  encoder's length, which a padded key would change;
* ``make_adapter`` refuses the family, as the reference's does;
* three ``make_train_step`` steps against JAX's, on batches drawn by
  ``launch.train.make_batch`` in the reference CLI's order (rows, then the
  stub frame embeddings); ``launch.serve``'s batch likewise, and the serve
  CLI on the reduced config.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.core import contribution as jC  # noqa: E402
from repro.core import masking as jMK  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import encdec as jED  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import build, default_runtime, logical_axes  # noqa: E402
from repro_torch.models.module import P  # noqa: E402
from repro_torch.optim import warmup_cosine_schedule  # noqa: E402
from test_torch_mla import (TCFG_RUN, _j, _np, _t,  # noqa: E402
                            check_train_states, numpy_params,
                            run_train_steps)

ARCH = "seamless-m4t-large-v2"
JCFG, TCFG = JC.reduced(JC.ARCHS[ARCH]), TC.reduced(TC.ARCHS[ARCH])
SCHEMA = {"enc_heads": (2, 4), "enc_mlp": (2, 96), "heads": (2, 4),
          "cross_heads": (2, 4), "mlp": (2, 96)}
ATOL = 1e-5
B, S_ENC, S_DEC = 2, 20, 17


@functools.lru_cache(maxsize=None)
def _params():
    return numpy_params(JCFG, 1)


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SCHEMA.items():
        m = (rng.random(shape) < 0.5).astype(np.float32)
        m[:, 0] = 1.0
        out[k] = m
    return out


def _batch(seed, s=S_DEC):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (B, s)).astype(np.int32),
            "enc_embeds": rng.normal(size=(B, S_ENC, 64)).astype(np.float32)}


def test_config_and_schema_match_jax():
    assert build(TCFG).mask_schema == jED.mask_schema(JCFG) == SCHEMA
    for f in ("enc_layers", "dec_layers", "is_encdec", "num_layers", "norm",
              "activation", "qkv_bias", "tie_embeddings", "padded_vocab"):
        assert getattr(TCFG, f) == getattr(JCFG, f), f
    assert (TCFG.enc_layers, TCFG.dec_layers) == (2, 2)
    jaxes = dict(tree_paths(jAPI.logical_axes(JCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    taxes = dict(tree_paths(logical_axes(TCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    assert taxes == jaxes
    # the full config: 24 + 24 layers, vocab 256206 padded to 256256
    full_j, full_t = JC.ARCHS[ARCH], TC.get_model_config(ARCH)
    assert full_t.padded_vocab == 256256
    tshapes = {k: p.shape for k, p in tree_paths(
        build(full_t).spec, is_leaf=lambda v: isinstance(v, P))}
    jshapes = {k: tuple(v.shape)
               for k, v in tree_paths(jAPI.abstract_params(full_j))}
    assert tshapes == jshapes
    n = sum(int(np.prod(s)) for s in tshapes.values())
    # the reference's count leaves out the LayerNorms' 244 scale / bias
    # rows of 1024 (2 a norm: 2 norms an encoder layer, 3 a decoder
    # layer, and the two final ones)
    assert n == full_j.n_params() + 244 * 1024 == 1_370_173_440


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(masked):
    rt = jAPI.default_runtime(JCFG)
    masks = _j(_masks(5)) if masked else None
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jED.encdec_loss(p, _j(_batch(5)), JCFG, rt, masks)))(
        _j(_params()))
    return float(loss), dict(tree_paths(jax.device_get(grads)))


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(masked, kernels):
    jloss, jgrads = _jax_loss_grads(masked)
    tp = _t(_params())
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, 16
    masks = _t(_masks(5)) if masked else None
    loss = build(TCFG).loss_fn(tp, _t(_batch(5)), TCFG, rt, masks)
    assert abs(float(loss.detach()) - jloss) <= ATOL
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), jgrads[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if masked:                  # each unit key freezes its own parameters
        m = _masks(5)
        for key, path in (("enc_heads", "enc_blocks/attn/wq"),
                          ("heads", "dec_blocks/attn/wq"),
                          ("cross_heads", "dec_blocks/cross/wq")):
            wq = _np(grads[path]).transpose(0, 2, 1, 3)   # (L, H, d, hd)
            assert np.all(wq[m[key] == 0] == 0), key
        for key, path in (("enc_mlp", "enc_blocks/mlp/wi"),
                          ("mlp", "dec_blocks/mlp/wi")):
            wi = _np(grads[path]).transpose(0, 2, 1)      # (L, d_ff, d)
            assert np.all(wi[m[key] == 0] == 0), key


@pytest.mark.parametrize("masked", [False, True])
def test_unit_scores_and_expand_masks_match_jax(masked):
    """The five keys score and mask their own stacks: ``heads`` the
    decoder's self-attention only, ``cross_heads`` its cross-attention,
    the ``enc_`` keys the encoder."""
    rng = np.random.default_rng(6)
    d = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                     _params())
    want = jax.jit(lambda t: jC.unit_scores(t, jAPI.logical_axes(JCFG),
                                            SCHEMA))(d)
    got = tC.unit_scores(_t(d), logical_axes(TCFG), SCHEMA)
    for k in SCHEMA:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    # the query heads' leaves: wq, bq and wo (wk / wv / bk / bv carry the
    # kv_heads axis, no unit)
    cross = d["dec_blocks"]["cross"]
    want_cross = np.abs(cross["wq"]).sum(axis=(1, 3)) \
        + np.abs(cross["bq"]).sum(axis=2) + np.abs(cross["wo"]).sum(axis=(2, 3))
    np.testing.assert_allclose(_np(got["cross_heads"]), want_cross,
                               rtol=1e-5)
    um = _masks(7) if masked else {k: np.ones(s, np.float32)
                                   for k, s in SCHEMA.items()}
    jm = dict(tree_paths(jax.jit(lambda m, t: jMK.expand_masks(
        jAPI.logical_axes(JCFG), m, t))(_j(um), d)))
    tm = dict(tree_paths(tMK.expand_masks(logical_axes(TCFG), _t(um),
                                          _t(d))))
    assert set(jm) == set(tm)
    for k, v in jm.items():
        np.testing.assert_array_equal(_np(tm[k]), np.asarray(v), err_msg=k)
    if masked:
        for path in ("enc_blocks/attn/wq", "enc_blocks/mlp/wi",
                     "dec_blocks/attn/wo", "dec_blocks/cross/bq",
                     "dec_blocks/mlp/wo"):
            assert float(tm[path].min()) == 0.0, path


def _grow_self(cache):
    """JAX's prefill cache with the decoder's self K / V padded by one
    slot, the cross K / V as they are (tests/test_recurrences.py's
    grow)."""
    grow = jax.tree.map(lambda v: jnp.pad(
        v, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]), cache["kv"]["self"])
    return {**cache, "kv": {**cache["kv"], "self": grow}}


@functools.lru_cache(maxsize=None)
def _jax_serve():
    api = jAPI.build(JCFG)
    rt = jAPI.default_runtime(JCFG, JC.SMOKE_SHAPE)
    rt["attn_impl"] = "dense"
    masks = jAPI.make_full_masks(JCFG)
    b18 = _batch(4, S_DEC + 1)
    b17 = {**b18, "tokens": b18["tokens"][:, :S_DEC]}
    prefill = jax.jit(lambda p, b: api.prefill_fn(p, b, JCFG, rt, masks))
    jp = _j(_params())
    l17, cache = prefill(jp, _j(b17))
    l18, _ = prefill(jp, _j(b18))
    ld, _ = jax.jit(lambda p, t, c: api.decode_fn(p, t, c, JCFG, rt, masks))(
        jp, jnp.asarray(b18["tokens"][:, S_DEC:]), _grow_self(cache))
    return np.asarray(l17), np.asarray(l18), np.asarray(ld)


def _port_prefill(batch):
    api = build(TCFG)
    masks = {k: torch.ones(s) for k, s in SCHEMA.items()}
    with torch.no_grad():
        return api.prefill_fn(_t(_params()), _t(batch), TCFG,
                              default_runtime(), masks)


def _port_decode(token, cache):
    api = build(TCFG)
    masks = {k: torch.ones(s) for k, s in SCHEMA.items()}
    with torch.no_grad():
        return api.decode_fn(_t(_params()), torch.tensor(token), cache, TCFG,
                             default_runtime(), masks)


def test_prefill_and_decode_match_jax():
    """The prefill logits over 17 and 18 decoder tokens and the decode of
    token 18 from the padded cache, each against JAX's at 1e-5; the decode
    against the longer prefill at the reference's tolerance (2e-3) and at
    1e-5 (rounding only)."""
    b18 = _batch(4, S_DEC + 1)
    l17, cache = _port_prefill({**b18, "tokens": b18["tokens"][:, :S_DEC]})
    l18, _ = _port_prefill(b18)
    assert cache["pos"] == S_DEC
    cache = SV.pad_cache(cache, S_DEC + 1)
    ld, cache = _port_decode(b18["tokens"][:, S_DEC:], cache)
    assert cache["pos"] == S_DEC + 1
    for got, want in zip((l17, l18, ld), _jax_serve()):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(ld), _np(l18), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(ld), _np(l18), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="outside the KV cache"):
        _port_decode(b18["tokens"][:, S_DEC:], cache)


def test_pad_cache_leaves_the_cross_cache_at_the_encoder_length():
    """``pad_cache`` zero-pads the decoder's self K / V to the prompt plus
    the generated tokens and returns the cross K / V as they are: cross-
    attention masks no key, so a zero key would take probability mass and
    change the decode."""
    b18 = _batch(4, S_DEC + 1)
    _, cache = _port_prefill({**b18, "tokens": b18["tokens"][:, :S_DEC]})
    padded = SV.pad_cache(cache, S_DEC + 8)
    for k in ("k", "v"):
        assert tuple(padded["kv"]["self"][k].shape) == (2, B, S_DEC + 8, 4,
                                                        16)
        assert padded["kv"]["cross"][k] is cache["kv"]["cross"][k]
        assert tuple(padded["kv"]["cross"][k].shape) == (2, B, S_ENC, 4, 16)
        np.testing.assert_array_equal(
            _np(padded["kv"]["self"][k][:, :, :S_DEC]),
            _np(cache["kv"]["self"][k]))
        assert not padded["kv"]["self"][k][:, :, S_DEC:].any()
    token = b18["tokens"][:, S_DEC:]
    good, _ = _port_decode(token, padded)
    cross = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
             for k, v in cache["kv"]["cross"].items()}
    both = {"kv": {"self": SV.pad_cache(cache, S_DEC + 8)["kv"]["self"],
                   "cross": cross}, "pos": S_DEC}
    bad, _ = _port_decode(token, both)
    _, _, want = _jax_serve()
    np.testing.assert_allclose(_np(good), want, rtol=0, atol=ATOL)
    assert float(np.abs(_np(bad) - want).max()) > 1e-3


def test_make_adapter_refuses_encdec():
    """No federated encoder-decoder, as in the reference
    (tests/test_federated_lm.py)."""
    from repro_torch.federated.adapter import make_adapter
    with pytest.raises(NotImplementedError, match="supported families"):
        make_adapter(TCFG, "cuda", 16, torch.device("cpu"))


def test_make_batch_draws_in_the_reference_order():
    """``launch.train.make_batch``: the row indices, then the stub frame
    embeddings (batch, seq, d_model), from one generator, as the
    reference CLI draws them; ``launch.serve.serve_batch`` draws the
    prompt's frame embeddings (batch, prompt, d_model) as the reference's
    ``serve_batch`` does."""
    data = np.random.default_rng(3).integers(0, 256, (64, 33))
    rng, ref = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        got = TR.make_batch(TCFG, data, rng, 4, 32, "cpu")
        idx = ref.integers(0, len(data), 4)
        enc = ref.normal(size=(4, 32, 64))
        np.testing.assert_array_equal(_np(got["tokens"]), data[idx, :32])
        np.testing.assert_array_equal(_np(got["enc_embeds"]),
                                      enc.astype(np.float32))
    prompts = data[:4, :16]
    got = SV.serve_batch(prompts, "cpu", TCFG, np.random.default_rng(2))
    want = np.random.default_rng(2).normal(size=(4, 16, 64))
    np.testing.assert_array_equal(_np(got["enc_embeds"]),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(_np(got["tokens"]), prompts)


def test_train_steps_match_jax():
    """Three ``make_train_step`` steps (Helios at volume 0.5, grad-EMA
    scores over all five keys, AdamW) on ``make_batch``'s batches.  The
    cross-attention key bias moves on rounding noise (its gradient is
    zero but for rounding: see
    ``test_cross_attention_key_bias_gradient_is_rounding_noise``), which
    AdamW turns into steps of a share of the lr, in either package
    (ROADMAP §3): it is held within the lr summed over the steps, every
    other leaf at 1e-5."""
    data = np.random.default_rng(3).integers(0, 256, (64, 25))
    rng = np.random.default_rng(0)
    batches = [{k: _np(v) for k, v in TR.make_batch(
        TCFG, data, rng, B, 24, "cpu").items()} for _ in range(3)]
    sched = warmup_cosine_schedule(TCFG_RUN["learning_rate"],
                                   TCFG_RUN["warmup_steps"],
                                   TCFG_RUN["total_steps"])
    lr_sum = sum(float(sched(i)) for i in range(len(batches)))
    check_train_states(*run_train_steps(JCFG, TCFG, _params(), batches),
                       what=ARCH, exempt={"dec_blocks/cross/bk": lr_sum})


def test_cross_attention_key_bias_gradient_is_rounding_noise():
    """Cross-attention has no RoPE and masks no key, so the key bias adds
    q . bk to every score of a query alike and the softmax cancels it:
    its gradient is zero but for rounding, in both packages, a millionth
    of the query bias's."""
    _, jgrads = _jax_loss_grads(False)
    tp = _t(_params())
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    loss = build(TCFG).loss_fn(tp, _t(_batch(5)), TCFG, default_runtime())
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for g in (_np(grads["dec_blocks/cross/bk"]),
              jgrads["dec_blocks/cross/bk"]):
        assert float(np.abs(g).max()) <= 1e-6 * float(
            np.abs(jgrads["dec_blocks/cross/bq"]).max())
    for path in ("dec_blocks/attn/bk", "enc_blocks/attn/bk"):
        assert float(np.abs(jgrads[path]).max()) > 1e-4, path


def test_serve_cli_generates_on_the_reduced_config():
    report = {}
    toks = SV.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "12", "--gen", "4"],
                   report=report)
    assert tuple(toks.shape) == (2, 4)
    assert tuple(report["batch"]["enc_embeds"].shape) == (2, 12, 64)
    assert tuple(report["cache"]["kv"]["self"]["k"].shape) == (2, 2, 16, 4,
                                                               16)
    assert tuple(report["cache"]["kv"]["cross"]["k"].shape) == (2, 2, 12, 4,
                                                                16)
