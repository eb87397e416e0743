"""Port parity: xLSTM (``repro_torch.models.xlstm``, family ``ssm``) against
the JAX package's ``repro.models.xlstm`` on the CPU.

* the chunkwise mLSTM against the step-by-step recurrence at chunks 8, 16
  and 64 (h within 1e-5 of max|h|, the carried state within 1e-5
  relative), and against JAX's chunkwise form;
* ``xlstm_loss`` and its gradients on ``reduced(xlstm-125m)`` (4 blocks,
  the sLSTM at index 1) with random head masks: loss within 1e-5,
  gradients within 1e-4, the JAX params carried across by the weight
  bridge; the spec's axes and the mask schema equal JAX's;
* prefill + decode: each decode step's logits against one prefill over
  the longer sequence, and against JAX's decode from JAX's prefill;
* the reference's chunkwise mLSTM exponentiates above the diagonal: at
  chunk 64 with forget gates near 0 its gradient is NaN; the port's is
  finite and equals the recurrence's (ROADMAP §3);
* ``FLRun.run_sync(2)`` of helios on reduced xlstm-125m (2 + 2 clients,
  one local step) against JAX's ``FLRun``: history equal, cross-entropy,
  loss and params within 1e-5, straggler masks identical.
"""
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
from repro.models import api as jAPI  # noqa: E402
from repro.models import xlstm as jX  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import build, logical_axes  # noqa: E402
from repro_torch.models import xlstm as tX  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

JCFG = JC.reduced(JC.ARCHS["xlstm-125m"])
TCFG = TC.reduced(TC.XLSTM_125M)
B, S = 2, 64


def _cell_inputs(seed: int, s: int = 64, forget_shift: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, s, 3, 8, generator=g) for _ in range(3))
    gi = torch.randn(2, s, 3, generator=g)
    gf = torch.randn(2, s, 3, generator=g) + forget_shift
    return q, k, v, gi, gf


@pytest.fixture(scope="module")
def params():
    jp = jAPI.init_params(jax.random.PRNGKey(0), JCFG)
    host = jax.device_get(jp)
    return jp, host


@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(1)
    return {k: (rng.random(s) < 0.6).astype(np.float32)
            for k, s in build(TCFG).mask_schema.items()}


def test_config_spec_and_schema_match_jax():
    for f in TCFG.__dataclass_fields__:
        assert getattr(TCFG, f) == getattr(JCFG, f), f
    assert TCFG.slstm_layers == (1,) and TCFG.num_layers == 4
    assert build(TCFG).mask_schema == jX.xlstm_mask_schema(JCFG) == {
        "b0:ssm_heads": (1, 4), "b1:slstm_heads": (1, 4),
        "b2:ssm_heads": (1, 4), "b3:ssm_heads": (1, 4)}
    ja = dict(tree_paths(jAPI.logical_axes(JCFG),
                         is_leaf=lambda x: isinstance(x, tuple)))
    ta = dict(tree_paths(logical_axes(TCFG),
                         is_leaf=lambda x: isinstance(x, tuple)))
    assert ja == ta


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunkwise_matches_recurrence_and_jax(chunk):
    q, k, v, gi, gf = _cell_inputs(chunk)
    h1, s1 = tX.mlstm_chunkwise(q, k, v, gi, gf, chunk)
    h2, s2 = tX.mlstm_recurrent_ref(q, k, v, gi, gf)
    scale = float(h2.abs().max())
    assert float((h1 - h2).abs().max()) <= 1e-5 * scale
    for a, b in zip(s1, s2):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    jh, js = jX.mlstm_chunkwise(*(jnp.asarray(t.numpy())
                                  for t in (q, k, v, gi, gf)), chunk)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * scale)
    for a, b in zip(s1, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_chunkwise_carries_state_across_calls():
    """Two calls with the state carried equal one call over both halves."""
    q, k, v, gi, gf = _cell_inputs(3)
    h, st = tX.mlstm_chunkwise(q, k, v, gi, gf, 16)
    ha, sa = tX.mlstm_chunkwise(*(t[:, :32] for t in (q, k, v, gi, gf)), 16)
    hb, sb = tX.mlstm_chunkwise(*(t[:, 32:] for t in (q, k, v, gi, gf)), 16,
                                state=sa)
    scale = float(h.abs().max())
    assert float((torch.cat([ha, hb], 1) - h).abs().max()) <= 1e-5 * scale
    for a, b in zip(sb, st):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_loss_and_grads_match_jax(params, masks):
    jp, host = params
    tokens = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jX.xlstm_loss(p, {"tokens": jnp.asarray(tokens)}, JCFG,
                                None, jm)))(jp)
    tp = params_from_numpy(host, device="cpu")
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    tl = tX.xlstm_loss(tp, {"tokens": torch.as_tensor(tokens)}, TCFG, None,
                       {k: torch.as_tensor(v) for k, v in masks.items()})
    grads = torch.autograd.grad(tl, list(leaves.values()))
    assert abs(float(tl) - float(jl)) <= 1e-5
    jgf = dict(tree_paths(jax.device_get(jg)))
    assert set(jgf) == set(leaves)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jgf[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # a masked head's input branch gets no gradient, as in the reference
    for key, m in masks.items():
        blk = key.split(":")[0]
        dead = np.flatnonzero(m[0] == 0)
        if dead.size and key.endswith("ssm_heads"):
            wx = dict(zip(leaves, grads))[f"blocks/{blk}/cell/wx"]
            assert not bool(wx[:, dead].any())


def test_prefill_decode_match_longer_prefill_and_jax(params, masks):
    jp, host = params
    tp = params_from_numpy(host, device="cpu")
    tm = {k: torch.as_tensor(v) for k, v in masks.items()}
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    seq = np.random.default_rng(2).integers(0, 256, (B, 20)).astype(np.int32)
    p_len = 16
    with torch.no_grad():
        logits, cache = tX.xlstm_prefill(
            tp, {"tokens": torch.as_tensor(seq[:, :p_len])}, TCFG, None, tm)
        assert cache["pos"] == p_len
        jlog, jcache = jax.jit(lambda p, b: jX.xlstm_prefill(
            p, b, JCFG, None, jm))(jp, {"tokens": jnp.asarray(seq[:, :p_len])})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-5)
        jdec = jax.jit(lambda p, t, c: jX.xlstm_decode(p, t, c, JCFG, None,
                                                       jm))
        for i in range(p_len, seq.shape[1]):
            tok = seq[:, i:i + 1]
            logits, cache = tX.xlstm_decode(tp, torch.as_tensor(tok), cache,
                                            TCFG, None, tm)
            jlog, jcache = jdec(jp, jnp.asarray(tok), jcache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-5, err_msg=str(i))
            full, _ = tX.xlstm_prefill(
                tp, {"tokens": torch.as_tensor(seq[:, :i + 1])}, TCFG, None,
                tm)
            np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=0,
                                       atol=1e-4, err_msg=str(i))
        assert cache["pos"] == seq.shape[1]


def test_reference_intra_chunk_overflow_is_not_copied():
    """Forget gates near 0 (pre-activation about -5) at chunk 64: the
    reference's intra-chunk weights overflow above the diagonal and its
    gradient is NaN; the port exponentiates the kept entries only, gives
    the same forward values and a finite gradient equal to the
    recurrence's."""
    q, k, v, gi, gf = _cell_inputs(5, forget_shift=-5.0)
    jin = [jnp.asarray(t.numpy()) for t in (q, k, v, gi, gf)]
    jh, _ = jX.mlstm_chunkwise(*jin, 64)
    jgrad = jax.grad(lambda f: jX.mlstm_chunkwise(
        *jin[:4], f, 64)[0].sum())(jin[4])
    assert not bool(np.isfinite(np.asarray(jgrad)).all())
    gft = gf.clone().requires_grad_(True)
    h, _ = tX.mlstm_chunkwise(q, k, v, gi, gft, 64)
    scale = float(h.abs().max())
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * scale)
    g, = torch.autograd.grad(h.sum(), gft)
    assert bool(torch.isfinite(g).all())
    gfr = gf.clone().requires_grad_(True)
    hr, _ = tX.mlstm_recurrent_ref(q, k, v, gi, gfr)
    gr, = torch.autograd.grad(hr.sum(), gfr)
    assert float((g - gr).abs().max()) <= 1e-4 * float(gr.abs().max())


# ---------------------------------------------------------------------------
# xLSTM on the FL engine
# ---------------------------------------------------------------------------


def test_flrun_xlstm_matches_jax():
    from repro.federated import FLRun as JaxFLRun
    from repro.federated import make_fleet as j_make_fleet
    from repro.federated import setup_clients as j_setup_clients
    from repro_torch.data.federated import partition_by_topic
    from repro_torch.data.synthetic import markov_topic_tokens
    from repro_torch.federated import FLRun, make_fleet, setup_clients
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    train, test = {"tokens": tokens}, {"tokens": test_tokens}
    jcfg, tcfg = JCFG, TCFG
    jh, th = JC.HeliosConfig(), TC.HeliosConfig()
    kw = dict(local_steps=1, batch_size=4, lr=0.05, seed=0, eval_batch=48)
    jrun = JaxFLRun(jcfg, jh, "helios",
                    j_setup_clients(j_make_fleet(2, 2), parts, jh),
                    train, test, kernels="reference", **kw)
    share_jax_programs(jrun)
    init = jax.device_get(jrun.global_params)
    jrun.run_sync(2)
    with jax_keys():
        trun = FLRun(tcfg, th, "helios",
                     setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                     train, test, kernels="cuda", device="cpu",
                     init_params=init, **kw)
        trun.run_sync(2)
    for j, t in zip(jrun.history, trun.history):
        for k in ("cycle", "time", "volumes", "ratios"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["ce"] - j["ce"]) <= 1e-5
        assert abs(t["loss"] - j["loss"]) <= 1e-5
    assert max(trun.history[-1]["ratios"]) == 1.0 > \
        min(trun.history[-1]["ratios"])
    tparams = dict(tree_paths(trun.global_params))
    for k, v in tree_paths(jax.device_get(jrun.global_params)):
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=1e-5,
                                   err_msg=k)
    for jc, tc in zip(jrun.clients, trun.clients):
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(
                tc.helios_state["masks"][k].numpy(), np.asarray(m),
                err_msg=k)
