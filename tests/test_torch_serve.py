"""Port parity: the serving plane (``repro_torch.launch.serve``, the
families' prefill / decode) against the JAX package, on the CPU.

* prefill logits and caches, and teacher-forced decode logits on a cache
  padded to prompt + generated tokens, at atol 1e-5 for ``reduced()``
  DeepSeek-7B (dense), Granite-3.0-1B-A400M with its first layer dense and
  one shared expert (MoE) and Zamba2-1.2B (hybrid), the JAX params carried
  across by the weight bridge;
* the port's ``GenerationServer`` tokens equal JAX's own greedy decode on
  the padded cache, and the reference's KV-cache clamp is pinned as a
  divergence (ROADMAP §3): JAX's ``GenerationServer`` decodes into a cache
  exactly as long as the prompt, ``dynamic_update_slice`` clamps every
  write to the last slot, and its tokens fork from the second one on;
* ``mamba2_decode`` stepped over a sequence against ``mamba2_fwd`` over it;
* ``ServeLoop``: the promotion gate both ways, nothing served before a
  snapshot, a partial snapshot never observed, a swap that leaves the
  previously served tensors untouched, traffic while a publisher writes,
  a training exception raised on the caller; the Poisson schedule equal
  to JAX's for the same seed; the engines' publish hook and its metadata;
  the CLI's ``--gen 1`` and ``--ckpt-dir`` (a snapshot JAX wrote) cases.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro import checkpoint as JCKPT  # noqa: E402
from repro.launch import serve as jSV  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.data.synthetic import markov_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import build, default_runtime, make_full_masks  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tSSM  # noqa: E402
from repro_torch.obs import recorder as OBS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
B, P, G = 2, 8, 5


def _dense1_shared1(cfg):
    return dataclasses.replace(cfg, first_k_dense=1, num_shared_experts=1)


FAMILIES = {
    "dense": (JC.reduced(JC.ARCHS["deepseek-7b"]),
              TC.reduced(TC.DEEPSEEK_7B)),
    "moe": (_dense1_shared1(JC.reduced(JC.ARCHS["granite-moe-1b-a400m"])),
            _dense1_shared1(TC.reduced(TC.GRANITE_MOE_1B_A400M))),
    "hybrid": (JC.reduced(JC.ARCHS["zamba2-1.2b"]),
               TC.reduced(TC.ZAMBA2_1_2B)),
}
#: JAX's GenerationServer on the probe's inputs (PRNGKey(0) params, prompts
#: default_rng(0).integers(0, vocab, (2, 8))): forks from its own padded
#: greedy decode at the second token
CLAMP_PIN = {
    "dense": ([[249, 197, 152, 72, 249], [28, 129, 28, 129, 28]],
              [[249, 249, 249, 249, 249], [28, 129, 28, 28, 18]]),
    "hybrid": ([[137, 203, 97, 203, 151], [137, 137, 137, 137, 137]],
               [[137, 230, 130, 64, 230], [137, 137, 137, 175, 96]]),
}


def _pad_jax(cache, length):
    def pad(path, v):
        if jax.tree_util.keystr(path)[-5:] in ("['k']", "['v']"):
            widths = [(0, 0)] * (v.ndim - 3) + \
                [(0, length - v.shape[-3]), (0, 0), (0, 0)]
            return jnp.pad(v, widths)
        return v
    return jax.tree_util.tree_map_with_path(pad, cache)


def _leaves(cache):
    """{path: array} of a cache (either package), ``pos`` dropped."""
    if torch.is_tensor(cache):
        return cache.detach().numpy()
    if isinstance(cache, dict):
        return {k: _leaves(v) for k, v in cache.items() if k != "pos"}
    if isinstance(cache, (list, tuple)):
        return {f"<{i}>": _leaves(v) for i, v in enumerate(cache)}
    return np.asarray(cache)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_ref():
    """Per family, from JAX (one jitted prefill and decode program each):
    params, prompts and the teacher-forced continuation, prefill logits and
    cache, decode logits on the padded cache, the padded greedy tokens,
    and (dense, hybrid) JAX GenerationServer's tokens."""
    out = {}
    for fam, (jcfg, _) in FAMILIES.items():
        params = jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), jcfg))
        prompts = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (B, P)).astype(np.int32)
        forced = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (B, G)).astype(np.int32)
        srv = jSV.GenerationServer(jcfg, B, P, gen=G)
        batch = {"tokens": jnp.asarray(prompts)}
        # the reference server's own (clamped) decode, where it is pinned
        server_toks = np.asarray(srv(params, batch)) if fam in CLAMP_PIN \
            else None
        logits, cache = srv.prefill(params, batch)
        prefill = (np.asarray(logits), _leaves(jax.device_get(cache)))
        padded = _pad_jax(cache, P + G)
        dec_logits, c = [], padded
        for i in range(G):
            lg, c = srv.decode(params, jnp.asarray(forced[:, i:i + 1]), c)
            dec_logits.append(np.asarray(lg))
        final_cache = _leaves(jax.device_get(c))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        greedy, c = [tok], padded
        for _ in range(G - 1):
            lg, c = srv.decode(params, tok, c)
            tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
            greedy.append(tok)
        out[fam] = dict(params=params, prompts=prompts, forced=forced,
                        prefill=prefill, decode=dec_logits,
                        final_cache=final_cache,
                        greedy=np.asarray(jnp.concatenate(greedy, 1)),
                        server=server_toks)
    return out


def _port(fam, ref):
    tcfg = FAMILIES[fam][1]
    return tcfg, params_from_numpy(ref["params"], device="cpu")


def _assert_tree_close(a, b, what):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys(), what
    for k in fa:
        assert fa[k].shape == fb[k].shape, (what, k)
        np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=ATOL,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# prefill / decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_matches_jax(jax_ref, fam):
    ref = jax_ref[fam]
    tcfg, params = _port(fam, ref)
    srv = SV.GenerationServer(tcfg, B, P, gen=G, device="cpu")
    logits, cache = srv.prefill(params, SV.serve_batch(ref["prompts"], "cpu"))
    assert cache["pos"] == P
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], rtol=0,
                               atol=ATOL)
    _assert_tree_close(_leaves(cache), ref["prefill"][1], "prefill cache")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_teacher_forced_decode_matches_jax(jax_ref, fam):
    ref = jax_ref[fam]
    tcfg, params = _port(fam, ref)
    srv = SV.GenerationServer(tcfg, B, P, gen=G, device="cpu")
    _, cache = srv.prefill(params, SV.serve_batch(ref["prompts"], "cpu"))
    cache = SV.pad_cache(cache, P + G)
    for i in range(G):
        logits, cache = srv.decode(
            params, torch.as_tensor(ref["forced"][:, i:i + 1]), cache)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i], rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
    assert cache["pos"] == P + G
    _assert_tree_close(_leaves(cache), ref["final_cache"], "decoded cache")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_generation_server_matches_jax_padded_greedy(jax_ref, fam):
    ref = jax_ref[fam]
    tcfg, params = _port(fam, ref)
    srv = SV.GenerationServer(tcfg, B, P, gen=G, device="cpu")
    toks = srv(params, SV.serve_batch(ref["prompts"], "cpu"))
    assert toks.dtype == torch.int32 and toks.shape == (B, G)
    np.testing.assert_array_equal(toks.numpy(), ref["greedy"])


@pytest.mark.parametrize("fam", list(CLAMP_PIN))
def test_reference_kv_clamp_is_not_copied(jax_ref, fam):
    """JAX's GenerationServer writes every decode step into the last slot of
    a prompt-length cache: its first token is right, the rest fork from the
    padded decode (which the port reproduces, above)."""
    ref = jax_ref[fam]
    server, padded = CLAMP_PIN[fam]
    assert ref["server"].tolist() == server
    assert ref["greedy"].tolist() == padded
    assert (ref["server"][:, 0] == ref["greedy"][:, 0]).all()
    assert (ref["server"][:, 1:] != ref["greedy"][:, 1:]).any()
    if fam == "hybrid":   # the fork is the shared attention's cache
        assert ref["prefill"][1]["attn"]["<0>"]["k"].shape[1] == P


def test_decode_past_the_cache_raises(jax_ref):
    """The port never clamps: a cache without room for the token raises."""
    ref = jax_ref["dense"]
    tcfg, params = _port("dense", ref)
    srv = SV.GenerationServer(tcfg, B, P, gen=G, device="cpu")
    _, cache = srv.prefill(params, SV.serve_batch(ref["prompts"], "cpu"))
    with pytest.raises(ValueError, match="outside the KV cache"):
        srv.decode(params, torch.zeros((B, 1), dtype=torch.int32), cache)


def test_hybrid_prefill_runs_ssd_diag_once_a_layer(jax_ref, monkeypatch):
    """Under kernels="cuda" the served hybrid's prefill calls the ssd_diag
    op on the kernel route once a Mamba2 layer (on the CPU the op runs its
    plain body and the launch counter stays 0) and a decode step never;
    the tokens are the plain path's."""
    ref = jax_ref["hybrid"]
    tcfg, params = _port("hybrid", ref)
    batch = SV.serve_batch(ref["prompts"], "cpu")
    calls = []
    real = tSSM.ops.ssd_diag

    def spy(*a, impl, **kw):
        calls.append(impl)
        return real(*a, impl=impl, **kw)

    monkeypatch.setattr(tSSM.ops, "ssd_diag", spy)
    SS.reset_launches()
    srv = SV.GenerationServer(tcfg, B, P, gen=1, kernels="cuda",
                              device="cpu")
    _, cache = srv.prefill(params, batch)
    assert calls == ["cuda"] * tcfg.num_layers
    cache = SV.pad_cache(cache, P + 1)
    srv.decode(params, torch.zeros((B, 1), dtype=torch.int32), cache)
    assert len(calls) == tcfg.num_layers and SS.LAUNCHES["ssd_diag"] == 0
    np.testing.assert_array_equal(
        srv(params, batch).numpy(), ref["greedy"][:, :1])


def test_mamba2_decode_matches_fwd():
    """Stepping the decode recurrence over a sequence gives the chunked
    forward's outputs, and its final cache equals the forward's."""
    tcfg = TC.reduced(TC.ZAMBA2_1_2B)
    params = build(tcfg).spec["mamba"]
    from repro_torch.models.module import init_params, tree_map
    p = tree_map(lambda t: t[0], init_params(params, 3, "cpu"))
    x = torch.randn(2, 12, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    full, fcache = tSSM.mamba2_fwd(p, x, tcfg, return_cache=True)
    _, cache = tSSM.mamba2_fwd(p, x[:, :5], tcfg, return_cache=True)
    outs = []
    for t in range(5, 12):
        y, cache = tSSM.mamba2_decode(p, x[:, t:t + 1], cache, tcfg)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 5:].numpy(), rtol=0, atol=ATOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache[k].numpy(), fcache[k].numpy(),
                                   rtol=0, atol=ATOL, err_msg=k)


def test_attention_offsets_match_jax():
    """dense_attention's q_offset and kv_len_mask against the reference."""
    from repro.models import layers as jL
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    valid = rng.random((2, 7)) < 0.7
    valid[:, 0] = True
    want = jL.dense_attention(q, k, v, causal=True, q_offset=4,
                              kv_len_mask=jnp.asarray(valid))
    got = tL.dense_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=True, q_offset=4,
                             kv_len_mask=torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_server_rejects_what_it_cannot_serve():
    with pytest.raises(ValueError, match="no prefill/decode"):
        SV.GenerationServer(TC.reduced(TC.LENET), 1, 8, device="cpu")
    with pytest.raises(ValueError, match="gen must be >= 1"):
        SV.GenerationServer(TC.reduced(TC.DEEPSEEK_7B), 1, 8, gen=0,
                            device="cpu")
    srv = SV.GenerationServer(TC.reduced(TC.DEEPSEEK_7B), 2, 8, device="cpu")
    with pytest.raises(ValueError, match="cell is"):
        srv(None, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# ServeLoop: promotion gate and lock-free swaps
# ---------------------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32)),
            "b": torch.as_tensor(rng.normal(size=(4,)).astype(np.float32))}


def _echo(params, batch):
    return params["w"].sum() + batch


def test_promotion_gate_rejects_regression(tmp_path):
    d = str(tmp_path)
    metrics = iter([1.0, 2.0, 0.9])        # good, regressed, recovered
    rec = OBS.Recorder(armed=True)
    loop = SV.ServeLoop(d, _tree(), request_fn=_echo,
                        eval_fn=lambda p: next(metrics),
                        higher_is_better=False, tol=0.1, recorder=rec)
    CKPT.save(d, 1, _tree(1), metadata={"round": 1})
    assert loop.poll() and loop.served_step == 1
    CKPT.save(d, 2, _tree(2), metadata={"round": 2})
    assert not loop.poll()                 # 2.0 > 1.0 + tol: rejected
    assert loop.served_step == 1 and loop.served_metric == 1.0
    assert not loop.poll()                 # decided once
    assert rec.count("serve_rejections") == 1
    CKPT.save(d, 3, _tree(3), metadata={"round": 3})
    assert loop.poll() and loop.served_step == 3 and loop.served_round == 3
    assert rec.count("serve_swaps") == 2
    loop.handle(0.0)
    kinds = [e["kind"] for e in rec.events]
    assert kinds.count("promotion") == 3 and kinds.count("swap") == 2
    promo = [e for e in rec.events if e["kind"] == "promotion"]
    assert [p["promoted"] for p in promo] == [True, False, True]
    assert all("staleness" in s for s in rec.events if s["kind"] == "swap")
    assert rec.hists["serve_staleness"] == [0]


def test_promotion_gate_higher_is_better(tmp_path):
    d = str(tmp_path)
    metrics = iter([0.8, 0.5])
    loop = SV.ServeLoop(d, _tree(), request_fn=_echo,
                        eval_fn=lambda p: next(metrics),
                        higher_is_better=True, tol=0.1)
    CKPT.save(d, 1, _tree(1))
    assert loop.poll()
    CKPT.save(d, 2, _tree(2))
    assert not loop.poll()                 # 0.5 < 0.8 - 0.1: rejected


def test_serve_before_any_snapshot_raises(tmp_path):
    loop = SV.ServeLoop(str(tmp_path), _tree(), request_fn=_echo)
    assert not loop.poll()
    with pytest.raises(RuntimeError, match="nothing promoted"):
        loop.handle(0.0)


def test_hot_swap_never_serves_partial_snapshot(tmp_path):
    d = str(tmp_path)
    loop = SV.ServeLoop(d, _tree(), request_fn=_echo)
    CKPT.save(d, 1, _tree(1), metadata={"round": 1})
    assert loop.poll() and loop.served_step == 1
    blob = (tmp_path / "ckpt_1.msgpack.zst").read_bytes()
    (tmp_path / "ckpt_2.msgpack.zst.tmp").write_bytes(blob[: len(blob) // 3])
    assert not loop.poll()                 # a .tmp never matches the key
    out = loop.handle(0.0)
    assert loop.served_step == 1
    np.testing.assert_allclose(float(out), float(_tree(1)["w"].sum()),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def lm_serving():
    tcfg = TC.reduced(TC.DEEPSEEK_7B)
    srv = SV.GenerationServer(tcfg, 2, 8, gen=3, device="cpu")
    req = SV.serve_batch(markov_tokens(2, 8, tcfg.padded_vocab, seed=0),
                         "cpu")
    return tcfg, srv, req


def _lm_params(tcfg, seed):
    from repro_torch.models import init_params
    return init_params(tcfg, seed, "cpu")


def test_swap_leaves_served_tensors_untouched(lm_serving, tmp_path):
    """A swap restores into NEW tensors and rebinds; the snapshot a request
    already holds keeps its values and its storage."""
    tcfg, srv, req = lm_serving
    d = str(tmp_path)
    loop = SV.ServeLoop(d, _lm_params(tcfg, 0), request_fn=srv)
    held, copies, toks = [], [], []
    for step in (1, 2, 3):
        CKPT.save(d, step, _lm_params(tcfg, step), metadata={"round": step})
        assert loop.poll() and loop.served_step == step
        params = loop.served_params
        held.append(params)
        copies.append({k: v.clone() for k, v in
                       _flat(params).items()})
        toks.append(loop.handle(req))
        assert toks[-1].shape == (2, 3)
    ptrs = [{k: v.data_ptr() for k, v in _flat(p).items()} for p in held]
    assert not set(ptrs[0].values()) & set(ptrs[1].values())
    for params, copy in zip(held, copies):
        for k, v in _flat(params).items():
            assert torch.equal(v, copy[k]), k
    np.testing.assert_array_equal(toks[-1].numpy(),
                                  srv(_lm_params(tcfg, 3), req).numpy())


def test_traffic_loop_serves_while_training(lm_serving, tmp_path):
    tcfg, srv, req = lm_serving
    d = str(tmp_path)
    params = _lm_params(tcfg, 0)
    rec = OBS.Recorder(armed=True)
    loop = SV.ServeLoop(d, params, request_fn=srv, recorder=rec)
    CKPT.save(d, 0, params, metadata={"round": 0})
    assert loop.poll()
    published = threading.Event()

    def train_fn():                         # a stand-in publisher
        CKPT.save(d, 5, _lm_params(tcfg, 5), metadata={"round": 5})
        published.wait(5.0)

    def make_batch(i):
        published.set()
        return req

    stats = SV.serve_while_training(
        train_fn, loop, SV.PoissonTraffic(rate_hz=500.0, seed=0),
        make_batch, min_requests=3)
    assert stats["requests"] >= 3
    assert len(stats["latency_ms"]) == stats["requests"]
    assert len(stats["service_ms"]) == stats["requests"]
    assert all(0 < s <= lat for s, lat in zip(stats["service_ms"],
                                              stats["latency_ms"]))
    assert stats["requests_per_sec"] > 0
    assert loop.served_step == 5            # the final poll saw the publish
    assert rec.count("serve_swaps") >= 2
    assert len(rec.hists["request_ms"]) == stats["requests"]
    assert len(rec.hists["service_ms"]) == stats["requests"]


def test_traffic_training_exception_propagates(lm_serving, tmp_path):
    tcfg, srv, req = lm_serving
    d = str(tmp_path)
    params = _lm_params(tcfg, 0)
    loop = SV.ServeLoop(d, params, request_fn=srv)
    CKPT.save(d, 0, params, metadata={"round": 0})
    assert loop.poll()

    def boom():
        raise RuntimeError("train thread died")

    with pytest.raises(RuntimeError, match="train thread died"):
        SV.serve_while_training(boom, loop,
                                SV.PoissonTraffic(rate_hz=500.0, seed=0),
                                lambda i: req, min_requests=1)


def test_poisson_schedule_matches_jax():
    for seed, rate in ((0, 50.0), (3, 50.0), (4, 7.5)):
        a = list(itertools.islice(SV.PoissonTraffic(rate, seed).schedule(),
                                  20))
        j = list(itertools.islice(jSV.PoissonTraffic(rate, seed).schedule(),
                                  20))
        assert a == j
        assert all(x < y for x, y in zip(a, a[1:]))
    with pytest.raises(ValueError, match="rate_hz"):
        next(SV.PoissonTraffic(0.0).schedule())


def test_make_ce_eval_is_the_held_out_loss(lm_serving):
    tcfg, _, req = lm_serving
    params = _lm_params(tcfg, 1)
    ce = SV.make_ce_eval(tcfg, req)(params)
    want = build(tcfg).loss_fn(params, req, tcfg, default_runtime(), None)
    assert ce == float(want)


# ---------------------------------------------------------------------------
# the engines' publish hook
# ---------------------------------------------------------------------------


def _lenet_run(tmp_path, **kw):
    cfg = TC.reduced(TC.LENET)
    imgs, labels = class_gaussian_images(400, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes,
                                         seed=0)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    hcfg = TC.HeliosConfig()
    clients = setup_clients(make_fleet(2, 2), parts, hcfg, device="cpu")
    return FLRun(cfg, hcfg, "helios", clients,
                 {"images": imgs, "labels": labels},
                 {"images": imgs[:64], "labels": labels[:64]},
                 local_steps=1, lr=0.05, seed=0, eval_batch=64,
                 device="cpu", **kw)


def test_publish_hook_round_end(tmp_path):
    """Snapshots at the end of every ``publish_every``-th round, GC'd to
    ``publish_keep``, metadata carrying round / sim_time / scheme, the
    published params exactly the global params, JAX reading them too."""
    pub = tmp_path / "pub"
    rec = OBS.Recorder(armed=True)
    run = _lenet_run(tmp_path, publish_dir=str(pub), publish_every=2,
                     publish_keep=1, recorder=rec)
    run.run_sync(4, eval_every=0)
    steps = sorted(int(f.split("_")[1].split(".")[0])
                   for f in os.listdir(pub) if f.endswith(".zst"))
    assert steps == [4]                     # rounds 2 and 4; keep=1
    assert run.rec.count("published_snapshots") == 2
    meta = CKPT.metadata(str(pub))
    assert meta["round"] == 4 and meta["scheme"] == "helios"
    assert meta["sim_time"] > 0
    out, step = CKPT.restore(str(pub), run.global_params)
    assert step == 4
    jout, _ = JCKPT.restore(str(pub), {k: v.numpy() for k, v in
                                       run.global_params.items()})
    for k, v in run.global_params.items():
        assert torch.equal(out[k], v), k
        np.testing.assert_array_equal(jout[k], v.numpy(), err_msg=k)
    pubs = [e for e in rec.events if e["kind"] == "publish"]
    assert [(p["round"], p["step"]) for p in pubs] == [(1, 2), (3, 4)]
    assert [e["round"] for e in rec.events if e["kind"] == "span"
            and e["name"] == "publish"] == [1, 3]


def test_publish_every_validation(tmp_path):
    with pytest.raises(ValueError, match="publish_every"):
        _lenet_run(tmp_path, publish_every=0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_gen_one_prefill_only(capsys):
    toks = SV.main(["--arch", "deepseek-7b", "--reduced", "--batch", "1",
                    "--prompt-len", "8", "--gen", "1", "--device", "cpu"])
    assert toks.shape == (1, 1)
    out = capsys.readouterr().out
    assert "prefill-only" in out and "tok/s" not in out.split("skipped")[0]


def test_cli_layers_cuts_the_depth():
    """--layers serves the config at its widths with fewer layers: the
    params and the tokens are those of the cut config's server."""
    report = {}
    toks = SV.main(["--arch", "zamba2-1.2b", "--reduced", "--layers", "1",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3",
                    "--device", "cpu"], report=report)
    full = TC.reduced(TC.ZAMBA2_1_2B)
    cfg = report["cfg"]
    assert cfg.num_layers == 1 < full.num_layers
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
    assert toks.shape == (2, 3)
    srv = SV.GenerationServer(cfg, 2, 8, gen=3, device="cpu")
    np.testing.assert_array_equal(
        toks.numpy(), srv(report["params"], report["batch"]).numpy())


def test_cli_serves_a_snapshot_jax_wrote(jax_ref, tmp_path, capsys):
    """--ckpt-dir restores a snapshot the JAX package published; the tokens
    are the port server's on those params."""
    ref = jax_ref["dense"]
    JCKPT.save(str(tmp_path), 9, ref["params"], metadata={"round": 9})
    report = {}
    toks = SV.main(["--arch", "deepseek-7b", "--reduced", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)], report=report)
    assert toks.shape == (2, 3)
    assert "restored snapshot step 9" in capsys.readouterr().out
    for k, v in _flat(report["params"]).items():
        want = _flat(ref["params"])[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(want), err_msg=k)
    tcfg, params = _port("dense", ref)
    srv = SV.GenerationServer(tcfg, 2, 8, gen=3, device="cpu")
    np.testing.assert_array_equal(toks.numpy(),
                                  srv(params, report["batch"]).numpy())


def test_module_entry_points_run():
    """``python -m repro_torch.launch.serve`` and ``python -m
    repro_torch.obs`` run as modules with JAX blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['serve', '--reduced', '--arch', 'zamba2-1.2b', "
            "'--batch', '1', '--prompt-len', '8', '--gen', '2', "
            "'--device', 'cpu']\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n"
            "sys.argv = ['obs', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.obs', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "decode: 1 x 1 tokens" in out.stdout
    assert "report" in out.stdout and "diff" in out.stdout
