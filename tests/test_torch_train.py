"""Port parity: the training launch (``repro_torch.launch.steps`` and
``repro_torch.launch.train``) against the JAX package's ``repro.launch``
on the CPU.

* three ``make_train_step`` steps (Helios at volume 0.5 with ``grad_ema``
  scores, AdamW under the warmup-cosine schedule, global-norm clipping) on
  ``reduced()`` xlstm-125m, internvl2-1b (the image prefix), deepseek-7b
  and qwen2.5-32b (4 heads over 1 KV head, nonzero QKV biases): params
  within atol 1e-5, losses and gradient norms within 1e-5, scores within
  1e-5 of their size, masks equal; ``microbatches=2`` on deepseek-7b;
* ``make_fl_round_step`` on 2 clients with Helios on (volumes 0.5 and 1)
  and off, 2 local steps, on reduced deepseek-7b (and with Helios on, on
  reduced xlstm-125m): params, optimizer state, alpha and loss within
  1e-5, every client holding the global (the port of
  tests/test_fl_round.py);

  AdamW divides by sqrt(v), so a coordinate whose gradient is rounding
  noise or cancels to 1e-8 moves by a share of the lr set by that noise
  (ROADMAP §3).  The sLSTM input-gate bias, whose gradient is zero but
  for rounding (pinned by
  ``test_slstm_input_bias_gradient_is_rounding_noise``), is held apart by
  name, within the lr summed over the steps; every other leaf at 1e-5.
  The fused round runs momentum at the reference test's lr of 1e-2 and
  warmup 0, AdamW at the train steps' schedule: at lr 1e-2 and warmup 0
  AdamW's first steps are sign steps of the full lr, and JAX parts from
  itself by more than 1e-5 under a one-ulp nudge of its params
  (``test_adamw_round_at_lr_1e_2_parts_jax_from_itself``), so no second
  backend can be held at 1e-5 there;
* ``python -m repro_torch.launch.train --device cpu`` improves and resumes
  (the port of tests/test_train_driver.py), and a run resumed from a
  mid-run checkpoint ends bit for bit where the uninterrupted run ends;
* ``set_volume`` + ``begin_cycle`` give partial masks equal to JAX's;
* the VLM's prefill / decode against JAX's, the image prefix in the cache;
  a ``GenerationServer`` on the VLM and on xLSTM (xLSTM on ``FLRun``:
  tests/test_torch_xlstm.py).

The port's Eq. 2 draws go through the JAX key-path backend; the port runs
``kernels="cuda"`` (its plain bodies on the CPU), JAX ``"reference"``.
"""
import os
import shutil
import subprocess
import sys
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
from repro.core import soft_train as jST  # noqa: E402
from repro.launch import steps as jS  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import soft_train as ST  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import build, default_runtime  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import warmup_cosine_schedule  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
ARCHS = ("xlstm-125m", "internvl2-1b", "deepseek-7b", "qwen2.5-32b")
TCFG_RUN = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1)


def _cfgs(arch):
    return JC.reduced(JC.ARCHS[arch]), TC.reduced(TC.ARCHS[arch])


def _jax_params(jcfg, seed=0):
    params = jAPI.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:                      # zeros at init: make them count
        rng = np.random.default_rng(seed + 100)
        attn = params["blocks"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(
                rng.standard_normal(attn[k].shape).astype(np.float32) * 0.3)
    return params


def _batch(cfg, rng, b, s, lead=()):
    """Tokens (lead + (b, s)) and, for the VLM, image embeddings."""
    out = {"tokens": rng.integers(0, cfg.padded_vocab,
                                  lead + (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            lead + (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _states(jcfg, tcfg, hcfg_j, hcfg_t, tc_j, tc_t, volume=0.5, seed=0):
    """The same train state in both packages: JAX params bridged, Eq. 2
    masks of one begin_cycle at ``volume`` drawn through the JAX key
    path."""
    jp = _jax_params(jcfg)
    jstate = jS.init_train_state(jax.random.PRNGKey(0), jcfg, hcfg_j, tc_j)
    jstate["params"] = jp
    jstate["helios"] = jST.begin_cycle(
        jST.set_volume(jstate["helios"], volume), hcfg_j)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    with jax_keys():
        helios = ST.begin_cycle(ST.set_volume(ST.init_state(
            build(tcfg).mask_schema, 1.0, 0, "cpu"), volume), hcfg_t)
    tstate = {"params": tp, "opt": S.make_opt(tcfg, tc_t).init(tp),
              "step": torch.zeros((), dtype=torch.int32), "helios": helios}
    return jstate, tstate


def _assert_tree_close(t_tree, j_tree, atol=ATOL, what="", exempt=None):
    """Leaf by leaf within ``atol``; ``exempt`` maps a leaf to its own
    bound."""
    jt = dict(tree_paths(jax.device_get(j_tree)))
    tt = dict(tree_paths(t_tree))
    assert set(jt) == set(tt), what
    for k, v in jt.items():
        np.testing.assert_allclose(tt[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=(exempt or {}).get(k, atol),
                                   err_msg=f"{what} {k}")


def _run_steps(arch, microbatches=1, n_steps=3, b=2):
    jcfg, tcfg = _cfgs(arch)
    hj = JC.HeliosConfig(enabled=True, contribution="grad_ema")
    ht = TC.HeliosConfig(enabled=True, contribution="grad_ema")
    tc_j = JC.TrainConfig(microbatches=microbatches, **TCFG_RUN)
    tc_t = TC.TrainConfig(microbatches=microbatches, **TCFG_RUN)
    jstate, tstate = _states(jcfg, tcfg, hj, ht, tc_j, tc_t)
    jstep = jax.jit(jS.make_train_step(jcfg, hj, tc_j,
                                       jAPI.default_runtime(jcfg)))
    rt = default_runtime()
    rt["kernels"] = "cuda"
    tstep = S.make_train_step(tcfg, ht, tc_t, rt)
    rng = np.random.default_rng(7)
    metrics = []
    for _ in range(n_steps):
        nb = _batch(jcfg, rng, b, 24)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in nb.items()})
        metrics.append((jm, tm))
    # the sLSTM input-gate bias moves on rounding noise: within the lr
    # summed over the steps
    sched = warmup_cosine_schedule(tc_t.learning_rate, tc_t.warmup_steps,
                                   tc_t.total_steps)
    lr_sum = sum(float(sched(i)) for i in range(n_steps))
    exempt = {f"blocks/b{i}/cell/bi": lr_sum for i in tcfg.slstm_layers}
    return jstate, tstate, metrics, exempt


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    jstate, tstate, metrics, exempt = _run_steps(arch)
    for jm, tm in metrics:
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            ATOL * max(1.0, float(jm["grad_norm"]))
    _assert_tree_close(tstate["params"], jstate["params"], what=arch,
                       exempt=exempt)
    _assert_tree_close(tstate["opt"], jstate["opt"], what=f"{arch} opt")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    jh = jax.device_get(jstate["helios"])
    for k, m in jh["masks"].items():
        np.testing.assert_array_equal(tstate["helios"]["masks"][k].numpy(),
                                      np.asarray(m), err_msg=k)
        # the train step never ends a cycle: rotation counters stay 0
        assert not tstate["helios"]["skip_counts"][k].any()
    for k, sc in jh["scores"].items():
        sc = np.asarray(sc)
        np.testing.assert_allclose(tstate["helios"]["scores"][k].numpy(), sc,
                                   rtol=0, atol=ATOL * max(1.0, sc.max()),
                                   err_msg=k)
    fracs = [float(m.mean()) for m in tstate["helios"]["masks"].values()]
    assert min(fracs) < 1.0


def test_first_step_moves_nothing_but_the_moments():
    """The warmup schedule's lr is 0 at step 0: the first step leaves the
    params as they were and fills AdamW's moments."""
    jcfg, tcfg = _cfgs("deepseek-7b")
    ht = TC.HeliosConfig(enabled=True, contribution="grad_ema")
    tc_t = TC.TrainConfig(**TCFG_RUN)
    _, tstate = _states(jcfg, tcfg, JC.HeliosConfig(), ht,
                        JC.TrainConfig(**TCFG_RUN), tc_t)
    step = S.make_train_step(tcfg, ht, tc_t, default_runtime())
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(tcfg, np.random.default_rng(0), 2, 16).items()}
    new, _ = step(tstate, batch)
    for (k, a), (_, b) in zip(tree_paths(new["params"]),
                              tree_paths(tstate["params"])):
        assert torch.equal(a, b), k
    assert any(bool(v.any()) for _, v in tree_paths(new["opt"]["m"]))


def test_microbatches_match_jax():
    jstate, tstate, metrics, _ = _run_steps("deepseek-7b", microbatches=2,
                                            n_steps=2, b=4)
    for jm, tm in metrics:
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
    _assert_tree_close(tstate["params"], jstate["params"], what="mb2")


def test_bf16_compute_under_kernels_raises():
    tcfg = TC.reduced(TC.DEEPSEEK_7B)
    rt = default_runtime()
    rt["kernels"] = "cuda"
    with pytest.raises(ValueError, match="flash_attention"):
        S.make_train_step(tcfg, TC.HeliosConfig(), TC.TrainConfig(
            compute_dtype="bfloat16"), rt)


# ---------------------------------------------------------------------------
# the fused FL round
# ---------------------------------------------------------------------------


#: the reference test's round schedule (tests/test_fl_round.py)
FL_RUN = dict(learning_rate=1e-2, total_steps=10, warmup_steps=0)


def _fl_states(jcfg, tcfg, hj, ht, tc_j, tc_t, n):
    """The same stacked round state in both packages: JAX params bridged,
    client c's Eq. 2 masks drawn at volume (0.5, 1.0)[c] through the JAX
    key path."""
    jp = _jax_params(jcfg)
    base = jS.init_train_state(jax.random.PRNGKey(0), jcfg, hj, tc_j)
    schema_j = jAPI.build(jcfg).mask_schema
    jh = [jST.begin_cycle(jST.set_volume(jST.init_state(schema_j, 1.0, c),
                                         v), hj)
          for c, v in enumerate((0.5, 1.0))]
    jstate = {"params": jax.tree.map(lambda t: jnp.stack([t] * n), jp),
              "opt": jax.tree.map(lambda t: jnp.stack([t] * n), base["opt"]),
              "step": base["step"],
              "helios": jax.tree.map(lambda *t: jnp.stack(t), *jh)}
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    with jax_keys():
        th = [ST.begin_cycle(ST.set_volume(ST.init_state(
            build(tcfg).mask_schema, 1.0, c, "cpu"), v), ht)
            for c, v in enumerate((0.5, 1.0))]
    tstate = {"params": S.stack_clients(tp, n),
              "opt": S.stack_clients(S.make_opt(tcfg, tc_t).init(tp), n),
              "step": torch.zeros((), dtype=torch.int32),
              "helios": ST.stack_states(th)}
    return jstate, tstate


@pytest.mark.parametrize("arch,optimizer,helios", [
    (arch, optimizer, helios) for arch in ("deepseek-7b", "xlstm-125m")
    for optimizer in ("momentum", "adamw") for helios in (True, False)
    if helios or arch == "deepseek-7b"])
def test_fl_round_matches_jax(arch, optimizer, helios):
    jcfg, tcfg = _cfgs(arch)
    hj = JC.HeliosConfig(enabled=helios)
    ht = TC.HeliosConfig(enabled=helios)
    kw = dict(FL_RUN if optimizer == "momentum" else TCFG_RUN,
              optimizer=optimizer)
    tc_j, tc_t = JC.TrainConfig(**kw), TC.TrainConfig(**kw)
    n, local, rounds = 2, 2, 2
    # the sLSTM input-gate bias moves on rounding noise: within the lr
    # summed over the local steps of every round
    sched = warmup_cosine_schedule(tc_t.learning_rate, tc_t.warmup_steps,
                                   tc_t.total_steps)
    lr_sum = local * sum(float(sched(r)) for r in range(rounds))
    exempt = {f"blocks/b{i}/cell/bi": lr_sum for i in tcfg.slstm_layers}
    jstate, tstate = _fl_states(jcfg, tcfg, hj, ht, tc_j, tc_t, n)
    batch = _batch(jcfg, np.random.default_rng(1), 2, 32, lead=(n, local))
    jstep = jax.jit(jS.make_fl_round_step(jcfg, hj, tc_j,
                                          jAPI.default_runtime(jcfg), n))
    rt = default_runtime()
    rt["kernels"] = "cuda"
    tstep = S.make_fl_round_step(tcfg, ht, tc_t, rt, n)
    for _ in range(rounds):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm = tstep(tstate, {"tokens": torch.as_tensor(
            batch["tokens"])})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
        np.testing.assert_allclose(tm["alpha"].numpy(),
                                   np.asarray(jm["alpha"]), rtol=1e-7)
    if not helios:
        np.testing.assert_array_equal(tm["alpha"].numpy(), [0.5, 0.5])
    else:
        assert float(tm["alpha"][0]) < 0.5
    _assert_tree_close(tstate["params"], jstate["params"], what="fl params",
                       exempt=exempt)
    _assert_tree_close(tstate["opt"], jstate["opt"], what="fl opt")
    for _, leaf in tree_paths(tstate["params"]):      # every client: global
        assert torch.equal(leaf[0], leaf[1])
    assert int(tstate["step"]) == rounds


def test_adamw_round_at_lr_1e_2_parts_jax_from_itself():
    """At the reference test's lr 1e-2 and warmup 0, AdamW's first steps
    move every coordinate by about the lr, and a coordinate whose gradient
    cancels to ~1e-8 by a share of it set by rounding: two JAX runs whose
    params differ by one ulp (a 2^-23 relative nudge) part by more than
    1e-5, while the same runs under momentum stay within 1e-6."""
    jcfg, tcfg = _cfgs("deepseek-7b")
    hj, ht = JC.HeliosConfig(), TC.HeliosConfig()
    n = 2
    batch = {"tokens": jnp.asarray(_batch(jcfg, np.random.default_rng(1), 2,
                                          32, lead=(n, 2))["tokens"])}
    gap = {}
    for optimizer in ("adamw", "momentum"):
        tc_j = JC.TrainConfig(optimizer=optimizer, **FL_RUN)
        jstate, _ = _fl_states(jcfg, tcfg, hj, ht, tc_j,
                               TC.TrainConfig(optimizer=optimizer, **FL_RUN),
                               n)
        twin = {**jstate, "params": jax.tree.map(
            lambda t: t * (1.0 + 2.0 ** -23), jstate["params"])}
        step = jax.jit(jS.make_fl_round_step(
            jcfg, hj, tc_j, jAPI.default_runtime(jcfg), n))
        for _ in range(2):
            jstate, _ = step(jstate, batch)
            twin, _ = step(twin, batch)
        gap[optimizer] = max(
            float(jnp.abs(a - b).max()) for a, b in zip(
                jax.tree.leaves(jstate["params"]),
                jax.tree.leaves(twin["params"])))
    assert gap["adamw"] > ATOL, gap
    assert gap["momentum"] < 1e-6, gap


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "xlstm-125m", "--reduced", "--batch", "8", "--seq", "64",
       "--lr", "3e-3", "--volume", "0.75", "--ckpt-every", "7",
       "--log-every", "100", "--device", "cpu", "--cycle-steps", "5"]


def test_train_cli_improves_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    losses = TR.main(CLI + ["--steps", "14", "--ckpt-dir", ckpt])
    assert len(losses) == 14
    assert "(improved)" in capsys.readouterr().out
    # restart: picks up at step 14 (checkpointed at the end) and continues
    losses2 = TR.main(CLI + ["--steps", "16", "--ckpt-dir", ckpt])
    assert len(losses2) == 2
    assert "resumed from step 14" in capsys.readouterr().out


def test_resumed_run_equals_uninterrupted(tmp_path):
    """A run restarted from its step-7 checkpoint ends where the run that
    never stopped ends, bit for bit: the checkpoint carries AdamW's moments,
    the step, the Helios state with its key path and the batch generator."""
    a, b = tmp_path / "a", tmp_path / "b"
    ra, rb = {}, {}
    TR.main(CLI + ["--steps", "14", "--ckpt-dir", str(a)], report=ra)
    b.mkdir()
    shutil.copy(a / "ckpt_7.msgpack.zst", b / "ckpt_7.msgpack.zst")
    TR.main(CLI + ["--steps", "14", "--ckpt-dir", str(b)], report=rb)
    assert rb["start"] == 7 and ra["start"] == 0
    sa, sb = ra["state"], rb["state"]
    for (k, x), (_, y) in zip(tree_paths(TR._saved(sa)),
                              tree_paths(TR._saved(sb))):
        if torch.is_tensor(x):
            assert torch.equal(x, y), k
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), k
    assert sa["helios"]["rng"] == sb["helios"]["rng"]
    meta = CKPT.metadata(str(a), 14)
    assert meta["helios_rng"] == [list(p) for p in sa["helios"]["rng"].path]


def test_train_cli_vlm_keeps_the_reference_batch(tmp_path):
    """At --seq below the image prefix (reduced: 8 image tokens) the text
    slice ends before the end: seq - n_img columns (1 at --seq 9)."""
    cfg = TC.reduced(TC.INTERNVL2_1B)
    data = np.arange(4 * 10).reshape(4, 10)
    b = TR.make_batch(cfg, data, np.random.default_rng(0), 2, 9, "cpu")
    assert tuple(b["tokens"].shape) == (2, 1)
    assert tuple(b["image_embeds"].shape) == (2, 8, 64)
    losses = TR.main(["--arch", "internvl2-1b", "--reduced", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--log-every", "100"])
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_train_cli_runs_as_module_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-7b", "--reduced", "--steps", "2", "--batch", "2", "--seq",
         "16", "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "kernels=reference device=cpu" in out.stdout


# ---------------------------------------------------------------------------
# Helios masks, the VLM's serving path
# ---------------------------------------------------------------------------


def test_helios_volume_reduces_masked_fraction():
    """volume < 1: the train state's Helios masks are partial, and equal to
    JAX's."""
    jcfg, tcfg = _cfgs("deepseek-7b")
    hj = JC.HeliosConfig(enabled=True, contribution="grad_ema")
    ht = TC.HeliosConfig(enabled=True, contribution="grad_ema")
    jstate, tstate = _states(jcfg, tcfg, hj, ht, JC.TrainConfig(),
                             TC.TrainConfig())
    fracs = [float(m.mean()) for m in tstate["helios"]["masks"].values()]
    assert all(0.3 < f < 0.7 for f in fracs), fracs
    for k, m in jstate["helios"]["masks"].items():
        np.testing.assert_array_equal(tstate["helios"]["masks"][k].numpy(),
                                      np.asarray(m))


def test_vlm_prefill_decode_match_jax():
    jcfg, tcfg = _cfgs("internvl2-1b")
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(3)
    b, p, g = 2, 6, 4
    seq = rng.integers(0, 256, (b, p + g)).astype(np.int32)
    img = rng.standard_normal((b, 8, 64)).astype(np.float32)
    jrt, trt = jAPI.default_runtime(jcfg), default_runtime()
    masks = {k: (rng.random(s) < 0.7).astype(np.float32)
             for k, s in build(tcfg).mask_schema.items()}
    jm = {k: jnp.asarray(v) for k, v in masks.items()}
    tm = {k: torch.as_tensor(v) for k, v in masks.items()}
    from repro.models import transformer as jT
    jlog, jcache = jT.lm_prefill(jp, {"tokens": jnp.asarray(seq[:, :p]),
                                      "image_embeds": jnp.asarray(img)},
                                 jcfg, jrt, jm)
    with torch.no_grad():
        tlog, tcache = tT.lm_prefill(tp, {"tokens": torch.as_tensor(seq[:, :p]),
                                          "image_embeds": torch.as_tensor(img)},
                                     tcfg, trt, tm)
    assert tcache["pos"] == int(jcache["pos"]) == 8 + p
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=ATOL)
    length = 8 + p + g

    def pad(path, v):
        if jax.tree_util.keystr(path)[-5:] in ("['k']", "['v']"):
            return jnp.pad(v, [(0, 0)] * (v.ndim - 3)
                           + [(0, length - v.shape[-3]), (0, 0), (0, 0)])
        return v
    jcache = jax.tree_util.tree_map_with_path(pad, jcache)
    tcache = SV.pad_cache(tcache, length)
    with torch.no_grad():
        for i in range(p, p + g):
            tok = seq[:, i:i + 1]
            jlog, jcache = jT.lm_decode(jp, jnp.asarray(tok), jcache, jcfg,
                                        jrt, jm)
            tlog, tcache = tT.lm_decode(tp, torch.as_tensor(tok), tcache,
                                        tcfg, trt, tm)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=ATOL, err_msg=str(i))
        # the last step against one prefill over the same sequence
        full, _ = tT.lm_prefill(tp, {"tokens": torch.as_tensor(seq),
                                     "image_embeds": torch.as_tensor(img)},
                                tcfg, trt, tm)
    np.testing.assert_allclose(tlog.numpy(), full.numpy(), rtol=0, atol=1e-4)


def test_prefill_and_serve_steps_match_jax():
    """``make_prefill_step`` / ``make_serve_step`` (no masks) on reduced
    xlstm-125m against the reference's, three decode steps."""
    jcfg, tcfg = _cfgs("xlstm-125m")
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    seq = np.random.default_rng(9).integers(0, 256, (2, 11)).astype(np.int32)
    jrt, trt = jAPI.default_runtime(jcfg), default_runtime()
    jlog, jc = jS.make_prefill_step(jcfg, jrt)(
        jp, {"tokens": jnp.asarray(seq[:, :8])})
    with torch.no_grad():
        tlog, tc = S.make_prefill_step(tcfg, trt)(
            tp, {"tokens": torch.as_tensor(seq[:, :8])})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL)
        jserve, tserve = jS.make_serve_step(jcfg, jrt), \
            S.make_serve_step(tcfg, trt)
        for i in range(8, 11):
            jlog, jc = jserve(jp, jnp.asarray(seq[:, i:i + 1]), jc)
            tlog, tc = tserve(tp, torch.as_tensor(seq[:, i:i + 1]), tc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=ATOL, err_msg=str(i))
    assert tc["pos"] == int(jc["pos"]) == 11


def test_vlm_loss_scores_text_only():
    """The image prefix carries no loss: changing the logits' targets there
    is impossible, and a batch of one text token scores nothing."""
    jcfg, tcfg = _cfgs("internvl2-1b")
    tp = params_from_numpy(jax.device_get(_jax_params(jcfg)), device="cpu")
    rng = np.random.default_rng(4)
    img = torch.as_tensor(rng.standard_normal((2, 8, 64)).astype(np.float32))
    one = {"tokens": torch.as_tensor(rng.integers(0, 256, (2, 1))),
           "image_embeds": img}
    assert float(tT.lm_loss(tp, one, tcfg, default_runtime())) == 0.0
    two = {"tokens": torch.as_tensor(rng.integers(0, 256, (2, 5))),
           "image_embeds": img}
    jl = jAPI.build(jcfg).loss_fn(
        jax.device_get(_jax_params(jcfg)),
        {k: jnp.asarray(v.numpy()) for k, v in two.items()}, jcfg,
        jAPI.default_runtime(jcfg), None)
    assert abs(float(tT.lm_loss(tp, two, tcfg, default_runtime()))
               - float(jl)) <= ATOL


@pytest.mark.parametrize("arch", ["internvl2-1b", "xlstm-125m"])
def test_generation_server_serves_vlm_and_xlstm(arch):
    """The served batch carries the VLM's image prefix; greedy tokens equal
    a step-by-step decode's, and the CLI's default arch is xlstm-125m."""
    tcfg = TC.reduced(TC.ARCHS[arch])
    tp = params_from_numpy(jax.device_get(_jax_params(_cfgs(arch)[0])),
                           device="cpu")
    srv = SV.GenerationServer(tcfg, 2, 6, gen=3, device="cpu")
    prompts = np.random.default_rng(5).integers(0, 256, (2, 6))
    batch = SV.serve_batch(prompts, "cpu", tcfg, np.random.default_rng(6))
    assert ("image_embeds" in batch) == (tcfg.family == "vlm")
    toks = srv(tp, batch)
    logits, cache = srv.prefill(tp, batch)
    cache = SV.pad_cache(cache, cache["pos"] + 3)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    want = [tok]
    for _ in range(2):
        logits, cache = srv.decode(tp, tok, cache)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        want.append(tok)
    assert torch.equal(toks, torch.cat(want, 1))
    toks_cli = SV.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                        "--gen", "2", "--device", "cpu"])
    assert tuple(toks_cli.shape) == (1, 2)


def test_slstm_input_bias_gradient_is_rounding_noise():
    """The finding behind the noise floor: the sLSTM's stabilized gating is
    invariant to one shift of the input gate over all time steps, so the
    input-gate bias ``bi`` has a zero gradient but for rounding, in both
    packages, where every other leaf's is 1e-4 or more of its size."""
    jcfg, tcfg = _cfgs("xlstm-125m")
    tp = params_from_numpy(jax.device_get(_jax_params(jcfg)), device="cpu")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(
        0, 256, (2, 24)))}
    rt = default_runtime()
    loss, grads = S._loss_and_grads(
        lambda p, b, m: build(tcfg).loss_fn(p, b, tcfg, rt, m), tp, batch,
        None)
    bi = grads["blocks/b1/cell/bi"]
    assert float(bi.abs().max()) < 1e-8
    assert float(grads["blocks/b1/cell/bf"].abs().max()) > 1e-4
    with torch.no_grad():
        tp["blocks"]["b1"]["cell"]["bi"] += 0.5
        shifted = build(tcfg).loss_fn(tp, batch, tcfg, rt, None)
    assert abs(float(shifted) - float(loss)) < 1e-5


def test_vlm_has_no_fl_adapter():
    """As in the reference, the VLM trains through the launch only."""
    from repro_torch.federated.adapter import make_adapter
    cfg = TC.reduced(TC.INTERNVL2_1B)
    with pytest.raises(NotImplementedError, match="supported families"):
        make_adapter(cfg, "cuda", 16, torch.device("cpu"))
