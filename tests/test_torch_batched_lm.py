"""Port parity for the batched and bucketed round engines on the dense LM
and the Mamba2 hybrid: ``BatchedFLRun`` / ``AsyncFLRun`` of the port on
``reduced(deepseek-7b)`` and ``reduced(zamba2-1.2b)`` against the JAX
package's, the vmap rules of the flash attention and ``ssd_diag`` Functions
they stand on, and ``repro_torch.drivers.federated_lm`` against
``examples/federated_lm.py``.

* The Functions under ``torch.func.vmap`` over a client axis (the batched
  engines fold it into the kernels' batch axis, one launch a cohort), with
  batched and shared operands: forward against a loop over clients and
  against ``jax.vmap`` of the Pallas kernels in interpret mode (atol 1e-5);
  ``vmap(grad)`` against the loop's plain autograd and ``jax.vmap(jax.grad)``
  (1e-4; the reference's ``ssd_diag`` has no VJP, so its oracle's).
* ``run_sync(2)`` of helios, syn, st_only and ``masked_mean`` helios on the
  dense LM, helios and syn on the hybrid, and ``run_async(6)`` of asyn on
  both, on the 2 capable + 2 Table-I straggler fleet of the sequential
  walls (``tests/test_torch_lm_slice.py``, ``test_torch_hybrid_slice.py``:
  240 Markov-topic streams of 32, or of 64 for the hybrid's two SSD
  chunks, ``mask_block=16``, 2 local steps of batch 4, lr 0.05).  Both
  sides start from the JAX run's initial params and the port draws its
  Eq. 2 numbers through the JAX key backend.  The JAX side runs
  ``kernels="reference"`` (held to its Pallas path by the reference's own
  walls), the port ``kernels="cuda"``, whose vmap rules run their plain
  bodies on the CPU.  Expected: identical cycle / time / volumes / ratios
  history, ``events_processed`` and bucket sizes, CE and loss within
  1e-5, identical straggler masks, params within atol 1e-5.
* The federated_lm driver's printed table equal to the example's, both
  on the batched engine at 2 rounds, and each scheme's CE trajectory
  within 1e-4 of the example's runs (4 local steps at lr 0.5 a round).
"""
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.federated import AsyncFLRun as JaxAsyncFLRun  # noqa: E402
from repro.federated import BatchedFLRun as JaxBatchedFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.drivers.federated_lm import federated_lm  # noqa: E402
from repro_torch.federated import (AsyncFLRun, BatchedFLRun,  # noqa: E402
                                   make_fleet, setup_clients)
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tSS  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
GRAD_TOL = 1e-4
#: the federated_lm driver's CE against the example's (4 local steps at
#: lr 0.5)
CE_TOL = 1e-4
RUN_KW = dict(local_steps=2, batch_size=4, lr=0.05, seed=0, eval_batch=48)
#: arch -> (JAX config, port config, token stream length); the MoE and
#: xLSTM cases run in tests/test_torch_batched_moe.py and
#: test_torch_batched_xlstm.py
ARCHS = {"deepseek": (JC.reduced(JC.ARCHS["deepseek-7b"]),
                      TC.reduced(TC.DEEPSEEK_7B), 32),
         "zamba2": (JC.reduced(JC.ARCHS["zamba2-1.2b"]),
                    TC.reduced(TC.ZAMBA2_1_2B), 64),
         "granite": (JC.reduced(JC.ARCHS["granite-moe-1b-a400m"]),
                     TC.reduced(TC.GRANITE_MOE_1B_A400M), 32),
         "xlstm": (JC.reduced(JC.ARCHS["xlstm-125m"]),
                   TC.reduced(TC.XLSTM_125M), 32)}
#: case -> (arch, scheme, HeliosConfig overrides)
#: (the hybrid's cases run in tests/test_torch_batched_hybrid.py, so two
#: test workers share the JAX side's compiles)
SYNC = {"deepseek-helios": ("deepseek", "helios", {}),
        "deepseek-syn": ("deepseek", "syn", {}),
        "deepseek-st_only": ("deepseek", "st_only", {}),
        "deepseek-masked_mean": ("deepseek", "helios",
                                 {"aggregation": "masked_mean"})}
CYCLES = 6


# ---------------------------------------------------------------------------
# the kernel Functions under torch.func.vmap
# ---------------------------------------------------------------------------

C = 3
#: (C, B, H, S, hd): a ragged causal length
FLASH = (C, 2, 2, 40, 16)
#: (C, b, nc, L, ds, nh, hd): two chunks of 32
SSD = (C, 1, 2, 32, 16, 2, 16)
#: operands each client shares (in_dims None): none, k and v / br and cum
FLASH_SHARED = {"batched": (), "shared_kv": (1, 2)}
SSD_SHARED = {"batched": (), "shared_br_cum": (1, 2)}


def _flash_inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=FLASH).astype(np.float32) for _ in range(3)]


def _ssd_inputs():
    c, b, nc, L, ds, nh, hd = SSD
    rng = np.random.default_rng(1)
    cr = rng.normal(size=(c, b, nc, L, ds)).astype(np.float32)
    br = rng.normal(size=(c, b, nc, L, ds)).astype(np.float32)
    a = -np.abs(rng.normal(size=(c, b, nc, L, nh))).astype(np.float32) * 0.1
    cum = np.cumsum(a, axis=3).astype(np.float32)
    dtx = rng.normal(size=(c, b, nc, L, nh, hd)).astype(np.float32)
    return [cr, br, cum, dtx]


def _vmapped(op, ref_op, jop, jref_op, ins, shared):
    """Forward and vmap(grad(sum(y · gy))) of the port's op over the client
    axis (``shared`` operands taken from client 0 with in_dims None; gy a
    fixed N(0, 1) cotangent a client), against a loop over clients of its
    plain version, ``jax.vmap`` of ``jop`` (forward) and
    ``jax.vmap(jax.grad)`` of ``jref_op``."""
    dims = tuple(None if i in shared else 0 for i in range(len(ins)))
    ins = [x[0] if d is None else x for x, d in zip(ins, dims)]
    gy = np.random.default_rng(2).normal(
        size=(C,) + ins[-1].shape[1:] if dims[-1] == 0 else
        (C,) + ins[-1].shape).astype(np.float32)
    tins = [torch.tensor(x) for x in ins]
    tgy = torch.tensor(gy)
    argnums = tuple(range(len(ins)))
    tFA.reset_launches()
    tSS.reset_launches()
    y = torch.func.vmap(op, in_dims=dims)(*tins).numpy()
    g = torch.func.vmap(torch.func.grad(
        lambda *a: (op(*a[:-1]) * a[-1]).sum(), argnums=argnums),
        in_dims=dims + (0,))(*tins, tgy)
    assert tFA.LAUNCHES == {"flash_attention": 0}   # no kernel on the CPU
    assert tSS.LAUNCHES == {"ssd_diag": 0}

    def client(c):
        return [t if d is None else t[c] for t, d in zip(tins, dims)]

    loop_y = np.stack([ref_op(*client(c)).numpy() for c in range(C)])
    loop_g = [torch.func.grad(lambda *a: (ref_op(*a) * tgy[c]).sum(),
                              argnums=argnums)(*client(c)) for c in range(C)]
    jins = [jnp.asarray(x) for x in ins]
    jy = np.asarray(jax.vmap(jop, in_axes=dims)(*jins))
    jg = jax.vmap(jax.grad(lambda *a: jnp.sum(jref_op(*a[:-1]) * a[-1]),
                           argnums=argnums),
                  in_axes=dims + (0,))(*jins, jnp.asarray(gy))
    np.testing.assert_allclose(y, loop_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL)
    for i, (t, j) in enumerate(zip(g, jg)):
        want = torch.stack([lg[i] for lg in loop_g]).numpy()
        # vmap(grad) gives each client's gradient, of a shared operand too
        assert t.shape == (C,) + ins[i].shape[1 if dims[i] == 0 else 0:]
        np.testing.assert_allclose(t.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"operand {i}")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"operand {i}")


@pytest.mark.parametrize("shared", FLASH_SHARED)
def test_flash_attention_under_vmap(shared):
    _vmapped(lambda q, k, v: tops.flash_attention(q, k, v, impl="cuda"),
             lambda q, k, v: tref.flash_attention_ref(q, k, v, True),
             lambda q, k, v: jops.flash_attention(q, k, v, causal=True),
             lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=True),
             _flash_inputs(), FLASH_SHARED[shared])


@pytest.mark.parametrize("shared", SSD_SHARED)
def test_ssd_diag_under_vmap(shared):
    _vmapped(lambda *a: tops.ssd_diag(*a, impl="cuda"), tref.ssd_diag_ref,
             jops.ssd_diag, jref.ssd_diag_ref, _ssd_inputs(),
             SSD_SHARED[shared])


def test_vmap_rule_folds_clients_into_one_call(monkeypatch):
    """Under vmap each Function calls its kernel wrapper once, on the
    cohort folded into the batch axis, whatever the number of clients."""
    calls = []
    real_fa, real_ss = tFA.flash_attention, tSS.ssd_diag

    def fa(q, k, v, causal=True):
        calls.append(("flash", tuple(q.shape)))
        return real_fa(q, k, v, causal)

    def ss(*a):
        calls.append(("ssd", tuple(a[3].shape)))
        return real_ss(*a)

    monkeypatch.setattr(tFA, "flash_attention", fa)
    monkeypatch.setattr(tSS, "ssd_diag", ss)
    q, k, v = (torch.tensor(x) for x in _flash_inputs())
    torch.func.vmap(lambda q, k, v: tops.flash_attention(q, k, v),
                    in_dims=(0, None, None))(q, k[0], v[0])
    cr, br, cum, dtx = (torch.tensor(x) for x in _ssd_inputs())
    torch.func.vmap(lambda *a: tops.ssd_diag(*a))(cr, br, cum, dtx)
    c, b, h, s, hd = FLASH
    _, sb, nc, L, _, nh, shd = SSD
    assert calls == [("flash", (c * b, h, s, hd)),
                     ("ssd", (C * sb, nc, L, nh, shd))]


# ---------------------------------------------------------------------------
# the engines against the JAX package's
# ---------------------------------------------------------------------------


def _setting(seq):
    tokens, topics = markov_topic_tokens(240, seq, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, seq, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    return {"tokens": tokens}, {"tokens": test_tokens}, parts


def _pair(jcls, tcls, arch, scheme, hkw):
    """The JAX engine and the port's on the same fleet and initial params
    (the port built and run by the caller under the JAX key backend)."""
    jcfg, tcfg, seq = ARCHS[arch]
    train, test, parts = _setting(seq)
    jh = JC.HeliosConfig(mask_block=16, **hkw)
    th = TC.HeliosConfig(mask_block=16, **hkw)
    jrun = jcls(jcfg, jh, scheme,
                j_setup_clients(j_make_fleet(2, 2), parts, jh), train, test,
                kernels="reference", **RUN_KW)
    trun = tcls(tcfg, th, scheme,
                setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                train, test, kernels="cuda", device="cpu",
                init_params=jax.device_get(jrun.global_params), **RUN_KW)
    return jrun, trun


def _assert_params(jrun, trun):
    tparams = dict(tree_paths(trun.global_params))
    jparams = dict(tree_paths(jax.device_get(jrun.global_params)))
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=k)


def _assert_same(jrun, trun, keys):
    assert len(trun.history) == len(jrun.history) > 0
    for j, t in zip(jrun.history, trun.history):
        assert set(t) == set(j)
        for k in ("scheme", "downlink_mb") + keys:
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["ce"] - j["ce"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    _assert_params(jrun, trun)
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)


def check_run_sync(arch, scheme, hkw):
    """BatchedFLRun run_sync(2) of the port against JAX's."""
    tK.reset_launches()
    tFA.reset_launches()
    tSS.reset_launches()
    with jax_keys():
        jrun, trun = _pair(JaxBatchedFLRun, BatchedFLRun, arch, scheme, hkw)
        jrun.run_sync(2)
        trun.run_sync(2)
    _assert_same(jrun, trun, ("cycle", "time", "volumes", "ratios"))
    if scheme == "helios":
        assert min(trun.history[-1]["ratios"]) < 1.0      # a sub-model
    # the kernel path on the CPU: no kernel launched
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}
    assert tFA.LAUNCHES == {"flash_attention": 0}
    assert tSS.LAUNCHES == {"ssd_diag": 0}


def check_run_async(arch):
    """AsyncFLRun asyn run_async(6) of the port against JAX's."""
    with jax_keys():
        jrun, trun = _pair(JaxAsyncFLRun, AsyncFLRun, arch, "asyn", {})
        jrun.run_async(CYCLES)
        trun.run_async(CYCLES)
    assert trun.events_processed == jrun.events_processed > CYCLES
    assert trun.bucket_sizes == jrun.bucket_sizes
    _assert_same(jrun, trun, ("cycle", "time", "record_cadence", "bucket"))


@pytest.mark.parametrize("case", SYNC)
def test_batched_run_sync_matches_jax(case):
    check_run_sync(*SYNC[case])


def test_bucket_engine_asyn_matches_jax():
    check_run_async("deepseek")


# ---------------------------------------------------------------------------
# repro_torch.drivers.federated_lm against examples/federated_lm.py
# ---------------------------------------------------------------------------

ROW = re.compile(r"^(\w+)\s*\| CE (.*) \| sim time\s+([\d.]+) "
                 r"\| time/cycle ([\d.]+)$", re.M)


def test_driver_matches_the_example(capsys, monkeypatch):
    """Both on the batched engine at 2 rounds: the same printed rows for
    syn, st_only and helios, and each scheme's CE trajectory within 1e-4
    of the example's runs (kept by a recording subclass)."""
    import repro.federated as jfed
    jruns = []

    class Recorded(JaxBatchedFLRun):
        def __post_init__(self):
            super().__post_init__()
            jruns.append(self)

    monkeypatch.setattr(jfed, "BatchedFLRun", Recorded)
    path = os.path.join(ROOT, "examples", "federated_lm.py")
    monkeypatch.setattr(sys, "argv",
                        [path, "--rounds", "2", "--engine", "batched"])
    capsys.readouterr()
    runpy.run_path(path, run_name="__main__")
    want = capsys.readouterr().out
    assert [r.scheme for r in jruns] == ["syn", "st_only", "helios"]
    # every run of the example starts from its engines' seed-0 params
    with jax_keys():
        got = federated_lm(rounds=2, engine="batched", device="cpu",
                           kernels="cuda",
                           init_params=jax.device_get(
                               j_init_params(jax.random.PRNGKey(0),
                                             jruns[0].cfg)))
    out = capsys.readouterr().out
    assert out.splitlines()[0] == want.splitlines()[0]
    assert [r[0] for r in ROW.findall(out)] == ["syn", "st_only", "helios"]
    assert ROW.findall(out) == ROW.findall(want)
    for jrun in jruns:
        hist = got[jrun.scheme]
        assert len(hist) == len(jrun.history) == 2
        for t, j in zip(hist, jrun.history):
            assert (t["cycle"], t["time"]) == (j["cycle"], j["time"])
            assert abs(t["ce"] - j["ce"]) <= CE_TOL, (t["ce"], j["ce"])
