"""Port parity for the LM slice as a whole: ``FLRun.run_sync`` of the port
on the dense LM against the JAX package's ``FLRun.run_sync``.

The setting of tests/test_kernel_softtrain.py's LM wall: reduced
deepseek-7b, 240 Markov-topic token streams of 32 over a 64-token
alphabet, split by topic over a 2 capable + 2 Table-I straggler fleet,
``HeliosConfig(mask_block=16)`` (the d_ff of 96 pools into 6 blocks; the 4
heads stay unit-granular), 2 local steps of batch 4, lr 0.05, two rounds of
helios and of syn.  Both sides start from the JAX run's initial params
(through the weight bridge), and the port draws its Eq. 2 numbers through
the JAX key-path backend.  The JAX side runs ``kernels="reference"``
(pinned to its Pallas path at 1e-5 by the reference's own wall); the port
runs ``kernels="cuda"``, whose autograd structure runs its plain bodies on
the CPU.

Expected: identical cycle/time/volumes/ratios history, cross-entropy and
loss within 1e-5, identical straggler masks, params within atol 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ATOL = 1e-5
SCHEMES = ("helios", "syn")
RUN_KW = dict(local_steps=2, batch_size=4, lr=0.05, seed=0, eval_batch=48)


@pytest.fixture(scope="module")
def setting():
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    return {"tokens": tokens}, {"tokens": test_tokens}, parts


@pytest.fixture(scope="module")
def runs(setting):
    train, test, parts = setting
    jcfg = JC.reduced(JC.ARCHS["deepseek-7b"])
    tcfg = TC.reduced(TC.DEEPSEEK_7B)
    jh, th = JC.HeliosConfig(mask_block=16), TC.HeliosConfig(mask_block=16)
    tK.reset_launches()
    tFA.reset_launches()
    out = {}
    for scheme in SCHEMES:
        jrun = JaxFLRun(jcfg, jh, scheme,
                        j_setup_clients(j_make_fleet(2, 2), parts, jh),
                        train, test, kernels="reference", **RUN_KW)
        init = jax.device_get(jrun.global_params)
        jrun.run_sync(2)
        with jax_keys():
            trun = FLRun(tcfg, th, scheme,
                         setup_clients(make_fleet(2, 2), parts, th,
                                       device="cpu"),
                         train, test, kernels="cuda", device="cpu",
                         init_params=init, **RUN_KW)
            trun.run_sync(2)
        out[scheme] = jrun, trun
    return out


def test_data_matches_jax(setting):
    from repro.data.federated import partition_by_topic as j_part
    from repro.data.synthetic import markov_topic_tokens as j_tokens
    train, _, parts = setting
    tokens, topics = j_tokens(240, 32, 64, n_topics=8, seed=0)
    np.testing.assert_array_equal(train["tokens"], tokens)
    for a, b in zip(parts, j_part(topics, 4, topics_per_client=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_history_and_params_match_jax(runs, scheme):
    jrun, trun = runs[scheme]
    assert len(trun.history) == len(jrun.history) == 2
    for j, t in zip(jrun.history, trun.history):
        for k in ("scheme", "cycle", "time", "volumes", "ratios",
                  "downlink_mb"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["ce"] - j["ce"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    tparams = dict(tree_paths(trun.global_params))
    jparams = dict(tree_paths(jax.device_get(jrun.global_params)))
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_straggler_masks_identical(runs, scheme):
    jrun, trun = runs[scheme]
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
            np.testing.assert_array_equal(
                tc.helios_state["skip_counts"][k].numpy(),
                np.asarray(jc.helios_state["skip_counts"][k]), err_msg=k)


def test_helios_straggler_ratios_block_quantized(runs):
    """Soft-training stragglers train a sub-model (ratio < 1) whose MLP
    masks are block-constant at 16 with a whole number of live blocks; no
    CUDA kernel launched on the CPU."""
    _, trun = runs["helios"]
    for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
        if not c.is_straggler:
            assert r == 1.0
            continue
        assert r < 1.0
        blocks = c.helios_state["masks"]["mlp"].numpy().reshape(4, -1, 16)
        assert np.all(blocks.max(-1) == blocks.min(-1))
        assert np.all(0 < blocks[:, :, 0].sum(-1))
        assert np.all(blocks[:, :, 0].sum(-1) < 96 // 16)
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}
    assert tFA.LAUNCHES == {"flash_attention": 0}


def test_make_adapter_dispatch():
    from repro_torch.federated.adapter import (CNNAdapter, TokenLMAdapter,
                                               make_adapter)
    dev = torch.device("cpu")
    lm = make_adapter(TC.reduced(TC.DEEPSEEK_7B), "cuda", 16, dev)
    assert isinstance(lm, TokenLMAdapter) and lm.metric_name == "ce"
    assert lm.rt["kernels"] == "cuda" and lm.eval_rt["kernels"] == "reference"
    assert isinstance(make_adapter(TC.reduced(TC.ALEXNET), "cuda", 16, dev),
                      CNNAdapter)
    vlm = TC.ModelConfig(name="vlm", family="vlm")
    with pytest.raises(NotImplementedError, match="supported families"):
        make_adapter(vlm, "cuda", 16, dev)


def test_lm_entry_points_refuse_without_gpu(setting, monkeypatch):
    """No GPU and no explicit CPU request: the LM's entry points raise
    instead of quietly running on the CPU."""
    from repro_torch.models import init_params, make_full_masks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test, _ = setting
    cfg, h = TC.reduced(TC.DEEPSEEK_7B), TC.HeliosConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_full_masks(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLRun(cfg, h, "helios", [], train, test)


def test_lm_modules_import_with_jax_blocked():
    """The LM slice's modules import in a process where ``jax`` and the
    JAX package cannot be imported (test_torch_imports.py checks every
    port file's import statements)."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.kernels.flash_attention\n"
        "from repro_torch.configs import DEEPSEEK_7B, reduced\n"
        "from repro_torch.models import build, layers, transformer\n"
        "from repro_torch.federated.adapter import make_adapter\n"
        "from repro_torch.data.synthetic import markov_topic_tokens\n"
        "from repro_torch.data.federated import partition_by_topic\n"
        "assert build(reduced(DEEPSEEK_7B)).mask_schema\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
