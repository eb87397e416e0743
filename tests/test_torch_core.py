"""Port parity: the soft-training core (``repro_torch.core``), the optimizer
and the fleet setup against the JAX package.

Under the test-only JAX key-path backend (test_torch_keys.py) the port's
Eq. 2 masks are BIT-identical to the reference's, unit-granular and
block-granular, over several volumes; so are the cycle state machine's
masks, skip counters and key advances.  Eq. 1 scores, mask expansion,
Eq. 10 / masked-mean aggregation and momentum steps agree at atol 1e-6.
"""
import dataclasses
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
from repro.core import aggregation as jAG  # noqa: E402
from repro.core import contribution as jC  # noqa: E402
from repro.core import masking as jMK  # noqa: E402
from repro.core import selection as jS  # noqa: E402
from repro.core import soft_train as jST  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.optim import optimizers as jO  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import aggregation as tAG  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import keys as KY  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.core import selection as tS  # noqa: E402
from repro_torch.core import soft_train as tST  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.federated import make_fleet, setup_clients  # noqa: E402
from repro_torch.optim import optimizers as tO  # noqa: E402
from test_torch_keys import _jax_key, jax_keys  # noqa: E402

#: the reference functions, jitted (eager JAX compiles op by op)
j_select = jax.jit(jS.select_masks, static_argnames=("p_s", "block"))
j_begin = jax.jit(jST.begin_cycle, static_argnums=1)
j_end = jax.jit(jST.end_cycle, static_argnums=2)
j_aggregate = jax.jit(jAG.aggregate, static_argnums=0)

#: reduced-AlexNet unit types plus a multi-row type (rows draw separately)
SCHEMA = {"conv0": (1, 8), "conv1": (1, 24), "conv2": (1, 48),
          "conv3": (1, 32), "fc0": (1, 1024), "fc1": (1, 512),
          "mlp": (3, 40)}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _scores_forced(seed, forced_frac=0.1):
    rng = np.random.default_rng(seed)
    scores = {k: rng.random(s).astype(np.float32) for k, s in SCHEMA.items()}
    forced = {k: rng.random(s) < forced_frac for k, s in SCHEMA.items()}
    return scores, forced


@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("p_s", [0.1, 0.0])     # helios, random
def test_select_masks_bit_identical(block, p_s):
    scores, forced = _scores_forced(int(block + 10 * p_s))
    jscores = {k: jnp.asarray(v) for k, v in scores.items()}
    jforced = {k: jnp.asarray(v) for k, v in forced.items()}
    tscores = {k: torch.tensor(v) for k, v in scores.items()}
    tforced = {k: torch.tensor(v) for k, v in forced.items()}
    for i, volume in enumerate((0.125, 0.4, 0.75, 1.0)):
        key = KY.key(7).fold_in(i)
        want = j_select(jscores, jforced, jnp.asarray(volume, jnp.float32),
                        p_s=p_s, key=_jax_key(key.path), block=block)
        with jax_keys():
            got = tS.select_masks(tscores, tforced, volume, p_s, key,
                                  block=block)
        for k in SCHEMA:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} P={volume}")
        if block:                   # pooled layers are block-constant
            for k in ("fc0", "fc1"):
                b = _np(got[k]).reshape(1, -1, block)
                assert np.all(b.max(-1) == b.min(-1))


def test_selection_counts_and_forced():
    """clip(round(P·n), 1, n) ones per row; forced units always win when
    they fit the budget (default backend: no JAX involved)."""
    scores, _ = _scores_forced(3)
    forced = {k: np.zeros(s, bool) for k, s in SCHEMA.items()}
    forced["conv2"][0, :5] = True
    masks = tS.select_masks({k: torch.tensor(v) for k, v in scores.items()},
                            {k: torch.tensor(v) for k, v in forced.items()},
                            0.3, 0.1, KY.key(0))
    for k, (L, n) in SCHEMA.items():
        want = int(np.clip(np.round(np.float32(0.3) * n), 1, n))
        assert _np(masks[k]).sum(-1).tolist() == [want] * L
    assert np.all(_np(masks["conv2"])[0, :5] == 1)


def test_rotation_threshold_and_forced_units_match_jax():
    counts = {"a": np.arange(12, dtype=np.int32).reshape(1, 12)}
    for vol in (0.001, 0.125, 0.3, 0.5, 1.0):
        t = tS.rotation_threshold(vol)
        j = jS.rotation_threshold(jnp.asarray(vol, jnp.float32))
        assert t == float(j)
        np.testing.assert_array_equal(
            _np(tS.forced_units({"a": torch.tensor(counts["a"])}, t)["a"]),
            np.asarray(jS.forced_units({"a": jnp.asarray(counts["a"])},
                                       j)["a"]))
    assert tS.rotation_threshold(0.5, auto=False, fixed=4) == 4.0


def test_cycle_state_machine_matches_jax():
    """begin_cycle / end_cycle over three cycles: masks, C_s counters,
    scores, cycle counter and the key advance all agree bit for bit."""
    hcfg_t = TC.HeliosConfig(mask_block=128)
    hcfg_j = JC.HeliosConfig(mask_block=128)
    schema = {k: s for k, s in SCHEMA.items() if k != "mlp"}
    ts = tST.init_state(schema, volume=0.4, seed=5, device="cpu")
    js = jST.init_state(schema, volume=0.4, seed=5)
    rng = np.random.default_rng(0)
    for cycle in range(3):
        with jax_keys():
            ts = tST.begin_cycle(ts, hcfg_t)
        js = j_begin(js, hcfg_j)
        np.testing.assert_array_equal(np.asarray(_jax_key(ts["rng"].path)),
                                      np.asarray(js["rng"]))
        for k in schema:
            np.testing.assert_array_equal(_np(ts["masks"][k]),
                                          np.asarray(js["masks"][k]))
        new = {k: rng.random(s).astype(np.float32) for k, s in schema.items()}
        ts = tST.end_cycle(ts, {k: torch.tensor(v) for k, v in new.items()},
                           hcfg_t)
        js = j_end(js, {k: jnp.asarray(v) for k, v in new.items()}, hcfg_j)
        for k in schema:
            np.testing.assert_array_equal(_np(ts["skip_counts"][k]),
                                          np.asarray(js["skip_counts"][k]))
            np.testing.assert_array_equal(_np(ts["scores"][k]),
                                          np.asarray(js["scores"][k]))
        assert ts["cycle"] == int(js["cycle"]) == cycle + 1
        ts = tST.set_volume(ts, 0.4 - 0.1 * cycle)
        js = jST.set_volume(js, 0.4 - 0.1 * cycle)
    ema = dataclasses.replace(hcfg_t, contribution="grad_ema")
    out = tST.end_cycle(ts, {k: torch.ones(s) for k, s in schema.items()},
                        ema)
    np.testing.assert_allclose(_np(out["scores"]["fc1"]),
                               0.9 * _np(ts["scores"]["fc1"]) + 0.1,
                               rtol=1e-6)


def _params(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"conv0_w": (3, 3, 3, 8), "conv0_b": (8,), "fc0_w": (128, 1024),
              "fc0_b": (1024,), "head_w": (1024, 10), "head_b": (10,)}
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def _unit_masks(seed):
    rng = np.random.default_rng(seed)
    return {"conv0": (rng.random((1, 8)) < 0.5).astype(np.float32),
            "fc0": np.repeat(rng.random((1, 8)) < 0.5, 128,
                             axis=1).astype(np.float32)}


def test_scores_and_mask_expansion_match_jax():
    new, old = _params(0), _params(1)
    schema = {"conv0": (1, 8), "fc0": (1, 1024)}
    want = jC.cnn_unit_scores(jC.delta({k: jnp.asarray(v) for k, v in new.items()},
                                       {k: jnp.asarray(v) for k, v in old.items()}),
                              schema)
    got = tC.cnn_unit_scores(tC.delta({k: torch.tensor(v) for k, v in new.items()},
                                      {k: torch.tensor(v) for k, v in old.items()}),
                             schema)
    for k in schema:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    um = _unit_masks(2)
    jm = jMK.cnn_expand_masks({k: jnp.asarray(v) for k, v in um.items()},
                              {k: jnp.asarray(v) for k, v in new.items()})
    tm = tMK.cnn_expand_masks({k: torch.tensor(v) for k, v in um.items()},
                              {k: torch.tensor(v) for k, v in new.items()})
    for k in new:
        np.testing.assert_array_equal(_np(tm[k]), np.asarray(jm[k]))
    assert float(tMK.selected_fraction({k: torch.tensor(v)
                                        for k, v in um.items()})) == \
        float(jMK.selected_fraction({k: jnp.asarray(v) for k, v in um.items()}))


def test_aggregation_matches_jax():
    g = _params(0)
    clients = [_params(s) for s in (1, 2, 3)]
    ratios = [1.0, 0.4153, 0.3345]
    masks = [jMK.cnn_expand_masks({k: jnp.asarray(v) for k, v in
                                   _unit_masks(s).items()},
                                  {k: jnp.asarray(v) for k, v in g.items()})
             for s in (4, 5, 6)]
    tg = {k: torch.tensor(v) for k, v in g.items()}
    tcl = [{k: torch.tensor(v) for k, v in c.items()} for c in clients]
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jcl = [{k: jnp.asarray(v) for k, v in c.items()} for c in clients]
    tmasks = [{k: torch.tensor(np.asarray(v)) for k, v in m.items()}
              for m in masks]
    for mode in ("alpha_weighted", "uniform", "masked_mean"):
        want = j_aggregate(mode, jg, jcl, ratios, masks)
        got = tAG.aggregate(mode, tg, tcl, ratios=[torch.tensor(r)
                                                   for r in ratios],
                            client_masks=tmasks)
        for k in g:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=0, atol=1e-6, err_msg=mode)
    np.testing.assert_allclose(_np(tAG.alpha_weights(ratios)),
                               np.asarray(jAG.alpha_weights(ratios)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["momentum", "sgd"])
def test_optimizer_steps_match_jax(name):
    p = _params(0)
    jopt, topt = jO.make_optimizer(name, 0.05), tO.make_optimizer(name, 0.05)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _params(10 + step, scale=0.1)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp, 0)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in grads.items()},
                             ts, tp, 0)
        jp, tp = jO.apply_updates(jp, ju), tO.apply_updates(tp, tu)
    for k in p:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6)
        assert tp[k].dtype == torch.float32


@pytest.mark.parametrize("identification", ["resource", "time"])
def test_setup_clients_matches_jax(identification):
    labels = np.random.default_rng(0).integers(0, 10, 400).astype(np.int32)
    parts = partition_noniid(labels, 6, shards_per_client=2)
    tcl = setup_clients(make_fleet(3, 3), parts, TC.HeliosConfig(),
                        identification, device="cpu")
    jcl = j_setup_clients(j_make_fleet(3, 3), parts, JC.HeliosConfig(),
                          identification)
    assert [(c.cid, c.is_straggler, c.volume, c.profile.name) for c in tcl] \
        == [(c.cid, c.is_straggler, c.volume, c.profile.name) for c in jcl]
    for a, b in zip(tcl, jcl):
        np.testing.assert_array_equal(a.data_idx, b.data_idx)
