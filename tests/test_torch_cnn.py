"""Port parity: the CNN testbed (``repro_torch.models.cnn``) against the JAX
package's ``repro.models.cnn``.

Reduced LeNet and AlexNet with the same numpy-drawn params (carried into
the port by the weight bridge) and the same numpy batch.  Logits and parameter gradients
agree at atol 1e-5, unmasked (plain path) and masked (the port's
``kernels="cuda"`` path on its CPU plain bodies against the reference's
``kernels="pallas"`` in interpret mode).  The masks mix unit-granular conv
filters with block-constant fc units at ``mask_block=128``, so AlexNet's
fc0 (8 blocks) and fc1 (4 blocks) really skip dead blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import abstract_params  # noqa: E402
from repro.models.cnn import cnn_logits as jax_logits  # noqa: E402
from repro.models.cnn import cnn_loss as jax_loss  # noqa: E402
from repro_torch import bridge  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ATOL = 1e-5
BLOCK = 128


def _masks(schema, seed):
    """Unit-random conv masks, block-constant fc masks (>= 4 blocks) with
    about half the blocks alive, the rest unit-random."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (_, n) in sorted(schema.items()):
        if n >= 4 * BLOCK:
            blocks = rng.random(n // BLOCK) < 0.5
            blocks[0] = True
            m = np.repeat(blocks, BLOCK).astype(np.float32)
        else:
            m = (rng.random(n) < 0.6).astype(np.float32)
            m[0] = 1.0
        out[k] = m[None]
    return out


@pytest.fixture(scope="module", params=["lenet", "alexnet"])
def model(request):
    jcfg = JC.reduced(JC.CNNS[request.param])
    tcfg = TC.reduced(TC.CNNS[request.param])
    rng = np.random.default_rng(1)
    np_params = {k: (rng.normal(size=p.shape) / np.sqrt(
        np.prod(p.shape[:-1]) if len(p.shape) > 1 else 1.0)).astype(np.float32)
        for k, p in tcnn.cnn_spec(tcfg).items()}
    images = rng.normal(size=(4, jcfg.image_size, jcfg.image_size,
                              jcfg.in_channels)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, size=4).astype(np.int32)
    schema = tcnn.cnn_mask_schema(tcfg)
    return jcfg, tcfg, np_params, images, labels, schema


def _jax(jcfg, params, images, labels, masks):
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    rt = {"kernels": None if masks is None else "pallas", "mask_block": BLOCK}
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}

    @jax.jit
    def fwd_grad(p, b, m):
        return (jax_logits(p, b["images"], jcfg, m, rt["kernels"], BLOCK),
                jax.grad(jax_loss)(p, b, jcfg, rt, m))

    logits, grads = fwd_grad({k: jnp.asarray(v) for k, v in params.items()},
                             batch, jm)
    return np.asarray(logits), {k: np.asarray(v) for k, v in grads.items()}


def _torch(tcfg, params, images, labels, masks):
    tp = {k: v.requires_grad_(True)
          for k, v in bridge.params_from_numpy(params, "cpu").items()}
    tm = None if masks is None else {k: torch.tensor(v)
                                     for k, v in masks.items()}
    kernels = None if masks is None else "cuda"
    batch = {"images": torch.tensor(images), "labels": torch.tensor(labels)}
    logits = tcnn.cnn_logits(tp, batch["images"], tcfg, tm, kernels, BLOCK)
    loss = tcnn.cnn_loss(tp, batch, tcfg,
                         {"kernels": kernels, "mask_block": BLOCK}, tm)
    grads = torch.autograd.grad(loss, list(tp.values()))
    return logits.detach().numpy(), {k: g.numpy()
                                     for k, g in zip(tp, grads)}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_logits_and_grads_match_jax(model, masked):
    jcfg, tcfg, params, images, labels, schema = model
    masks = _masks(schema, 2) if masked else None
    jl, jg = _jax(jcfg, params, images, labels, masks)
    tl, tg = _torch(tcfg, params, images, labels, masks)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if masked:                 # frozen units: exactly-zero weight gradients
        for k, m in masks.items():
            dead = m[0] == 0
            assert np.all(tg[f"{k}_w"][..., dead] == 0), k
            assert np.all(tg[f"{k}_b"][dead] == 0), k


def test_spec_and_bridge_round_trip(model):
    jcfg, tcfg, params, *_ = model
    assert {k: p.shape for k, p in tcnn.cnn_spec(tcfg).items()} == \
        {k: v.shape for k, v in abstract_params(jcfg).items()}
    back = bridge.params_to_numpy(bridge.params_from_numpy(params, "cpu"))
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
        assert back[k].dtype == params[k].dtype
