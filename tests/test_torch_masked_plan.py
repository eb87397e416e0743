"""The masked-matmul pair's launch plan (``repro_torch.kernels.masked_matmul
.plan``), checked on the CPU without CUDA.

``plan`` picks one of three configurations (``tile128``, ``splitk``,
``general``) and the grid, the splits and the workspace of a call from its
shapes.  These tests pin (a) which configuration the main path's shapes
take and that every grid covers each live output tile once and every split
schedule walks each live contraction row once, (b) that a torch emulation
of the schedule (the same tiles, stages, splits and reduce order as the
CUDA kernels walk) gives the plain version within 1e-5 (f32, O(1) values),
and (c) that the ``extern "C"`` signatures in ``csrc/masked_matmul.cu``
match the wrapper's ctypes ``_ARGTYPES``.  The client-axis entry points
(one launch for a cohort, ``plan(..., clients=C)``) get the same three
checks: the grid (C · row tiles, every block a client could have, splits),
the (S, C, M, N) workspace and the split-K schedule that only the cohorts
that leave the SMs idle take, and an emulation per client against the
plain versions, with a client that has no live block and a weight shared
by the cohort.  The kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import masked_matmul as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

COL, DK = "masked_matmul", "masked_matmul_dk"
TOKENS, D, F = 2048, 4096, 11008

#: the LM MLP's calls per layer-step: (label, kernel, M, K, N, x layout,
#: w layout); "col" is a transposed (column-major) view
LM_CALLS = (("wi/wg fwd", COL, TOKENS, D, F, "row", "row"),
            ("wi/wg dw", COL, D, TOKENS, F, "col", "row"),
            ("wo dh", COL, TOKENS, D, F, "row", "col"),
            ("wo dwT", COL, D, TOKENS, F, "col", "row"),
            ("wo fwd", DK, TOKENS, F, D, "row", "row"),
            ("wi/wg dx", DK, TOKENS, F, D, "row", "col"))

#: chip_smoke.py's ragged phase-3 shapes, as (M, K, N, P) of the layer
RAGGED = ((5, 37, 300, 0.6), (33, 200, 130, 0.5), (1, 4096, 1000, 0.3))


def _view(rows, cols, layout, device="meta", data=None):
    """A (rows, cols) f32 tensor, row-major or a column-major view."""
    if data is not None:
        t = torch.tensor(data if layout == "row" else data.T)
        return t if layout == "row" else t.t()
    if layout == "row":
        return torch.empty((rows, cols), device=device)
    return torch.empty((cols, rows), device=device).t()


def _live(nb, p, rng):
    k = max(1, int(round(p * nb)))
    return np.sort(rng.permutation(nb)[:k]).astype(np.int32)


def _layer_call(kind, m, k, n):
    """chip_smoke.py's layer kinds as products: fwd x @ W, dx dy @ Wᵀ (dk),
    dw xᵀ @ dy.  Returns (kernel, M, K, N, x layout, w layout)."""
    return {"fwd": (COL, m, k, n, "row", "row"),
            "dx": (DK, m, n, k, "row", "col"),
            "dw": (COL, k, m, n, "col", "row")}[kind]


def _col_tiles(p, kernel, n, live, block):
    """(n0, n1) of every grid column tile, as col_tile in the CUDA source
    maps it (empty tiles past a ragged block or past N dropped)."""
    bn = p.tile[1]
    out = []
    for t in range(p.grid[1]):
        if kernel == DK:
            n0 = t * bn
            n1 = min(n0 + bn, n)
        else:
            per = -(-block // bn)
            b0 = int(live[t // per]) * block
            n0 = b0 + (t % per) * bn
            n1 = min(n0 + bn, b0 + block, n)
        if n0 < n1:
            out.append((n0, n1))
    return out


def _k_stages(p, kernel, k, live, block, s):
    """[k0, k1) of every contraction stage of split s, as KWalk walks them."""
    bk = p.tile[2]
    lo = s * p.k_split
    out = []
    if kernel == DK:
        for seg in range(lo, min(lo + p.k_split, len(live))):
            b0 = int(live[seg]) * block
            k_end = min(b0 + block, k)
            for j in range(-(-block // bk)):
                k0 = b0 + j * bk
                if k0 < k_end:
                    out.append((k0, min(k0 + bk, k_end)))
    else:
        hi = min(lo + p.k_split, k)
        out = [(k0, min(k0 + bk, hi)) for k0 in range(lo, hi, bk)]
    return out


def _live_range(live, block, length):
    return sorted(i for b in live for i in range(b * block,
                                                 min((b + 1) * block, length)))


def _assert_covers(p, kernel, m, k, n, live, block):
    """Each live output element in exactly one tile, each live contraction
    row in exactly one stage of one split."""
    bm = p.tile[0]
    assert (p.grid[0] - 1) * bm < m <= p.grid[0] * bm
    cols = [c for n0, n1 in _col_tiles(p, kernel, n, live, block)
            for c in range(n0, n1)]
    want_cols = list(range(n)) if kernel == DK else _live_range(live, block, n)
    assert sorted(cols) == want_cols
    rows = [r for s in range(p.splits)
            for k0, k1 in _k_stages(p, kernel, k, live, block, s)
            for r in range(k0, k1)]
    want_rows = _live_range(live, block, k) if kernel == DK else list(range(k))
    assert sorted(rows) == want_rows
    assert p.grid[2] == p.splits
    assert p.workspace == ((p.splits, m, n) if p.splits > 1 else None)
    assert all(_k_stages(p, kernel, k, live, block, s)
               for s in range(p.splits))        # no split walks nothing


# ---------------------------------------------------------------------------
# (a) the configuration and the coverage of the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_live", [0.5, 1.0])
@pytest.mark.parametrize("call", LM_CALLS, ids=[c[0] for c in LM_CALLS])
def test_lm_shapes_take_tile128(call, p_live):
    _, kernel, m, k, n, xl, wl = call
    nb = -(-(k if kernel == DK else n) // 128)
    live = np.arange(0, nb, 1 if p_live == 1.0 else 2, dtype=np.int32)
    p = K.plan(kernel, m, n, k, len(live), 128, _view(m, k, xl),
               _view(k, n, wl))
    assert p.config == "tile128" and p.tile == (128, 128, 16)
    assert p.splits == 1 and p.workspace is None
    assert p.grid == (m // 128, -(-n // 128) if kernel == DK else len(live), 1)
    _assert_covers(p, kernel, m, k, n, live, 128)


@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_alexnet_fc0_batch32_takes_splitk(kind):
    kernel, m, k, n, xl, wl = _layer_call(kind, 32, 4096, 1024)
    nb = -(-(k if kernel == DK else n) // 128)
    live = _live(nb, 0.5, np.random.default_rng(0))
    p = K.plan(kernel, m, n, k, len(live), 128, _view(m, k, xl),
               _view(k, n, wl))
    assert p.config == "splitk" and p.splits > 1
    assert 132 <= np.prod(p.grid) <= 2 * K.SMS
    _assert_covers(p, kernel, m, k, n, live, 128)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("shape", RAGGED + ((32, 4096, 1024, 0.5),
                                            (32, 1024, 512, 0.25)))
def test_ragged_plans_cover_once(shape, kind, block):
    kernel, m, k, n, xl, wl = _layer_call(kind, *shape[:3])
    nb = -(-(k if kernel == DK else n) // block)
    live = _live(nb, shape[3], np.random.default_rng(1))
    x, w = _view(m, k, xl), _view(k, n, wl)
    p = K.plan(kernel, m, n, k, len(live), block, x, w)
    aligned = all(max(t.stride()) % 4 == 0 for t in (x, w))
    assert p.config == ("splitk" if m < 128 else "tile128"
                        if block % 128 == 0 and aligned else "general")
    _assert_covers(p, kernel, m, k, n, live, block)


def test_general_takes_what_tile128_cannot():
    live = np.arange(8, dtype=np.int32)
    cases = {
        "bf16": (torch.empty((256, 512), device="meta", dtype=torch.bfloat16),
                 torch.empty((512, 1024), device="meta", dtype=torch.bfloat16),
                 128),
        "block 64": (torch.empty((256, 512), device="meta"),
                     torch.empty((512, 1024), device="meta"), 64),
        "pointer": (torch.empty((256, 513))[:, 1:],
                    torch.empty((512, 1024)), 128),
        "pitch": (torch.empty((256, 514))[:, :512],
                  torch.empty((512, 1024)), 128),
    }
    for what, (x, w, block) in cases.items():
        p = K.plan(COL, 256, 1024, 512, len(live) * 128 // block, block, x, w)
        assert p.config == "general" and p.splits == 1, what
        assert p.tile == (32, 64, 32), what
    p = K.plan(COL, 256, 1024, 512, 8, 128, torch.empty((256, 512)),
               torch.empty((512, 1024)))
    assert p.config == "tile128"


def test_grid_limit_raises():
    x, w = torch.empty((256, 8), device="meta"), \
        torch.empty((8, 128 * 70000), device="meta")
    with pytest.raises(ValueError, match="65535"):
        K.plan(COL, 256, 128 * 70000, 8, 70000, 128, x, w)


# ---------------------------------------------------------------------------
# (b) the schedule, emulated in torch, against the plain version
# ---------------------------------------------------------------------------


def _emulate(kernel, x, w, live, block, p):
    """Walk the plan's grid as the CUDA kernels do: per tile and split, the
    stages in order into an f32 accumulator; split-K partials into the
    workspace, then summed over the splits in order."""
    m, k = x.shape
    n = w.shape[1]
    bm = p.tile[0]
    ws = None if p.workspace is None else torch.full(p.workspace, float("nan"))
    # the wrapper zero-fills y for the column kernel's tiles alone; the dk
    # kernel and the split-K reduce write every element
    y = torch.zeros((m, n)) if kernel == COL and ws is None else \
        torch.full((m, n), float("nan"))
    for tm in range(p.grid[0]):
        r0, r1 = tm * bm, min(tm * bm + bm, m)
        for n0, n1 in _col_tiles(p, kernel, n, live, block):
            for s in range(p.splits):
                acc = torch.zeros((r1 - r0, n1 - n0))
                for k0, k1 in _k_stages(p, kernel, k, live, block, s):
                    acc += x[r0:r1, k0:k1] @ w[k0:k1, n0:n1]
                if ws is None:
                    y[r0:r1, n0:n1] = acc
                else:
                    ws[s, r0:r1, n0:n1] = acc
    if ws is not None:                    # the column kernel's dead columns
        cols = list(range(n)) if kernel == DK else _live_range(live, block, n)
        y[:] = 0                          # are written 0 by the reduce
        total = ws[0][:, cols]
        for s in range(1, p.splits):
            total = total + ws[s][:, cols]
        y[:, cols] = total
    return y


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("p_live", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("m", [32, 160])
@pytest.mark.parametrize("kernel", [COL, DK])
def test_schedule_emulation_matches_plain(kernel, m, p_live, block):
    rng = np.random.default_rng(7)
    k, n = 520, 648                      # ragged against both tiles
    xl, wl = ("row", "row") if kernel == COL else ("row", "col")
    xd = rng.normal(size=(m, k)).astype(np.float32)
    wd = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x, w = _view(m, k, xl, data=xd), _view(k, n, wl, data=wd)
    live = _live(-(-(k if kernel == DK else n) // block), p_live, rng)
    p = K.plan(kernel, m, n, k, len(live), block, x, w)
    assert p.config == ("splitk" if m < 128 else
                        "tile128" if block == 128 else "general")
    got = _emulate(kernel, x, w, live, block, p)
    tl = torch.as_tensor(live)
    plain = ref.masked_matmul_dk_ref if kernel == DK else ref.masked_matmul_ref
    want = plain(x, w, tl, block)
    assert float((got - want).abs().max()) <= 1e-5
    if kernel == COL:                    # dead columns exactly zero
        dead = torch.ones(n, dtype=torch.bool)
        dead[_live_range(live, block, n)] = False
        assert bool((got[:, dead] == 0).all())


# ---------------------------------------------------------------------------
# (c) the C entry points against the ctypes declaration
# ---------------------------------------------------------------------------


def _c_kind(param: str):
    if "*" in param:
        return ctypes.c_void_p
    if "long long" in param:
        return ctypes.c_longlong
    if re.match(r"\s*int\s+\w+\s*$", param):
        return ctypes.c_int
    raise AssertionError(f"unexpected C parameter {param!r}")


@pytest.mark.parametrize("name", ["helios_masked_matmul",
                                  "helios_masked_matmul_dk",
                                  "helios_masked_matmul_clients",
                                  "helios_masked_matmul_dk_clients"])
def test_c_signature_matches_argtypes(name):
    src = (build.CSRC / f"{K.SOURCE}.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert sig, f"{name} not found in {K.SOURCE}.cu"
    kinds = [_c_kind(p) for p in sig.group(1).split(",")]
    assert kinds == (K._CLIENT_ARGTYPES if name.endswith("_clients")
                     else K._ARGTYPES)


# ---------------------------------------------------------------------------
# the client axis
# ---------------------------------------------------------------------------


def _client_view(c, rows, cols, layout, shared=False):
    """A (C, rows, cols) meta view whose clients are row- or column-major,
    or one (rows, cols) view shared by the cohort (client stride 0)."""
    t = _view(rows, cols, layout)
    return t.expand(c, rows, cols) if shared else \
        torch.stack([t] * c) if layout == "row" else \
        torch.empty((c, cols, rows), device="meta").transpose(1, 2)


@pytest.mark.parametrize("c, m, splits", [(2, 32, 4), (32, 16, 1),
                                          (64, 16, 1)])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_client_plan_splits_only_an_idle_grid(kind, c, m, splits):
    """fc0 of full-width AlexNet: the 2 + 2 fleet's cohorts of 2 at batch 32
    take split-K; a cohort of 32 or 64 at batch 16 fills the SMs without
    it.  The grid's x is C · row tiles, its y every block a client could
    have, and the workspace (S, C, M, N)."""
    kernel, m, k, n, xl, wl = _layer_call(kind, m, 4096, 1024)
    nb = -(-(k if kernel == DK else n) // 128)
    p = K.plan(kernel, m, n, k, nb, 128, _client_view(c, m, k, xl),
               _client_view(c, k, n, wl, shared=True), clients=c)
    assert p.config == "splitk" and p.tiles_m == 1
    assert p.grid == (c, -(-n // 64) if kernel == DK else nb * 2, p.splits)
    assert (p.splits > 1) == (splits > 1)
    assert p.workspace == ((p.splits, c, m, n) if p.splits > 1 else None)
    assert np.prod(p.grid) <= 2 * K.SMS or p.splits == 1


def test_client_dw_takes_tile128_and_the_grid_limit_raises():
    x = _client_view(4, 4096, 32, "col")
    w = _client_view(4, 32, 1024, "row")
    p = K.plan(COL, 4096, 1024, 32, 8, 128, x, w, clients=4)
    assert p.config == "tile128" and p.grid == (4 * 32, 8, 1)
    assert p.tiles_m == 32 and p.workspace is None
    x = torch.empty((2 ** 31 // 32, 4096, 8), device="meta")
    w = torch.empty((8, 128), device="meta").expand(2 ** 31 // 32, 8, 128)
    with pytest.raises(ValueError, match="2\\^31"):
        K.plan(COL, 4096, 128, 8, 1, 128, x, w, clients=2 ** 31 // 32)


@pytest.mark.parametrize("m", [32, 160])
@pytest.mark.parametrize("kernel", [COL, DK])
def test_client_schedule_emulation_matches_plain(kernel, m):
    """Each client walks the grid the client-axis kernels launch: its own
    live list (tiles past its count exit), the splits of the cohort's plan
    (a split past a client's live blocks writes zeros), the workspace rows
    of its own.  Client 0 has no live block; w is shared (stride 0)."""
    rng = np.random.default_rng(11)
    c, k, n, block = 3, 520, 648, 16
    length = k if kernel == DK else n
    nb = -(-length // block)
    flags = np.zeros((c, nb), np.float32)
    flags[1, rng.permutation(nb)[:nb // 3]] = 1
    flags[2] = 1
    table, counts = K.live_table(torch.as_tensor(flags))
    xd = rng.normal(size=(c, m, k)).astype(np.float32)
    if kernel == DK:                        # dead contraction entries are 0
        xd = xd * np.repeat(flags, block, axis=1)[:, None, :k]
    wd = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    x = torch.as_tensor(xd)
    w = torch.as_tensor(wd).expand(c, k, n) if kernel == COL else \
        torch.as_tensor(np.ascontiguousarray(wd.T)).t().expand(c, k, n)
    p = K.plan(kernel, m, n, k, nb, block, x, w, clients=c)
    per = -(-block // p.tile[1])
    want = (K.ref.masked_matmul_dk_clients_ref if kernel == DK else
            K.ref.masked_matmul_clients_ref)(x, w, table, counts, block)
    for i in range(c):
        live = table[i, :int(counts[i])].numpy()
        # the client's share of the grid: its row tiles, the column tiles
        # that do not exit, the cohort's splits
        tiles_n = p.grid[1] if kernel == DK else len(live) * per
        mine = dataclasses.replace(
            p, grid=(p.tiles_m, tiles_n, p.splits),
            workspace=None if p.splits == 1 else (p.splits, m, n))
        got = _emulate(kernel, x[i], w[i], live, block, mine)
        assert float((got - want[i]).abs().max()) <= 1e-5, i
    assert float(want[0].abs().max()) == 0.0
