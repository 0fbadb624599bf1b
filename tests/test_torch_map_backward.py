"""The closed-form backward of the map kernels against the JAX package.

``reg_stats_vjp_ref``, ``psi2_vjp_ref`` and ``psi1_vjp_ref``
(``repro_torch.kernels.*.ref``) state, without autograd, the functions the
backward kernels ``csrc/reg_stats_bwd.cu``, ``csrc/psi2_bwd.cu`` and
``csrc/psi1_bwd.cu`` compute.  The same numpy inputs, made from a seed, go
through ``jax.vjp`` of the reference's ``core.stats.reg_stats_dense``, of
its weighted per-point psi2 and of its ``se_psi1``, and through the closed
forms on the CPU, at rtol 1e-8 / atol 1e-10 (the custom_vjp contract of
``tests/test_reg_stats_pallas.py``): a non-symmetric cotangent throughout,
zero weights, d 1 and d past 8, q past 16 (the kernels stage 16 features
at a time) and m off the kernels' tiles (psi1: past one 256-column tile).
The closed forms are also held against the port's chunked recompute
(``reg_stats_vjp``, ``psi2_vjp``, ``psi1_vjp``: autograd of the plain
version) with each pattern of wanted gradients; the backward operators'
fake implementations and FLOP formulas, and the kernels' plans, clusters
and shared memory, are checked without a card.  The kernels themselves are held
against these on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.core import gp_kernels as j_gpk
from repro.core import stats as j_stats
from repro_torch.kernels.psi_stats import kernel as ps_k
from repro_torch.kernels.psi_stats import ops as ps_ops
from repro_torch.kernels.psi_stats import ref as ps_ref
from repro_torch.kernels.reg_stats import kernel as rs_k
from repro_torch.kernels.reg_stats import ops as rs_ops
from repro_torch.kernels.reg_stats import ref as rs_ref

RTOL, ATOL = 1e-8, 1e-10

# (n, m, q, d, weights): d 1 and d past 8, q past 16, m off the tiles
RS_CASES = [
    (60, 37, 3, 1, "masked"),
    (50, 130, 18, 11, "masked"),
    (40, 12, 2, 9, "zero"),
    (33, 7, 17, 2, "ones"),
]
# (n, m, q, weights): q past 16, m off the 64-point tiles and below a patch
PSI_CASES = [
    (40, 37, 3, "masked"),
    (30, 65, 18, "masked"),
    (25, 12, 2, "zero"),
    (20, 3, 1, "ones"),
]
# (n, m, q, weights, shift): mu and z shifted by +100 in every feature (the
# expanded exponent's cancellation), and m off the 8-point patches at
# gplvm-usps's q
PSI_EXTRA = [
    (30, 37, 3, "masked", 100.0),
    (12, 29, 10, "masked", 0.0),
]
# (n, m, q): q past 16, m off the tiles and past one 256-column tile
PSI1_CASES = [
    (40, 37, 3),
    (30, 300, 18),
    (25, 12, 2),
    (20, 3, 1),
    (33, 257, 5),
]
NEEDS = [
    (True,) * 6,
    (True, True, True, False, False, False),
    (False, False, False, True, True, True),
    (False, True, False, True, False, True),
]
# psi1's five inputs (log_sf2, log_ell, z, mu, s)
NEEDS1 = [
    (True,) * 5,
    (True, True, True, False, False),
    (False, False, False, True, True),
    (False, True, False, False, True),
    (True, False, True, True, False),
]


def _weights(rng, n, kind):
    if kind == "zero":
        return np.zeros(n)
    if kind == "ones":
        return np.ones(n)
    return (rng.uniform(size=n) > 0.3).astype(np.float64)


def _rs_inputs(n, m, q, d, kind):
    rng = np.random.default_rng(n + 7 * m + q + d)
    ins = [np.asarray(rng.uniform(-0.5, 0.8)), rng.uniform(-0.4, 0.4, q),
           rng.standard_normal((m, q)), rng.standard_normal((n, q)),
           rng.standard_normal((n, d)), _weights(rng, n, kind)]
    cts = [np.asarray(rng.standard_normal()), rng.standard_normal((m, d)),
           rng.standard_normal((m, m))]   # gD not symmetric
    return ins, cts


def _psi_inputs(n, m, q, kind, shift=0.0):
    rng = np.random.default_rng(3 * n + m + q)
    ins = [np.asarray(rng.uniform(-0.5, 0.8)), rng.uniform(-0.4, 0.4, q),
           rng.standard_normal((m, q)) + shift,
           rng.standard_normal((n, q)) + shift,
           rng.uniform(0.05, 0.8, (n, q)), _weights(rng, n, kind)]
    return ins, rng.standard_normal((m, m))


def _psi1_inputs(n, m, q):
    rng = np.random.default_rng(5 * n + m + q)
    ins = [np.asarray(rng.uniform(-0.5, 0.8)), rng.uniform(-0.4, 0.4, q),
           rng.standard_normal((m, q)), rng.standard_normal((n, q)),
           rng.uniform(0.05, 0.8, (n, q))]
    return ins, rng.standard_normal((n, m))


def _t(arrs):
    return [torch.from_numpy(np.array(a, dtype=np.float64)) for a in arrs]


def _close(got, want, rtol=RTOL, atol=ATOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_rs():
    """jax.vjp of reg_stats_dense for every case, computed once."""
    out = {}
    for case in RS_CASES:
        ins, cts = _rs_inputs(*case)

        def fn(log_sf2, log_ell, z, x, y, w):
            return j_stats.reg_stats_dense(
                {"log_sf2": log_sf2, "log_ell": log_ell}, z, x, y, w)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
        out[case] = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cts)))]
    return out


@pytest.fixture(scope="module")
def jax_psi():
    """jax.vjp of the reference's weighted psi2 for every case, once."""
    out = {}
    for case in PSI_CASES + PSI_EXTRA:
        ins, g = _psi_inputs(*case)

        def fn(log_sf2, log_ell, z, mu, s, w):
            per = j_gpk.psi2_per_point({"log_sf2": log_sf2,
                                        "log_ell": log_ell}, z, mu, s)
            return jnp.einsum("n,njk->jk", w, per)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
        out[case] = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    return out


@pytest.fixture(scope="module")
def jax_psi1():
    """jax.vjp of the reference's se_psi1 for every case, once."""
    out = {}
    for case in PSI1_CASES:
        ins, g = _psi1_inputs(*case)

        def fn(log_sf2, log_ell, z, mu, s):
            return j_gpk.se_psi1({"log_sf2": log_sf2, "log_ell": log_ell},
                                 z, mu, s)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
        out[case] = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    return out


@pytest.mark.parametrize("case", RS_CASES)
def test_reg_stats_closed_form_matches_jax_vjp(case, jax_rs):
    ins, cts = _rs_inputs(*case)
    got = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), [True] * 6, chunk=17)
    for i, (g, want) in enumerate(zip(got, jax_rs[case])):
        assert g.shape == want.shape
        _close(g, want, name=f"input {i}")


@pytest.mark.parametrize("case", PSI_CASES)
def test_psi2_closed_form_matches_jax_vjp(case, jax_psi):
    ins, g = _psi_inputs(*case)
    got = ps_ref.psi2_vjp_ref(*_t(ins), torch.from_numpy(g), [True] * 6,
                              chunk=7)
    for i, (t, want) in enumerate(zip(got, jax_psi[case])):
        assert t.shape == want.shape
        _close(t, want, name=f"input {i}")


@pytest.mark.parametrize("case", PSI_CASES + PSI_EXTRA)
def test_psi2_products_match_jax_vjp(case, jax_psi):
    """``psi2_vjp_products``, the arithmetic of ``csrc/psi2_bwd.cu`` (the
    centred factorisation, E = A B^T, H = G B, Q = F^T A and the
    elementwise chain), against jax.vjp of the reference at normwise
    1e-10, every input's gradient: the offset case holds only because
    mu and z are centred before the expansion."""
    ins, g = _psi_inputs(*case)
    got = ps_ref.psi2_vjp_products(*_t(ins), torch.from_numpy(g), [True] * 6)
    for i, (t, want) in enumerate(zip(got, jax_psi[case])):
        assert t.shape == want.shape
        err = np.linalg.norm(t.numpy() - want)
        assert err <= 1e-10 * max(np.linalg.norm(want), 1e-300), (i, err)


@pytest.mark.parametrize("case", PSI1_CASES)
def test_psi1_closed_form_matches_jax_vjp(case, jax_psi1):
    ins, g = _psi1_inputs(*case)
    got = ps_ref.psi1_vjp_ref(*_t(ins), torch.from_numpy(g), [True] * 5,
                              chunk=7)
    for i, (t, want) in enumerate(zip(got, jax_psi1[case])):
        assert t.shape == want.shape
        _close(t, want, name=f"input {i}")


@pytest.mark.parametrize("needs", NEEDS1)
@pytest.mark.parametrize("case", PSI1_CASES[:2])
def test_psi1_closed_form_matches_chunked_recompute(case, needs):
    ins, g = _psi1_inputs(*case)
    got = ps_ref.psi1_vjp_ref(*_t(ins), torch.from_numpy(g), list(needs))
    want = ps_ops.psi1_vjp(*_t(ins), torch.from_numpy(g), list(needs))
    for i, (t, w, need) in enumerate(zip(got, want, needs)):
        assert (t is None) == (not need) == (w is None)
        if need:
            _close(t, w, rtol=1e-10, atol=1e-12, name=f"input {i}")


@pytest.mark.parametrize("needs", NEEDS)
@pytest.mark.parametrize("case", RS_CASES[:2])
def test_reg_stats_closed_form_matches_chunked_recompute(case, needs):
    ins, cts = _rs_inputs(*case)
    got = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), list(needs))
    want = rs_ops.reg_stats_vjp(*_t(ins), *_t(cts), list(needs))
    for i, (g, w, need) in enumerate(zip(got, want, needs)):
        assert (g is None) == (not need) == (w is None)
        if need:
            _close(g, w, rtol=1e-10, atol=1e-12, name=f"input {i}")


@pytest.mark.parametrize("needs", NEEDS)
@pytest.mark.parametrize("case", PSI_CASES[:2])
def test_psi2_closed_form_matches_chunked_recompute(case, needs):
    ins, g = _psi_inputs(*case)
    got = ps_ref.psi2_vjp_ref(*_t(ins), torch.from_numpy(g), list(needs))
    want = ps_ops.psi2_vjp(*_t(ins), torch.from_numpy(g), list(needs))
    for i, (t, w, need) in enumerate(zip(got, want, needs)):
        assert (t is None) == (not need) == (w is None)
        if need:
            _close(t, w, rtol=1e-10, atol=1e-12, name=f"input {i}")


def test_absolute_closed_forms_bound_the_signed_ones():
    """``absolute=True`` sums every term by its absolute value: it bounds
    the signed sum entry by entry, with equality where no term is
    negative (the cotangents and weights non-negative, one feature and
    every x right of every z)."""
    ins, cts = _rs_inputs(40, 9, 3, 2, "masked")
    signed = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), [True] * 6)
    absol = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), [True] * 6,
                                     absolute=True)
    for s, a in zip(signed, absol):
        assert bool((s.abs() <= a * (1 + 1e-12) + 1e-300).all())
    pins, g = _psi_inputs(20, 6, 2, "masked")
    signed = ps_ref.psi2_vjp_ref(*_t(pins), torch.from_numpy(g), [True] * 6)
    absol = ps_ref.psi2_vjp_ref(*_t(pins), torch.from_numpy(g), [True] * 6,
                                absolute=True)
    for s, a in zip(signed, absol):
        assert bool((s.abs() <= a * (1 + 1e-12) + 1e-300).all())
    pins, g = _psi1_inputs(20, 6, 2)
    signed = ps_ref.psi1_vjp_ref(*_t(pins), torch.from_numpy(g), [True] * 5)
    absol = ps_ref.psi1_vjp_ref(*_t(pins), torch.from_numpy(g), [True] * 5,
                                absolute=True)
    for s, a in zip(signed, absol):
        assert bool((s.abs() <= a * (1 + 1e-12) + 1e-300).all())
    rng = np.random.default_rng(0)
    x = rng.uniform(3.0, 4.0, (30, 1))
    ins = [np.asarray(0.1), np.asarray([0.2]), rng.uniform(-1.0, 0.0, (5, 1)),
           x, rng.uniform(0.0, 1.0, (30, 1)), np.ones(30)]
    cts = [np.asarray(0.5), rng.uniform(0.0, 1.0, (5, 1)),
           rng.uniform(0.0, 1.0, (5, 5))]
    needs = [True, True, True, False, True, True]
    signed = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), needs)
    absol = rs_ref.reg_stats_vjp_ref(*_t(ins), *_t(cts), needs, absolute=True)
    for s, a in zip(signed, absol):
        if s is not None:
            _close(s, a, rtol=1e-13, atol=0.0)


@pytest.mark.parametrize("flags", [0, 1, 6, 7])
def test_reg_stats_bwd_fake_shapes_and_flops(flags):
    n, m, q, d = 1000, 300, 5, 3
    with FakeTensorMode():
        ins = [torch.empty(()), torch.empty(q), torch.empty(m, q),
               torch.empty(n, q), torch.empty(n, d), torch.empty(n)]
        cts = [torch.empty(()), torch.empty(m, d), torch.empty(m, m)]
        ins = [t.double() for t in ins]
        with FlopCounterMode(display=False) as counter:
            out = torch.ops.repro_torch.reg_stats_bwd(*ins, *cts, flags)
    shapes = [(), (q,), (m, q), (n, q) if flags & 1 else (0,),
              (n, d) if flags & 2 else (0,), (n,) if flags & 4 else (0,)]
    assert [tuple(t.shape) for t in out] == shapes
    assert all(t.dtype == torch.float64 for t in out)
    assert counter.get_total_flops() == rs_ops.bwd_flops(n, m, q, d)


@pytest.mark.parametrize("flags", [0, 3, 4, 7])
def test_psi2_bwd_fake_shapes_and_flops(flags):
    n, m, q = 700, 150, 10
    with FakeTensorMode():
        ins = [torch.empty(()), torch.empty(q), torch.empty(m, q),
               torch.empty(n, q), torch.empty(n, q), torch.empty(n)]
        ins = [t.float() for t in ins]
        with FlopCounterMode(display=False) as counter:
            out = torch.ops.repro_torch.psi2_bwd(*ins, torch.empty(m, m),
                                                 flags)
    shapes = [(), (q,), (m, q), (n, q) if flags & 1 else (0,),
              (n, q) if flags & 2 else (0,), (n,) if flags & 4 else (0,)]
    assert [tuple(t.shape) for t in out] == shapes
    assert all(t.dtype == torch.float32 for t in out)
    assert counter.get_total_flops() == ps_ops.psi2_bwd_flops(n, m, q)


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_psi1_bwd_fake_shapes_and_flops(flags):
    n, m, q = 4649, 150, 10
    with FakeTensorMode():
        ins = [torch.empty(()), torch.empty(q), torch.empty(m, q),
               torch.empty(n, q), torch.empty(n, q)]
        ins = [t.double() for t in ins]
        with FlopCounterMode(display=False) as counter:
            out = torch.ops.repro_torch.psi1_bwd(
                *ins, torch.empty(n, m, dtype=torch.float64), flags)
    shapes = [(), (q,), (m, q), (n, q) if flags & 1 else (0,),
              (n, q) if flags & 2 else (0,)]
    assert [tuple(t.shape) for t in out] == shapes
    assert all(t.dtype == torch.float64 for t in out)
    assert counter.get_total_flops() == ps_ops.psi1_bwd_flops(n, m, q)


def test_functions_backward_through_the_operators_on_fake_tensors():
    """On fake tensors (the dry run) the Functions' backward calls the
    backward operators: gradients of the inputs asked for, with their
    shapes, None for the rest, and no kernel launched."""
    before = (dict(rs_ops.LAUNCHES), dict(ps_ops.LAUNCHES))
    n, m, q, d = 200, 40, 3, 2
    with FakeTensorMode():
        hyp = {"log_sf2": torch.zeros((), dtype=torch.float64,
                                      requires_grad=True),
               "log_ell": torch.zeros(q, dtype=torch.float64,
                                      requires_grad=True)}
        z = torch.zeros(m, q, dtype=torch.float64, requires_grad=True)
        x, y, w = (torch.zeros(sh, dtype=torch.float64)
                   for sh in ((n, q), (n, d), (n,)))
        with FlopCounterMode(display=False) as counter:
            b, c, dd = rs_ops.reg_stats(hyp, z, x, y, w)
            grads = torch.autograd.grad(b + c.sum() + dd.sum(),
                                        [hyp["log_sf2"], hyp["log_ell"], z])
        assert [tuple(g.shape) for g in grads] == [(), (q,), (m, q)]
        flops = counter.get_flop_counts()
        assert flops["Global"][torch.ops.repro_torch.reg_stats_bwd] \
            == rs_ops.bwd_flops(n, m, q, d)
        mu = torch.zeros(n, q, dtype=torch.float64, requires_grad=True)
        s = torch.ones(n, q, dtype=torch.float64)
        psi = ps_ops.psi2(hyp, z, mu, s, w)
        gz, gmu = torch.autograd.grad(psi.sum(), [z, mu])
        assert gz.shape == (m, q) and gmu.shape == (n, q)
        with FlopCounterMode(display=False) as counter:
            p1 = ps_ops.psi1(hyp, z, mu, s)
            gell, gmu = torch.autograd.grad(p1.sum(), [hyp["log_ell"], mu])
        assert gell.shape == (q,) and gmu.shape == (n, q)
        assert counter.get_flop_counts()["Global"][
            torch.ops.repro_torch.psi1_bwd] == ps_ops.psi1_bwd_flops(n, m, q)
    assert (dict(rs_ops.LAUNCHES), dict(ps_ops.LAUNCHES)) == before


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 1_000_000])
@pytest.mark.parametrize("slots", [1, 132, 264])
def test_reg_stats_bwd_plan_covers_every_row_tile_once(n, slots):
    n_slices, per = rs_k.bwd_plan(n, slots)
    tiles = -(-n // rs_k.BWD_ROWS)
    assert 1 <= n_slices <= max(1, slots)
    covered = [t for s in range(n_slices)
               for t in range(s * per, min(tiles, (s + 1) * per))]
    assert covered == list(range(tiles))


@pytest.mark.parametrize("m", [1, 127, 128, 129, 512, 1000, 1024, 1030,
                               2048, 46_400])
def test_reg_stats_bwd_cluster_covers_every_column_tile_once(m):
    """Block r of a cluster takes the column tiles g width + r over the
    groups g: every 128-point tile of m once, a cluster at most
    ``BWD_CLUSTER`` wide, and one group (knm built once) up to 1,024
    points."""
    width, groups = rs_k.bwd_cluster(m)
    tiles = -(-m // rs_k.BWD_COLUMNS)
    assert 1 <= width <= rs_k.BWD_CLUSTER and width <= tiles
    covered = sorted(g * width + r for g in range(groups) for r in range(width)
                     if g * width + r < tiles)
    assert covered == list(range(tiles))
    assert (groups == 1) == (m <= rs_k.BWD_CLUSTER * rs_k.BWD_COLUMNS)
    assert rs_ops.bwd_flops(1, m, 8, 4) - rs_ops.bwd_flops(1, m, 8, 0) \
        == 8 * m


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4649, 100_000])
@pytest.mark.parametrize("slots", [1, 264])
def test_psi1_bwd_plan_covers_every_row_once(n, slots):
    """Block b of psi1's backward takes the units of ``rows`` rows b, b +
    blocks, ...: every row once, at most ``slots`` blocks and at least
    one, units of a multiple of 8 rows up to 32, and one wave (no more
    units than slots) wherever 32-row units allow it."""
    blocks, per = ps_k.psi1_bwd_plan(n, slots)
    assert 1 <= blocks <= max(1, slots)
    assert per % 8 == 0 and 8 <= per <= ps_k.P1_ROWS
    units = -(-n // per)
    assert units <= slots or per == ps_k.P1_ROWS
    rows = sorted(r for b in range(blocks) for u in range(b, units, blocks)
                  for r in range(u * per, min(n, (u + 1) * per)))
    assert rows == list(range(n))


def _patch_of(pt, nb):
    """The kernel's patch_of: upper 8-point blocks (jb <= kb), row-major."""
    jb = 0
    while pt >= nb - jb:
        pt -= nb - jb
        jb += 1
    return jb, jb + pt


@pytest.mark.parametrize("n", [0, 1, 33, 4649, 100_000])
@pytest.mark.parametrize("slots", [1, 132])
def test_psi2_bwd_plan_covers_every_row_once(n, slots):
    """psi2's backward items (64-row tile, 8 x 8-point patch), row tile
    major, in equal shares of ``items // blocks``: for each m, the blocks'
    ranges cover every item once; a block touches at most ``row_tiles``
    row tiles; the kernel's patch walk (``patch_of`` at a block's first
    item, then the next patch row-major) visits every upper patch once a
    row tile, and the patches' slots every pair j <= k < m once; the row
    epilogue's first and last block of a row tile are the blocks that
    hold its first and last item, its slot in the first ``tile - first
    tile of that block`` and 0 in the later ones."""
    for m in (1, 63, 64, 65, 150, 151, 257):
        blocks, row_tiles, items, patches = ps_k.psi2_bwd_plan(n, m, slots)
        nb = -(-m // ps_k.BWD_PATCH)
        assert patches == nb * (nb + 1) // 2
        assert items == -(-n // ps_k.BWD_ROWS) * patches
        assert 1 <= blocks <= max(1, slots) and (items == 0 or blocks <= items)
        lo = [b * items // blocks for b in range(blocks + 1)]
        assert lo[0] == 0 and lo[-1] == items
        assert all(a < b for a, b in zip(lo, lo[1:])) or items == 0
        for a, b in zip(lo, lo[1:]):
            if b > a:
                assert (b - 1) // patches - a // patches + 1 <= row_tiles
        walk, jb, kb = [], 0, 0
        for pt in range(patches):   # the kernel's step from patch to patch
            if pt:
                kb += 1
                if kb == nb:
                    jb += 1
                    kb = jb
            walk.append((jb, kb))
            assert _patch_of(pt, nb) == (jb, kb)
        pairs = sorted((jb * 8 + a, kb * 8 + b) for jb, kb in walk
                       for a in range(8) for b in range(8)
                       if jb * 8 + a <= kb * 8 + b < m)
        assert pairs == [(j, k) for j in range(m) for k in range(j, m)]
        for rt in range(-(-n // ps_k.BWD_ROWS)):
            b_lo = ((rt * patches + 1) * blocks - 1) // items
            b_hi = ((rt + 1) * patches * blocks - 1) // items
            assert lo[b_lo] <= rt * patches < lo[b_lo + 1]
            assert lo[b_hi] <= (rt + 1) * patches - 1 < lo[b_hi + 1]
            assert 0 <= rt - lo[b_lo] // patches < row_tiles
            assert all(lo[b] // patches == rt for b in range(b_lo + 1,
                                                               b_hi + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_shared_memory_is_fixed_and_fits(dtype):
    """One block's shared memory fits an sm_90 block (the f32 reg_stats
    backward two a multiprocessor), whatever q and d; the redesigned
    reg_stats backward's own knm tile (128 points x 64 rows) fits beside
    its buffers; psi2's backward block (any q) fits twice an SM, and its
    plan counts two up to q 15; psi1's backward grows with m only up to
    one 256-column tile, and two of its blocks fit an SM at gplvm-usps (m
    150)."""
    rs = rs_k.bwd_smem_bytes(dtype)
    ps = ps_k.psi2_bwd_smem_bytes()
    per_sm = rs_k.BWD_BLOCKS_PER_SM[dtype]
    assert (rs + 512) * per_sm <= rs_k.SMEM_LIMIT   # beside the exp table
    item = torch.empty((), dtype=dtype).element_size()
    own = rs_k.BWD_COLUMNS * (rs_k.BWD_ROWS + (4 if item == 8 else 0)) * item
    assert own < rs < rs_k.SMEM_LIMIT - 512
    # psi2: two blocks an SM, each beside its 1 KB reserve and exp table
    assert 2 * (ps + 1536) <= ps_k.SM_SMEM
    assert [ps_k.psi2_bwd_blocks_per_sm(q) for q in (1, 10, 15, 16, 160)] \
        == [2, 2, 2, 1, 1]
    p1 = [ps_k.psi1_bwd_smem_bytes(m, q, dtype)
          for m in (1, 150, 256, 257, 46_400) for q in (1, 10, 16, 17, 160)]
    assert max(p1) + 512 <= ps_k.SMEM_MAX
    assert ps_k.psi1_bwd_smem_bytes(256, 10, dtype) \
        == ps_k.psi1_bwd_smem_bytes(46_400, 10, dtype)
    usps = ps_k.psi1_bwd_smem_bytes(150, 10, dtype) + 1536
    assert ps_k.psi1_bwd_blocks_per_sm(150, 10, dtype) == 2
    assert 2 * usps <= ps_k.SM_SMEM
