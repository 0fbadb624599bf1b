"""ctypes binding of ``csrc/psi_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and psi2's output float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

TILE = 64        # psi2 D tile edge in the CUDA source (TM)
PATCH = 4        # psi2 patch edge: a thread's PATCH x PATCH pairs (PP)
ROWS = 32        # psi2 rows staged per chunk in the CUDA source (RC)
THREADS = 256    # threads per block (NT)
FEATURES = 16    # features staged at a time in the CUDA source (QC)
P1_ROWS = 32     # psi1 rows per unit, at most (P1R)
P1_COLS = 256    # psi1 columns per unit, at most (P1C)
P1_ITEMS = 4     # psi1 (row, run) items per thread, at most (P1I)
SMEM_MAX = 232_448   # dynamic shared memory a block may use on sm_90
UNITS_PER_SM = 8     # psi2 (tile, row slice) units per SM the plan aims at
UV_ELEMS = 16_384    # psi2 f32: floats of the staged rows' u and v (UVE)

_P = ctypes.c_void_p
_I = ctypes.c_int
_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def smem_bytes(kind: str, q: int, dtype) -> int:
    """Dynamic shared memory one block of ``psi1``/``psi2`` needs (the
    launcher's ``psi2_smem``/``psi1_smem``).  The kernels stage q in chunks
    of ``FEATURES``, so past that ``q`` does not change it; psi1 stages
    z for min(q, ``FEATURES``) features."""
    item = torch.empty((), dtype=dtype).element_size()
    if kind == "psi2" and dtype == torch.float32:
        # the staged rows' u and v (the threads' sums reuse them), and the
        # log1p terms beside (mu, 1/(2c))
        return item * (2 * FEATURES * TILE + UV_ELEMS + 2 * ROWS * TILE
                       + 3 * ROWS * FEATURES + 2 * ROWS)
    if kind == "psi2":
        return item * (2 * FEATURES * TILE + 2 * ROWS * TILE
                       + PATCH * PATCH * THREADS + 2 * ROWS * FEATURES
                       + 2 * ROWS)
    vec = 16 // item
    return item * (min(q, FEATURES) * (P1_COLS + vec)
                   + 3 * P1_ROWS * (FEATURES + 1) + P1_ROWS)


def psi1_plan(n: int, m: int, dtype) -> tuple[int, int, int]:
    """psi1's units: (rows per unit, runs per unit, column tiles).  A run is
    the 16 bytes of a row's consecutive columns (2 f64, 4 f32); a unit
    takes up to ``P1_COLS`` columns, so all of m <= 256 in one column tile,
    and as many rows (up to ``P1_ROWS``) as give each of the ``THREADS``
    threads up to ``P1_ITEMS`` (row, run) items.  Unit u covers rows
    ``(u // col_tiles) * rows ...`` and runs ``(u % col_tiles) * rpt ...``;
    there are ``ceil(n / rows) * col_tiles`` of them."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    runs = -(-m // vec)
    col_tiles = -(-runs // (P1_COLS // vec))
    rpt = -(-runs // col_tiles)
    rows = max(1, min(P1_ROWS, THREADS * P1_ITEMS // rpt))
    return rows, rpt, col_tiles


def psi2_plan(n: int, m: int, sms: int) -> tuple[int, int, int]:
    """psi2's work split, both dtypes: (upper TILE x TILE tiles of D,
    n-slices, rows per slice, a multiple of ``ROWS``).  Units (tile, slice)
    go on gridDim.x and are walked grid-stride past its limit, so no m is
    refused; there are about ``UNITS_PER_SM`` per SM where n allows, so the
    tiles' unequal work evens out across the SMs (f32 measured slower with
    2 or 4: the units of small tiles finish early)."""
    nts = -(-m // TILE)
    n_tiles = nts * (nts + 1) // 2
    chunks = max(1, -(-n // ROWS))
    n_slices = max(1, min(chunks, -(-UNITS_PER_SM * sms // n_tiles)))
    per_slice = -(-chunks // n_slices) * ROWS
    return n_tiles, max(1, -(-n // per_slice)), per_slice


def psi2_scratch_len(n: int, m: int, q: int, n_slices: int,
                     dtype=torch.float64) -> int:
    """Elements of psi2's scratch (the launcher's layout): the slice
    partials of D's upper PATCH x PATCH patches; f64 then hp = [sf2^2,
    l^2] (q + 1), the rows' log-normalisers (n) and 1/(2 (l^2 + 2s)) (n,
    q), which the f32 kernel's units compute themselves."""
    np_ = -(-m // PATCH)
    partials = n_slices * (np_ * (np_ + 1) // 2) * PATCH * PATCH
    return partials if dtype == torch.float32 else partials + (q + 1) * (n + 1)


def psi2_scratch(n: int, m: int, q: int, dtype, device):
    """(n-slices, rows per slice, scratch) of one psi2 launch."""
    _, n_slices, rows = psi2_plan(n, m, _build.sm_count(device))
    scratch = torch.empty((psi2_scratch_len(n, m, q, n_slices, dtype),),
                          dtype=dtype, device=device)
    return n_slices, rows, scratch


def _fn(kind: str, dtype, argtypes, lib: str = "psi_stats"):
    name = f"{kind}_{_NAMES[dtype]}"
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return name, fn


def psi2(mu, s, w, z, log_sf2, log_ell, n_slices, rows_per_slice, scratch,
         d_out) -> None:
    """Launch psi2 for mu's dtype on the current stream (f64: the
    hyper-parameters, the rows' terms, the tile pass and the fixed-order
    reduce; f32: the tile pass and the reduce), with the scratch of
    :func:`psi2_scratch`."""
    name, fn = _fn("psi2", mu.dtype, [_P] * 6 + [_I] * 5 + [_P, _P, _P])
    n, q = mu.shape
    err = fn(mu.data_ptr(), s.data_ptr(), w.data_ptr(), z.data_ptr(),
             log_sf2.data_ptr(), log_ell.data_ptr(), n, z.shape[0], q,
             n_slices, rows_per_slice, scratch.data_ptr(), d_out.data_ptr(),
             _build.stream_handle(mu.device))
    _build.check(name, err)


def psi1(mu, s, z, log_sf2, log_ell, out) -> None:
    """Launch psi1's instantiation for mu's dtype on the current stream, in
    the units of :func:`psi1_plan`."""
    name, fn = _fn("psi1", mu.dtype, [_P] * 5 + [_I] * 6 + [_P, _P])
    n, q = mu.shape
    m = z.shape[0]
    err = fn(mu.data_ptr(), s.data_ptr(), z.data_ptr(), log_sf2.data_ptr(),
             log_ell.data_ptr(), n, m, q, *_psi1_plan(n, m, mu.dtype),
             out.data_ptr(), _build.stream_handle(mu.device))
    _build.check(name, err)


_psi1_plan = functools.lru_cache(maxsize=64)(psi1_plan)


# -- psi2's backward: csrc/psi2_bwd.cu ---------------------------------------

BWD_ROWS = 64     # rows a tile (RT)
BWD_PATCH = 8     # an item's pairs: a BWD_PATCH x BWD_PATCH patch of points (PB)
BWD_CHUNK = 32    # columns of A and B staged at a time (KC)


def psi2_bwd_width(q: int) -> int:
    """Columns of psi2's backward's A and B (kp): 2q + 2 rounded up to 8."""
    return -(-(2 * q + 2) // 8) * 8


def psi2_bwd_blocks_per_sm(q: int) -> int:
    """Blocks an SM of psi2's backward tile kernel: two (128 registers)
    while A and B fit one chunk (q <= 15), one past it (WIDE)."""
    return 2 if psi2_bwd_width(q) <= BWD_CHUNK else 1


def psi2_bwd_smem_bytes() -> int:
    """Shared memory of one psi2 backward block (``smem_elems`` in the
    source), any q: A's chunk tile (64 x 36), B's chunk and F (32 and 64
    rows x 68), Q's two row halves (64 x 34 each), the pairs' g sf2^2
    and sum F, the rows' weights."""
    pt = BWD_PATCH ** 2
    return 8 * (BWD_ROWS * (BWD_CHUNK + 4) + (BWD_CHUNK + BWD_ROWS) * (pt + 4)
                + 2 * pt * (BWD_CHUNK + 2) + 2 * pt + BWD_ROWS)


@functools.lru_cache(maxsize=256)
def psi2_bwd_plan(n: int, m: int, slots: int) -> tuple[int, int, int, int]:
    """psi2's backward work split: (blocks, row tiles a block touches at
    most, items, patches).  The items are (64-row tile, 8 x 8-point
    upper patch) pairs, row tile major, patches row-major over the
    ceil(m / 8) point blocks; block b takes items ``b * items // blocks``
    up to ``(b + 1) * items // blocks``, with blocks = ``slots`` (the
    SMs times ``psi2_bwd_blocks_per_sm``), at most one an item and at
    least one (an empty n still zeroes its partials)."""
    nb = -(-m // BWD_PATCH)
    patches = nb * (nb + 1) // 2
    items = -(-n // BWD_ROWS) * patches
    blocks = max(1, min(slots, items))
    per = -(-items // blocks)
    return blocks, (per + patches - 2) // patches + 1 if items else 0, \
        items, patches


def psi2_bwd_scratch_len(n: int, m: int, q: int, blocks: int,
                         row_tiles: int) -> int:
    """f64 elements of psi2's backward scratch (the launcher's layout, each
    region rounded up to 4 elements): the hyper-parameters (1 + 3q),
    centred z (m q), A (64 ceil(n / 64) rows x kp), each patch slot's
    g_p sf2^2 and static term (2 x patches x 64), the blocks' H partials
    (blocks x row_tiles x 2 x 64 x kp), their d z and d log_ell partials
    (blocks x (m + 8) q) and the rows' terms (n (q + 1))."""
    kp = psi2_bwd_width(q)
    nb = -(-m // BWD_PATCH)
    patches = nb * (nb + 1) // 2
    regions = (1 + 3 * q, m * q, -(-n // BWD_ROWS) * BWD_ROWS * kp,
               patches * BWD_PATCH ** 2, patches * BWD_PATCH ** 2,
               blocks * row_tiles * 2 * BWD_ROWS * kp, blocks * m * q,
               blocks * BWD_PATCH * q, n * (q + 1))
    return sum(-(-r // 4) * 4 for r in regions)


def psi2_bwd(mu, s, w, z, g, log_sf2, log_ell, blocks, row_tiles, flags,
             scratch, dz, dell, dsf2, dmu, ds, dw) -> None:
    """Launch psi2's backward for mu's dtype on the current stream (the
    rows' A, the tile pass, the row outputs where ``flags`` (1 mu, 2 s,
    4 w) asks, and the fixed-order reduce); log_sf2 and log_ell in f64,
    the scratch of :func:`psi2_bwd_scratch_len`."""
    name, fn = _fn("psi2_bwd", mu.dtype, [_P] * 7 + [_I] * 6 + [_P] * 8,
                   lib="psi2_bwd")
    n, q = mu.shape
    err = fn(mu.data_ptr(), s.data_ptr(), w.data_ptr(), z.data_ptr(),
             g.data_ptr(), log_sf2.data_ptr(), log_ell.data_ptr(), n,
             z.shape[0], q, blocks, row_tiles, flags, scratch.data_ptr(),
             dz.data_ptr(), dell.data_ptr(), dsf2.data_ptr(), dmu.data_ptr(),
             ds.data_ptr(), dw.data_ptr(), _build.stream_handle(mu.device))
    _build.check(name, err)


# -- psi1's backward: csrc/psi1_bwd.cu ---------------------------------------

SM_SMEM = 233_472   # shared memory of one sm_90 SM


def psi1_bwd_smem_bytes(m: int, q: int, dtype) -> int:
    """Dynamic shared memory of one psi1 backward block (``smem_elems`` in
    the source): the E tile of P1_ROWS rows by min(m, P1_COLS) columns (row
    stride 8 mod 16), with q <= FEATURES (staged) z of a tile and the rows'
    mu, s, 1/(l^2 + s) and l^2; the log-normalisers, the rows' terms of
    d log_ell and the rows' sums of E, E r and E r^2."""
    item = dtype.itemsize
    nc = min(m, P1_COLS)
    ld = (nc + 7) // 16 * 16 + 8
    qp = FEATURES + 1
    staged = (nc * qp + 3 * P1_ROWS * qp + FEATURES) if q <= FEATURES else 0
    return item * (P1_ROWS * ld + staged + 2 * P1_ROWS + 3 * P1_ROWS * qp)


def psi1_bwd_blocks_per_sm(m: int, q: int, dtype) -> int:
    """Blocks of psi1's backward an SM holds: two (its registers allow
    two) where two blocks' shared memory fits, beside each block's 1 KB
    reserve and exp table."""
    return 2 if 2 * (psi1_bwd_smem_bytes(m, q, dtype) + 1536) <= SM_SMEM else 1


def psi1_bwd_plan(n: int, slots: int) -> tuple[int, int]:
    """(blocks, rows a unit) of psi1's backward: units of a multiple of 8
    rows, at most P1_ROWS, as few as fill ``slots`` blocks (the SMs times
    ``psi1_bwd_blocks_per_sm``) in one wave where n allows; one block a
    unit, at most ``slots`` (at least one, so an empty n still zeroes its
    partials); block b takes units b, b + blocks, ..."""
    per = -(-n // max(1, slots))
    rows = min(P1_ROWS, max(8, -(-per // 8) * 8))
    return max(1, min(-(-n // rows), slots)), rows


def psi1_bwd(mu, s, z, log_sf2, log_ell, g, n_blocks, rows, flags, scratch,
             dz, dell, dsf2, dmu, ds) -> None:
    """Launch psi1's backward for mu's dtype on the current stream (the
    unit pass, then the fixed-order reduce); the scratch holds the blocks'
    partials (``n_blocks`` (m + 1) q + ``n_blocks`` f64); dmu, ds are
    written only where ``flags`` (1 mu, 2 s) asks."""
    name, fn = _fn("psi1_bwd", mu.dtype, [_P] * 6 + [_I] * 6 + [_P] * 7,
                   lib="psi1_bwd")
    n, q = mu.shape
    err = fn(mu.data_ptr(), s.data_ptr(), z.data_ptr(), log_sf2.data_ptr(),
             log_ell.data_ptr(), g.data_ptr(), n, z.shape[0], q, n_blocks,
             rows, flags, scratch.data_ptr(), dz.data_ptr(), dell.data_ptr(),
             dsf2.data_ptr(), dmu.data_ptr(), ds.data_ptr(),
             _build.stream_handle(mu.device))
    _build.check(name, err)
