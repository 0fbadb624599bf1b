"""ctypes binding of ``csrc/predict.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous and of one dtype
(float32 or float64); ``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

COLS = 128       # inducing points per tile (TK): g's pair tiles are COLS²
FEATURES = 16    # features of z, x and 1/ell^2 staged at a time (QC)
SMEM_MAX = 232_448   # dynamic shared memory a block may use on sm_90
#: by tile dtype: query rows per block (BT, FBT), rows of a pair tile per
#: staged chunk (HK, FHK), persistent blocks per SM
ROWS = {torch.float32: 128, torch.float64: 64}
CHUNK = {torch.float32: 16, torch.float64: 32}
BLOCKS_PER_SM = {torch.float32: 2, torch.float64: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "predict_f32", torch.float64: "predict_f64"}


def smem_bytes(m: int, q: int, dtype) -> int:
    """Dynamic shared memory one block needs (``SMEM_ELEMS``,
    ``F32_SMEM_ELEMS`` in the source): two chunks of a pair tile (row
    stride 132), the slab panel (f64: 64 rows of stride 132; f32: its
    transpose, 128 columns of stride 132), one q-chunk of z, the x rows
    (stride 17), 1/ell^2 (f32: its scaled square root) and the rows' quad
    partials of the column warps (4 f64, 2 f32); in f32 also each of the
    256 threads' 8 row sums.  The kernel streams g's tiles and stages q in
    chunks, so neither ``m`` nor ``q`` changes it."""
    rows, chunk = ROWS[dtype], CHUNK[dtype]
    ld = COLS + 4
    item = torch.empty((), dtype=dtype).element_size()
    extra = 4 * rows if dtype == torch.float64 else 2 * rows + 8 * 256
    return item * (2 * chunk * ld + rows * ld + FEATURES * COLS
                   + rows * (FEATURES + 1) + FEATURES + extra)


def pair_tiles(m: int) -> int:
    """Upper pair tiles (A <= B) of the kernel's scratch ``h``."""
    nts = -(-m // COLS)
    return nts * (nts + 1) // 2


def scratch(t: int, m: int, q: int, dtype, device):
    """The kernel's scratch: ``h``, g's pair tiles (pair_tiles(m) * COLS *
    COLS) followed by sf2 and 1/ell^2 (q + 1), and ``kscr``, each persistent
    block's slab entries of its current row block (blocks, tiles, rows,
    COLS), with ``BLOCKS_PER_SM`` blocks per SM (at most one per row
    block)."""
    sms = _build.sm_count(device)
    rows = ROWS[dtype]
    blocks = min(-(-t // rows), BLOCKS_PER_SM[dtype] * sms)
    h = torch.empty((pair_tiles(m) * COLS * COLS + q + 1,), dtype=dtype,
                    device=device)
    kscr = torch.empty((blocks, -(-m // COLS), rows, COLS), dtype=dtype,
                       device=device)
    return h, kscr


def predict(x, z, log_sf2, log_ell, a_mean, g, h, kscr, mean, quad) -> None:
    """Launch the kernels for x's dtype (pair tiles and hyper-parameters,
    then the walk) on the current stream, with scratch ``h`` and ``kscr``
    from :func:`scratch`."""
    lib = _build.load("predict")
    fn = getattr(lib, _FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                       _P, _P, _P]
        fn.restype = _I
    t, q = x.shape
    m, d = a_mean.shape
    err = fn(x.data_ptr(), z.data_ptr(), log_sf2.data_ptr(),
             log_ell.data_ptr(), a_mean.data_ptr(), g.data_ptr(), t, m, q, d,
             kscr.shape[0], h.data_ptr(),
             kscr.data_ptr(), mean.data_ptr(), quad.data_ptr(),
             _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)
