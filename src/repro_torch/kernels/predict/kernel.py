"""ctypes binding of ``csrc/predict.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous and of one dtype
(float32 or float64); ``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

ROWS = 64        # query rows per block in the CUDA source (BT)
COLS = 128       # inducing points per tile (TK): g's pair tiles are COLS²
CHUNK = 32       # rows of a pair tile per staged chunk (HK)
FEATURES = 16    # features of z, x and 1/ell^2 staged at a time (QC)
SMEM_MAX = 232_448   # dynamic shared memory a block may use on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "predict_f32", torch.float64: "predict_f64"}


def smem_bytes(m: int, q: int, dtype) -> int:
    """Dynamic shared memory one block needs (``SMEM_ELEMS`` in the
    source): two chunks of a pair tile, the slab panel, one q-chunk of z,
    the x rows, 1/ell^2 and the rows' quad partials.  The kernel streams
    g's tiles and stages q in chunks, so neither ``m`` nor ``q`` changes
    it."""
    ld = COLS + 4
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * CHUNK * ld + ROWS * ld + FEATURES * COLS
                   + ROWS * (FEATURES + 1) + FEATURES + 4 * ROWS)


def pair_tiles(m: int) -> int:
    """Upper pair tiles (A <= B) of the kernel's scratch ``h``."""
    nts = -(-m // COLS)
    return nts * (nts + 1) // 2


def scratch(t: int, m: int, dtype, device):
    """The kernel's scratch: ``h``, g's pair tiles (pair_tiles(m), COLS,
    COLS), and ``kscr``, each persistent block's slab entries of its
    current row block (blocks, tiles, ROWS, COLS), with one block per SM
    (at most one per row block)."""
    sms = _build.sm_count(device)
    blocks = min(-(-t // ROWS), sms)
    h = torch.empty((pair_tiles(m), COLS, COLS), dtype=dtype, device=device)
    kscr = torch.empty((blocks, -(-m // COLS), ROWS, COLS), dtype=dtype,
                       device=device)
    return h, kscr


def predict(x, z, hp, a_mean, g, h, kscr, mean, quad) -> None:
    """Launch the instantiation for x's dtype on the current stream, with
    scratch ``h`` and ``kscr`` from :func:`scratch`."""
    lib = _build.load("predict")
    fn = getattr(lib, _FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P, _P]
        fn.restype = _I
    t, q = x.shape
    m, d = a_mean.shape
    err = fn(x.data_ptr(), z.data_ptr(), hp.data_ptr(), a_mean.data_ptr(),
             g.data_ptr(), t, m, q, d, kscr.shape[0], h.data_ptr(),
             kscr.data_ptr(), mean.data_ptr(), quad.data_ptr(),
             _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)
