"""The port's host streaming (``repro_torch.data.stream``, ``flight_like``,
the ``streamed_*`` methods of ``DistributedGP``, ``predict_stream``)
against the JAX package's, mirroring ``tests/test_stream_ingest.py``.

The streaming contract is bitwise: ``BlockStream`` chunks carry every
shard's blocks in the in-memory order and the carry threads into the same
fold, so the port's streamed Stats, bound and predictive state equal its
in-memory engine's to the last bit; against JAX's engine they agree to
1e-12 (Stats, bound) and 1e-10 (state).  Gradients take a second pass that
reassociates sums: 1e-8 relative (rtol 1e-8 / atol 1e-10).  The host
layout (``BlockStream.chunk``) and ``flight_like`` are numpy copies and
match JAX's bitwise.  4 spawned gloo ranks, each reading only its own
rows, stream against JAX's engine on 4 placeholder devices.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.distributed import DistributedGP as JDistributedGP
from repro.data import stream as jstream
from repro.data.synthetic import flight_like as j_flight_like
from repro.launch.mesh import make_compat_mesh
from repro_torch.core.distributed import DistributedGP
from repro_torch.data.stream import (ArraySource, BlockStream, MemmapSource,
                                     SyntheticSource, as_source,
                                     open_npz_memmaps, padded_rows, prefetch,
                                     stage_to_device)
from repro_torch.data.synthetic import flight_like
from test_torch_spawn import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATE_FIELDS = ("chol_kmm", "chol_sigma", "c2", "a_mean", "g")


def _hyp(q):
    return {"log_sf2": torch.tensor(0.2, dtype=torch.float64),
            "log_ell": torch.full((q,), 0.1, dtype=torch.float64),
            "log_beta": torch.tensor(1.0, dtype=torch.float64)}


def _jhyp(q):
    return {"log_sf2": jnp.asarray(0.2), "log_ell": jnp.full((q,), 0.1),
            "log_beta": jnp.asarray(1.0)}


def _mk_data(rng, n, q=2, d=2, latent=False):
    arrs = {"mu": rng.standard_normal((n, q)),
            "y": rng.standard_normal((n, d))}
    if latent:
        arrs["s"] = rng.uniform(0.05, 0.6, (n, q))
    return arrs


@pytest.fixture(scope="module")
def eng8():
    return DistributedGP(chunk_size=8, device="cpu")


def _assert_stats_bitwise(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _inmem_reference(eng, hyp, z, arrs, d, fmask=None, n_full=None):
    data, w = eng.put_data(**arrs)
    fm = np.ones((eng.n_shards,)) if fmask is None else fmask
    st = eng.reduced_stats(d)(hyp, z, data["y"], data["mu"], data.get("s"),
                              w, fm)
    b = eng.bound_fn(d)(hyp, z, data["y"], data["mu"], data.get("s"), w, fm,
                        float(arrs["y"].shape[0]) if n_full is None
                        else n_full)
    return data, w, st, b


# -- sources --------------------------------------------------------------------

def test_array_source_validates_and_reads(rng):
    arrs = _mk_data(rng, 11)
    src = ArraySource(arrs)
    assert src.n == 11 and src.fields == {"mu": (2,), "y": (2,)}
    np.testing.assert_array_equal(src.read(3, 9)["y"], arrs["y"][3:9])
    with pytest.raises(ValueError):
        ArraySource({"a": np.ones((5, 2)), "b": np.ones((6, 2))})
    with pytest.raises(ValueError):
        ArraySource({})


def test_memmap_source_npy_roundtrip(rng, tmp_path):
    arrs = _mk_data(rng, 23)
    paths = {}
    for k, v in arrs.items():
        paths[k] = tmp_path / f"{k}.npy"
        np.save(paths[k], v)
    src = MemmapSource(paths)
    assert src.n == 23
    out = src.read(5, 18)
    for k in arrs:
        np.testing.assert_array_equal(out[k], arrs[k][5:18])
        assert isinstance(out[k], np.ndarray)


def test_npz_memmap_zero_copy(rng, tmp_path):
    """Uncompressed npz members are mapped in place through their zip
    offsets, as JAX's are; compressed ones load in full."""
    arrs = _mk_data(rng, 17)
    np.savez(tmp_path / "data.npz", **arrs)
    mm = open_npz_memmaps(tmp_path / "data.npz")
    ref = jstream.open_npz_memmaps(tmp_path / "data.npz")
    for k in arrs:
        assert isinstance(mm[k], np.memmap) and mm[k].offset == ref[k].offset
        np.testing.assert_array_equal(np.asarray(mm[k]), arrs[k])
    out = MemmapSource.from_npz(tmp_path / "data.npz").read(2, 13)
    np.testing.assert_array_equal(out["mu"], arrs["mu"][2:13])
    np.savez_compressed(tmp_path / "data_c.npz", **arrs)
    mm_c = open_npz_memmaps(tmp_path / "data_c.npz")
    for k in arrs:
        np.testing.assert_array_equal(np.asarray(mm_c[k]), arrs[k])


def test_synthetic_source_pure_and_validated():
    src = SyntheticSource(100, lambda a, b: {
        "y": np.arange(a, b, dtype=np.float64)[:, None]}, fields={"y": (1,)})
    np.testing.assert_array_equal(src.read(7, 12)["y"][:, 0],
                                  np.arange(7, 12))
    bad = SyntheticSource(100, lambda a, b: {"y": np.zeros((3, 1))},
                          fields={"y": (1,)})
    with pytest.raises(ValueError):
        bad.read(0, 5)
    with pytest.raises(ValueError):
        SyntheticSource(-1, lambda a, b: {})


def test_as_source_accepts_dict_stream_and_ducks(rng):
    arrs = _mk_data(rng, 10)
    assert isinstance(as_source(arrs), ArraySource)
    src = ArraySource(arrs)
    assert as_source(src) is src
    assert as_source(BlockStream(src)) is src

    class Duck:
        n = 10
        fields = {"y": (2,)}

        def read(self, a, b):
            return {"y": np.zeros((b - a, 2))}

    duck = Duck()
    assert as_source(duck) is duck
    with pytest.raises(TypeError):
        as_source(42)


@pytest.mark.parametrize("seed", [0, 7])
def test_flight_like_matches_jax_bitwise(seed):
    """Philox advanced 4 blocks a row, exactly 16 draws a row: any window,
    and overlapping windows, give JAX's rows bit for bit."""
    mine, ref = flight_like(n=5000, seed=seed), j_flight_like(n=5000,
                                                              seed=seed)
    assert mine.n == ref.n and mine.fields == ref.fields
    for lo, hi in ((0, 1000), (4321, 5000)):
        a, b = mine.read(lo, hi), ref.read(lo, hi)
        for k in ("mu", "y"):
            np.testing.assert_array_equal(a[k], b[k])
    whole = mine.read(100, 400)
    part = mine.read(250, 300)
    for k in ("mu", "y"):
        np.testing.assert_array_equal(part[k], whole[k][150:200])


def test_padded_rows():
    assert padded_rows(10, 4) == 12
    assert padded_rows(8, 4) == 8
    assert padded_rows(1, 4) == 4
    assert padded_rows(0, 4) == 4
    for n, mult in ((0, 4), (13, 8), (64, 64)):
        assert padded_rows(n, mult) == jstream.padded_rows(n, mult)


# -- geometry -------------------------------------------------------------------

GEOMETRIES = [(101, 4, 8, 1), (101, 4, 8, 2), (64, 2, 8, 100), (5, 4, 8, 1)]


@pytest.mark.parametrize("n,n_shards,block,bpc", GEOMETRIES)
def test_blockstream_chunks_match_jax_bitwise(rng, n, n_shards, block, bpc):
    arrs = _mk_data(rng, n, latent=True)
    bs = BlockStream(ArraySource(arrs), n_shards=n_shards, block_size=block,
                     blocks_per_chunk=bpc)
    ref = jstream.BlockStream(jstream.ArraySource(arrs), n_shards=n_shards,
                              block_size=block, blocks_per_chunk=bpc)
    for attr in ("n_pad", "rows_per_shard", "blocks_per_shard",
                 "blocks_per_chunk", "n_chunks", "shard_chunk_rows",
                 "chunk_rows"):
        assert getattr(bs, attr) == getattr(ref, attr), attr
    assert len(bs) == len(ref)
    for c in range(bs.n_chunks):
        (a, w), (ra, rw) = bs.chunk(c), ref.chunk(c)
        np.testing.assert_array_equal(w, rw)
        for k in arrs:
            np.testing.assert_array_equal(a[k], ra[k])
            assert a[k].dtype == ra[k].dtype
        rows = bs.shard_chunk_rows
        for k_sh in range(n_shards):
            sa, sw = bs.shard_chunk(c, k_sh)
            np.testing.assert_array_equal(sw, w[k_sh * rows:(k_sh + 1) * rows])
            np.testing.assert_array_equal(sa["y"],
                                          a["y"][k_sh * rows:(k_sh + 1) * rows])
    with pytest.raises(IndexError):
        bs.chunk(bs.n_chunks)
    with pytest.raises(IndexError):
        bs.shard_chunk(0, n_shards)


@pytest.mark.parametrize("n,n_shards,block,bpc", GEOMETRIES)
def test_blockstream_geometry_and_coverage(rng, n, n_shards, block, bpc):
    arrs = _mk_data(rng, n)
    bs = BlockStream(ArraySource(arrs), n_shards=n_shards, block_size=block,
                     blocks_per_chunk=bpc)
    assert bs.n_pad % (n_shards * block) == 0 and bs.n_pad >= max(n, 1)
    assert bs.blocks_per_chunk <= bs.blocks_per_shard
    rows = np.zeros((bs.n_pad, 2))
    weights = np.zeros(bs.n_pad)
    rps, cr = bs.rows_per_shard, bs.shard_chunk_rows
    for c, (chunk, w) in enumerate(bs):
        for s in range(n_shards):
            lo = s * rps + c * cr
            rows[lo:lo + cr] = chunk["y"][s * cr:(s + 1) * cr]
            weights[lo:lo + cr] = w[s * cr:(s + 1) * cr]
    np.testing.assert_array_equal(rows[:n], arrs["y"])
    np.testing.assert_array_equal(weights[:n], np.ones(n))
    np.testing.assert_array_equal(weights[n:], np.zeros(bs.n_pad - n))


def test_blockstream_pads_s_log_safe(rng):
    arrs = _mk_data(rng, 5, latent=True)
    chunk, w = BlockStream(ArraySource(arrs), n_shards=2, block_size=4).chunk(0)
    pad = w == 0.0
    assert pad.any()
    np.testing.assert_array_equal(chunk["s"][pad], 1.0)
    np.testing.assert_array_equal(chunk["y"][pad], 0.0)


# -- prefetch and staging ---------------------------------------------------------

def test_prefetch_preserves_order_and_maps():
    assert list(prefetch(range(20), fn=lambda i: i * i, depth=3)) \
        == [i * i for i in range(20)]
    assert list(prefetch(iter("abc"))) == list("abc")
    with pytest.raises(ValueError):
        prefetch(range(3), depth=0)


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("source died")

    it = prefetch(gen(), fn=lambda x: x, depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source died"):
        list(it)


def test_prefetch_fn_error_reaches_a_slow_consumer():
    """The worker's error waits for the consumer, however slow: it is
    queued behind the items already staged, not dropped."""
    def boom(x):
        if x == 3:
            raise ValueError("bad chunk")
        return x

    it = prefetch(range(6), fn=boom, depth=1)
    got = [next(it)]
    time.sleep(1.5)                  # the queue is full while 3 fails
    with pytest.raises(ValueError, match="bad chunk"):
        for x in it:
            got.append(x)
    assert got == [0, 1, 2]


def test_prefetch_close_stops_the_worker():
    pulled = []

    def source():
        for i in range(1000):
            pulled.append(i)
            yield i

    before = set(threading.enumerate())
    it = prefetch(source(), depth=2)
    assert next(it) == 0
    worker, = [t for t in threading.enumerate() if t not in before
               and t.name == "repro-torch-stream-prefetch"]
    it.close()
    worker.join(timeout=5)
    assert not worker.is_alive()
    assert len(pulled) < 10


def test_stage_to_device_on_the_cpu(rng):
    arrs = _mk_data(rng, 6)
    w = np.ones(6)
    stager = stage_to_device("cpu")
    got, gw = stager.ready(stager((arrs, w)))
    assert gw.dtype == torch.float64 and torch.equal(gw, torch.ones(6,
                                                     dtype=torch.float64))
    for k in arrs:
        assert torch.equal(got[k], torch.from_numpy(arrs[k]))


# -- put_data wiring ---------------------------------------------------------------

def test_put_data_stream_wiring(rng, eng8):
    arrs = _mk_data(rng, 40)
    bs = eng8.put_data(stream=arrs, blocks_per_chunk=2)
    assert isinstance(bs, BlockStream)
    assert bs.n_shards == eng8.n_shards and bs.block_size == eng8.chunk_size
    assert eng8.open_stream(bs) is bs
    wrong = BlockStream(ArraySource(arrs), n_shards=eng8.n_shards + 1,
                        block_size=eng8.chunk_size)
    with pytest.raises(ValueError, match="geometry"):
        eng8.open_stream(wrong)
    with pytest.raises(ValueError, match="not both"):
        eng8.put_data(stream=arrs, y=arrs["y"])
    with pytest.raises(ValueError, match="requires chunk_size"):
        DistributedGP(device="cpu").put_data(stream=arrs)


# -- streamed == in-memory ------------------------------------------------------------

@pytest.mark.parametrize("n,bpc", [(100, 1), (100, 3), (5, 1), (16, 2)])
def test_streamed_stats_and_bound_bitwise(rng, eng8, n, bpc):
    q, d = 2, 2
    hyp = _hyp(q)
    arrs = _mk_data(rng, n, q=q, d=d)
    z = torch.from_numpy(rng.standard_normal((5, q)))
    _, _, st_mem, b_mem = _inmem_reference(eng8, hyp, z, arrs, d)
    bs = eng8.put_data(stream=arrs, blocks_per_chunk=bpc)
    eng8.rows_read = 0
    _assert_stats_bitwise(eng8.streamed_stats(hyp, z, bs), st_mem)
    assert eng8.rows_read == n           # one pass reads every row once
    assert float(eng8.streamed_bound(hyp, z, bs, d=d, n_full=float(n))) \
        == float(b_mem)


@pytest.mark.parametrize("latent", [False, True])
def test_streamed_stats_and_bound_match_jax(rng, latent):
    q, d, n = 2, 3, 57
    arrs = _mk_data(rng, n, q=q, d=d, latent=latent)
    z = rng.standard_normal((4, q))
    eng = DistributedGP(latent=latent, chunk_size=8, device="cpu")
    bs = eng.put_data(stream=arrs, blocks_per_chunk=2)
    st = eng.streamed_stats(_hyp(q), torch.from_numpy(z), bs)
    b = eng.streamed_bound(_hyp(q), torch.from_numpy(z), bs, d=d)
    jeng = JDistributedGP(make_compat_mesh((1,), ("data",)), latent=latent,
                          chunk_size=8)
    jbs = jeng.put_data(stream=arrs, blocks_per_chunk=2)
    jst = jeng.streamed_stats(_jhyp(q), jnp.asarray(z), jbs)
    jb = jeng.streamed_bound(_jhyp(q), jnp.asarray(z), jbs, d=d)
    for name, a, ref in zip(st._fields, st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert abs(float(b) - float(jb)) <= 1e-12 * abs(float(jb))
    if latent:
        _, _, st_mem, b_mem = _inmem_reference(eng, _hyp(q),
                                               torch.from_numpy(z), arrs, d)
        _assert_stats_bitwise(st, st_mem)
        assert float(b) == float(b_mem)


@pytest.mark.parametrize("mode", ["drop", "rescale"])
def test_streamed_fmask_and_rescale(rng, mode):
    q, d, n = 2, 2, 40
    eng = DistributedGP(chunk_size=8, failure_mode=mode, device="cpu")
    hyp = _hyp(q)
    arrs = _mk_data(rng, n, q=q, d=d)
    z = torch.from_numpy(rng.standard_normal((4, q)))
    for fm in (np.ones(1), np.zeros(1)):
        _, _, st_mem, b_mem = _inmem_reference(eng, hyp, z, arrs, d, fmask=fm)
        bs = eng.put_data(stream=arrs)
        _assert_stats_bitwise(eng.streamed_stats(hyp, z, bs, fmask=fm),
                              st_mem)
        b = eng.streamed_bound(hyp, z, bs, d=d, fmask=fm, n_full=float(n))
        assert float(b) == float(b_mem) or (np.isnan(float(b))
                                            and np.isnan(float(b_mem)))


def test_streamed_value_and_grad_f64(rng, eng8):
    q, d, n = 2, 2, 90
    hyp = _hyp(q)
    arrs = _mk_data(rng, n, q=q, d=d)
    z = rng.standard_normal((5, q))
    zt = torch.from_numpy(z)
    data, w, _, _ = _inmem_reference(eng8, hyp, zt, arrs, d)
    v_mem, g_mem = eng8.make_value_and_grad(d)(hyp, zt, data["mu"], None,
                                               data["y"], w, np.ones(1),
                                               float(n))
    bs = eng8.put_data(stream=arrs, blocks_per_chunk=2)
    v_str, g_str = eng8.streamed_value_and_grad(d)(hyp, zt, bs)
    assert float(v_str) == float(v_mem)
    pairs = [(g_str[0][k], g_mem[0][k]) for k in hyp] + [(g_str[1], g_mem[1])]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10)
    # the JAX package's streamed gradient on the same rows
    jeng = JDistributedGP(make_compat_mesh((1,), ("data",)), chunk_size=8)
    jv, (jgh, jgz) = jeng.streamed_value_and_grad(d)(
        _jhyp(q), jnp.asarray(z), jeng.put_data(stream=arrs,
                                                blocks_per_chunk=2))
    assert abs(float(v_str) - float(jv)) <= 1e-12 * abs(float(jv))
    np.testing.assert_allclose(g_str[1].numpy(), np.asarray(jgz), rtol=1e-8,
                               atol=1e-10)
    for k in jgh:
        np.testing.assert_allclose(g_str[0][k].numpy(), np.asarray(jgh[k]),
                                   rtol=1e-8, atol=1e-10)
    # a single argnum gives the bare gradient, not a tuple
    _, gz = eng8.streamed_value_and_grad(d, argnums=1)(hyp, zt, bs)
    assert torch.equal(gz, g_str[1])
    with pytest.raises(ValueError, match="argnums"):
        eng8.streamed_value_and_grad(d, argnums=(0, 2))


def test_streamed_svi_full_batch_equals_exact(rng, eng8):
    q, d, n = 2, 2, 70
    hyp = _hyp(q)
    arrs = _mk_data(rng, n, q=q, d=d)
    z = torch.from_numpy(rng.standard_normal((4, q)))
    bs = eng8.put_data(stream=arrs, blocks_per_chunk=1)
    v_svi, g_svi = eng8.streamed_svi_value_and_grad(d, bs.n_chunks)(
        hyp, z, bs, torch.Generator().manual_seed(0))
    v_ex, g_ex = eng8.streamed_value_and_grad(d)(hyp, z, bs)
    assert abs(float(v_svi) - float(v_ex)) <= 1e-12 * abs(float(v_ex))
    for a, b in zip([*g_svi[0].values(), g_svi[1]],
                    [*g_ex[0].values(), g_ex[1]]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10)
    # sampled steps: finite, replayable from a generator state, varying
    svi2 = eng8.streamed_svi_value_and_grad(d, batch_chunks=2)
    va, _ = svi2(hyp, z, bs, torch.Generator().manual_seed(1))
    vb, _ = svi2(hyp, z, bs, torch.Generator().manual_seed(1))
    vc, _ = svi2(hyp, z, bs, torch.Generator().manual_seed(2))
    assert np.isfinite(float(va)) and float(va) == float(vb)
    assert float(va) != float(vc)
    # explicit chunk indices are the generator's draw replayed
    from repro_torch.core.stats import sample_block_indices
    idx = sample_block_indices(torch.Generator().manual_seed(1), bs.n_chunks,
                               2)
    assert float(svi2(hyp, z, bs, idx.numpy())[0]) == float(va)


def test_streamed_svi_matches_jax_on_the_same_chunks(rng):
    """JAX's own chunk draw, replayed as explicit indices: the same
    reweighted value and gradient, at 1e-12 / 1e-8."""
    import jax

    from repro.core.stats import sample_block_indices as j_sample

    q, d, n = 2, 2, 100
    arrs = _mk_data(rng, n, q=q, d=d)
    z = rng.standard_normal((4, q))
    jeng = JDistributedGP(make_compat_mesh((1,), ("data",)), chunk_size=8)
    jbs = jeng.put_data(stream=arrs)
    key = jax.random.PRNGKey(4)
    jv, (jgh, jgz) = jeng.streamed_svi_value_and_grad(d, 3)(
        _jhyp(q), jnp.asarray(z), jbs, key)
    idx = np.asarray(j_sample(key, jbs.n_chunks, 3))
    eng = DistributedGP(chunk_size=8, device="cpu")
    v, (gh, gz) = eng.streamed_svi_value_and_grad(d, 3)(
        _hyp(q), torch.from_numpy(z), eng.put_data(stream=arrs), idx)
    assert abs(float(v) - float(jv)) <= 1e-12 * abs(float(jv))
    np.testing.assert_allclose(gz.numpy(), np.asarray(jgz), rtol=1e-8,
                               atol=1e-10)
    for k in jgh:
        np.testing.assert_allclose(gh[k].numpy(), np.asarray(jgh[k]),
                                   rtol=1e-8, atol=1e-10)


def test_streamed_svi_rejects_rescale():
    eng = DistributedGP(chunk_size=8, failure_mode="rescale", device="cpu")
    with pytest.raises(NotImplementedError, match="drop"):
        eng.streamed_svi_value_and_grad(1, batch_chunks=2)
    with pytest.raises(ValueError, match="batch_chunks"):
        DistributedGP(chunk_size=8, device="cpu"
                      ).streamed_svi_value_and_grad(1, batch_chunks=0)


def test_streamed_from_memmap_source(rng, eng8, tmp_path):
    q, d, n = 2, 2, 33
    arrs = _mk_data(rng, n, q=q, d=d)
    np.savez(tmp_path / "train.npz", **arrs)
    hyp = _hyp(q)
    z = torch.from_numpy(rng.standard_normal((4, q)))
    _, _, st_mem, _ = _inmem_reference(eng8, hyp, z, arrs, d)
    bs = eng8.put_data(stream=MemmapSource.from_npz(tmp_path / "train.npz"),
                       blocks_per_chunk=2)
    _assert_stats_bitwise(eng8.streamed_stats(hyp, z, bs), st_mem)


# -- serving ---------------------------------------------------------------------------

def _serve_engine(rng, n=60, m=7, q=2, d=2, block=8):
    from repro_torch.core.stats import partial_stats
    from repro_torch.serve import PredictEngine, extract_state

    hyp = _hyp(q)
    x = torch.from_numpy(rng.standard_normal((n, q)))
    y = torch.from_numpy(rng.standard_normal((n, d)))
    z = torch.from_numpy(rng.standard_normal((m, q)))
    state = extract_state(hyp, z, partial_stats(hyp, z, y, x), device="cpu")
    return PredictEngine(state, block_size=block, device="cpu")


def test_predict_stream_bitwise(rng):
    eng = _serve_engine(rng)
    batches = [rng.standard_normal((t, 2)) for t in (5, 16, 1, 0, 9)]
    outs = list(eng.predict_stream(iter(batches), include_noise=True))
    assert len(outs) == len(batches)
    for xb, (mean, var) in zip(batches, outs):
        m_ref, v_ref = eng.predict(xb, include_noise=True)
        assert mean.shape == (xb.shape[0], 2)
        assert torch.equal(mean, m_ref) and torch.equal(var, v_ref)


def test_predict_stream_raises_a_staging_error(rng):
    eng = _serve_engine(rng)
    with pytest.raises(RuntimeError):
        list(eng.predict_stream(iter([rng.standard_normal((4, 2)),
                                      rng.standard_normal((4, 3))])))


def test_streamed_predictive_state_serves(rng, eng8):
    from repro_torch.serve import PredictEngine

    q, d, n = 2, 2, 50
    hyp = _hyp(q)
    arrs = _mk_data(rng, n, q=q, d=d)
    z = torch.from_numpy(rng.standard_normal((5, q)))
    data, w, _, _ = _inmem_reference(eng8, hyp, z, arrs, d)
    state_mem = eng8.predictive_state(hyp, z, data["y"], data["mu"], None, w)
    state_str = eng8.streamed_predictive_state(
        hyp, z, eng8.put_data(stream=arrs, blocks_per_chunk=2))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state_mem, f), getattr(state_str, f)), f
    xs = rng.standard_normal((9, q))
    m0, v0 = PredictEngine(state_mem, block_size=8, device="cpu").predict(xs)
    m1, v1 = PredictEngine(state_str, block_size=8, device="cpu").predict(xs)
    assert torch.equal(m0, m1) and torch.equal(v0, v1)


# -- 4 gloo ranks streaming against JAX's engine on 4 placeholder devices --------------

N, M, Q, D, W, CHUNK, BPC = 101, 6, 2, 2, 4, 4, 2
SVI_CHUNKS = 2


def _rank_inputs():
    rng = np.random.default_rng(9)
    arrs = {"mu": rng.standard_normal((N, Q)), "y": rng.standard_normal((N, D))}
    return arrs, rng.standard_normal((M, Q))


_JAX_WORKER = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_stream as t
from repro.core import DistributedGP
from repro.core.stats import sample_block_indices
from repro.launch.mesh import make_compat_mesh

mesh = make_compat_mesh((t.W,), ("data",))
arrs, z = t._rank_inputs()
hyp = t._jhyp(t.Q)
z = jnp.asarray(z)
out = {{}}
for mode in ("drop", "rescale"):
    eng = DistributedGP(mesh, data_axes=("data",), chunk_size=t.CHUNK,
                        failure_mode=mode)
    bs = eng.put_data(stream=arrs, blocks_per_chunk=t.BPC)
    fm = jnp.asarray([1.0, 0.0, 1.0, 1.0])
    if mode == "drop":   # the Stats and the state do not see the mode
        st = eng.streamed_stats(hyp, z, bs, fmask=fm)
        for f in st._fields:
            out[f"{{mode}}/stats/{{f}}"] = np.asarray(getattr(st, f))
        ps = eng.streamed_predictive_state(hyp, z, bs)
        for f in t.STATE_FIELDS:
            out[f"{{mode}}/state/{{f}}"] = np.asarray(getattr(ps, f))
    out[f"{{mode}}/bound"] = np.asarray(eng.streamed_bound(hyp, z, bs, t.D,
                                                         fmask=fm))
    v, (gh, gz) = eng.streamed_value_and_grad(t.D)(hyp, z, bs, fmask=fm)
    out[f"{{mode}}/value"] = np.asarray(v)
    out[f"{{mode}}/gz"] = np.asarray(gz)
    for k, g in gh.items():
        out[f"{{mode}}/gh/{{k}}"] = np.asarray(g)
    if mode == "drop":
        key = jax.random.PRNGKey(2)
        out["svi/indices"] = np.asarray(sample_block_indices(
            key, bs.n_chunks, t.SVI_CHUNKS))
        v, (gh, gz) = eng.streamed_svi_value_and_grad(t.D, t.SVI_CHUNKS)(
            hyp, z, bs, key)
        out["svi/value"] = np.asarray(v)
        out["svi/gz"] = np.asarray(gz)
        for k, g in gh.items():
            out[f"svi/gh/{{k}}"] = np.asarray(g)
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_stream_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_stream") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


def _stream_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.launch import make_data_group

    group = make_data_group("cpu", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    arrs, z = _rank_inputs()
    z = torch.from_numpy(z)
    hyp = _hyp(Q)
    fm = np.array([1.0, 0.0, 1.0, 1.0])
    idx = np.load(pathlib.Path(out_dir) / "svi_indices.npy")
    out = {}
    for mode in ("drop", "rescale"):
        eng = DistributedGP(group, chunk_size=CHUNK, failure_mode=mode,
                            device="cpu")
        bs = eng.put_data(stream=arrs, blocks_per_chunk=BPC)
        eng.rows_read = 0
        b = eng.streamed_bound(hyp, z, bs, D, fmask=fm)
        out[f"{mode}/rows_read"] = eng.rows_read
        data, w = eng.put_data(**arrs)
        out[f"{mode}/bitwise_in_memory"] = float(b) == float(eng.bound_fn(D)(
            hyp, z, data["y"], data["mu"], None, w, fm, float(N)))
        if mode == "drop":   # the Stats and the state do not see the mode
            st = eng.streamed_stats(hyp, z, bs, fmask=fm)
            st_mem = eng.reduced_stats(D)(hyp, z, data["y"], data["mu"],
                                          None, w, fm)
            out["drop/bitwise_in_memory"] &= all(
                torch.equal(a, b) for a, b in zip(st, st_mem))
            for f in st._fields:
                out[f"{mode}/stats/{f}"] = getattr(st, f).numpy()
            ps = eng.streamed_predictive_state(hyp, z, bs)
            for f in STATE_FIELDS:
                out[f"{mode}/state/{f}"] = getattr(ps, f).numpy()
        out[f"{mode}/bound"] = eng.streamed_bound(hyp, z, bs, D,
                                                  fmask=fm).numpy()
        v, (gh, gz) = eng.streamed_value_and_grad(D)(hyp, z, bs, fmask=fm)
        out[f"{mode}/value"] = v.numpy()
        out[f"{mode}/gz"] = gz.numpy()
        for k, g in gh.items():
            out[f"{mode}/gh/{k}"] = g.numpy()
        if mode == "drop":
            v, (gh, gz) = eng.streamed_svi_value_and_grad(D, SVI_CHUNKS)(
                hyp, z, bs, idx)
            out["svi/value"] = v.numpy()
            out["svi/gz"] = gz.numpy()
            for k, g in gh.items():
                out[f"svi/gh/{k}"] = g.numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def stream_ranks(jax_stream_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_ranks")
    np.save(tmp / "svi_indices.npy", jax_stream_ref["svi/indices"])
    codes, _ = spawn_ranks(_stream_rank, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


@pytest.mark.parametrize("mode", ["drop", "rescale"])
def test_four_ranks_stream_against_jax(mode, stream_ranks, jax_stream_ref):
    """Each rank reads only its rows, folds them bitwise as its in-memory
    engine does, and every rank holds the same bits; against JAX: Stats
    and bound 1e-12, value 1e-12, gradient 1e-8, state 1e-10."""
    rows = [int(r[f"{mode}/rows_read"]) for r in stream_ranks]
    bs = BlockStream(ArraySource(_rank_inputs()[0]), W, CHUNK, BPC)
    real = [min(max(N - k * bs.rows_per_shard, 0), bs.rows_per_shard)
            for k in range(W)]
    assert rows == real and sum(rows) == N
    assert all(bool(r[f"{mode}/bitwise_in_memory"]) for r in stream_ranks)
    shared = [k for k in stream_ranks[0] if k.startswith((mode + "/", "svi/"))
              and not k.endswith(("rows_read", "bitwise_in_memory"))]
    for r in stream_ranks[1:]:
        for k in shared:
            np.testing.assert_array_equal(r[k], stream_ranks[0][k], err_msg=k)
    got = stream_ranks[0]
    for k in shared:
        tol = {"stats": 1e-12, "bound": 1e-12, "value": 1e-12,
               "state": 1e-10}.get(k.split("/")[1], 1e-8)
        np.testing.assert_allclose(got[k], jax_stream_ref[k], rtol=tol,
                                   atol=1e-10 if tol == 1e-8 else 1e-12,
                                   err_msg=k)
