"""Where a backward kernel's time goes: ablations on the card, beside the
previous design's kernel.

    python3 tools/bwd_ablation.py [--kernel reg_stats|reg_stats_fwd|psi2|psi1]
                                  [--parent FILE | --parent-rev REV]

Builds variants of the kernel's source (``SOURCES``), each the source
with one part removed by text substitution (``VARIANTS``), with ``nvcc``
and the repo's flags into a temporary directory outside the checkout, all
started together; the previous design's source (``--parent FILE``, or
``git show REV:<source>``, default ``HEAD~``) is built beside them and
timed on its own launch arguments.  Each bare launch (the kernel module's
launcher on the arguments the ops module makes once) is timed by CUDA
events (median of 10), in turns: the parent and the whole kernel first
and last.  A variant without a part computes wrong gradients; only its
time is read.  The parent's gradients are held against the new kernel's
(f64 normwise 1e-8).  Prints one JSON line a dtype, and the card's name
and power limit.

- ``reg_stats`` (default): ``csrc/reg_stats_bwd.cu`` at ``sgpr-synth-1m``
  (n 1e6, m 512, q 8, d 4; the SGPR's gradients: hyper-parameters and z);
  the variants without the epilogue (skipped at run time), the build of
  the own knm tile, the DMMA / FMA product, the copies of the other
  blocks' slabs through distributed shared memory, S's rows after the
  first step; build and product both; all but the products.  The parent:
  the previous design (the same C interface), on its own cluster
  slots.
- ``reg_stats_fwd``: ``csrc/reg_stats.cu``'s f64 kernel at
  ``sgpr-synth-1m`` and at 3e's blocks (n 2,048, m 64, q 8, d 1), by
  events and from a CUDA graph; the variants without the build of the
  chunk's own band, without the DMMA products of the warps' tasks,
  without the copies of the other bands through distributed shared
  memory, without the cluster barrier a chunk (kept around the first and
  the last), with libdevice's exp, and with only the products.  The parent: the
  per-tile design (one block an (n-slice, upper 128-tile) unit over the
  SMs).
- ``psi2``: ``csrc/psi2_bwd.cu`` at ``gplvm-usps`` (n 4,649, m 150, q 10;
  the GPLVM's gradients: hyper-parameters, z, mu and s); the variants
  without the exp, without each of the three products (E, H, Q), without
  the point pass (skipped at run time), and with only the products.  The
  parent: one block a slice of rows against every upper 64 x 64 tile, z
  zero-padded, the hyper-parameters as [sf2^2, l^2].  Each launch is also
  timed from a CUDA graph of 20 (``device_ms``, the card's time alone).
- ``psi1``: ``csrc/psi1_bwd.cu`` at ``gplvm-usps`` (d mu and d s too);
  the whole kernel beside the parent (fixed 32-row units, one block an
  SM), also from a CUDA graph.

On the card there is no git: write the parent's source into ``build/``
first (``git show HEAD~:<source> > build/parent.cu``) and pass
``--parent build/parent.cu``.
"""
import argparse
import contextlib
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.psi_stats import kernel as ps_k  # noqa: E402
from repro_torch.kernels.psi_stats import ops as ps_ops  # noqa: E402
from repro_torch.kernels.reg_stats import kernel as rs_k  # noqa: E402
from repro_torch.kernels.reg_stats import ops as rs_ops  # noqa: E402

SOURCES = {"reg_stats": "src/repro_torch/csrc/reg_stats_bwd.cu",
           "reg_stats_fwd": "src/repro_torch/csrc/reg_stats.cu",
           "psi2": "src/repro_torch/csrc/psi2_bwd.cu",
           "psi1": "src/repro_torch/csrc/psi1_bwd.cu"}
_SKIP = "      if (b >= nts) continue;\n"
RS_VARIANTS = {
    "full": [],
    # the epilogue skipped at run time (flags is never negative), the
    # products' sums kept live; with its code removed instead, ptxas drops
    # the products whose sums nothing reads
    "no_epilogue": [(_SKIP, "      if (b >= nts || flags >= 0) {\n        if (acc[0] == "
                     "T(-1.25e30)) part_sf2[blk] += 1.0;\n        continue;\n      }\n")],
    "no_build": [("        if (tk < nts) build(row0, tk);\n", "")],
    "no_product": [("              product(acc, as, srow + c % SS * KS * LDS, kgrp, h, tid);\n",
                    "")],
    "no_dsmem": [("              if (remote) load_slab(rv, pn, h);\n", ""),
                 ("              if (remote) store_slab(an, rv, h);\n", "")],
    # S's rows never loaded after the first step (the products read stale
    # rows): the k-loop without its L2 traffic
    "no_s_rows": [("            if (next) fetch_s(srow + (c + 1) % SS * KS * LDS, gp0 + pn, b0);\n",
                   "")],
}
RS_VARIANTS["epilogue_only"] = RS_VARIANTS["no_build"] + RS_VARIANTS["no_product"]
# the k-loop's products and barriers alone
RS_VARIANTS["product_only"] = (RS_VARIANTS["no_epilogue"] + RS_VARIANTS["no_build"]
                               + RS_VARIANTS["no_dsmem"] + RS_VARIANTS["no_s_rows"])
_EXP = [("gst[p] * exp_pair(e[nt][i], e2f)", "gst[p] * e[nt][i]"),
        ("gst[p + 1] * exp_pair(e[nt][i + 1], e2f)", "gst[p + 1] * e[nt][i + 1]")]
# the point pass skipped at run time (n is never negative): Q is still
# stored to shared memory, so its product stays
_POINTS = [("      if (f < q && point < m && (side == 0 || !diag)) {",
            "      if (f < q && point < m && (side == 0 || !diag) && n < 0) {")]
PSI2_VARIANTS = {
    "full": [],
    "no_exp": _EXP,
    "no_e_product": [("            dmma(e[nt], a0, a1, bs[(k0 + t4) * LDB + wp + (nh * NE + nt) * 8 + g8]);\n",
                      "            {}\n")],
    "no_h_product": [("              dmma(hacc[hn], e[nt][0], e[nt][2], b[0]);\n", ""),
                     ("              dmma(hacc[hn], e[nt][1], e[nt][3], b[1]);\n", "")],
    "no_q_product": [("          if (!WIDE || qn * 8 < kw) dmma(qa[qn], a0, a1, as[r * LDA + qn * 8 + g8]);\n",
                      "          {}\n")],
    "no_point_pass": _POINTS,
    "products_only": _EXP + _POINTS,
}
# The forward's cluster kernel: its parts removed in the chunk loop (the
# prologue still builds and copies chunks 0 and 1)
_FWD_BUILD = [("      if (next2 && (g & 1)) build(c + 2, g >> 1);\n", "")]
_FWD_COPY = [("      if (more && g > 0) copy_load(v, g);\n", ""),
             ("        if (more) copy_load(v, 0);\n", ""),
             ("      if (more) copy_store(v, c + 1, g);\n", "")]
FWD_VARIANTS = {
    "full": [],
    "no_build": _FWD_BUILD,
    # the warps' tasks skipped at run time (n is never negative), their
    # sums kept live
    "no_product": [("    if (kind == 1) rect_step(", "    if (kind == 1 && n < 0) rect_step("),
                   ("    else if (kind == 2) stair_step(", "    else if (kind == 2 && n < 0) stair_step(")],
    "no_dsmem": _FWD_COPY,
    # the cluster barrier only around the first and the last chunk (the
    # copies race; no block leaves while another may read its band)
    "no_cluster_barrier": [("        cluster_wait();  // the others'",
                            "        if (c == 0) cluster_wait();  // the others'"),
                           ("    cluster_arrive();  // built c + 2",
                            "    if (c + 1 == n_chunks) cluster_arrive();  // built c + 2")],
    "libdevice_exp": [("ob[(rb + u) * LDB + i] = kexp(sf2, s[u], e2f);",
                       "ob[(rb + u) * LDB + i] = sf2 * exp(-0.5 * s[u]);")],
    "product_only": _FWD_BUILD + _FWD_COPY,
}
VARIANTS = {"reg_stats": RS_VARIANTS, "reg_stats_fwd": FWD_VARIANTS,
            "psi2": PSI2_VARIANTS, "psi1": {"full": []}}
FWD_SHAPES = [(1_000_000, 512, 8, 4), (2_048, 64, 8, 1)]   # sgpr-synth-1m; 3e's blocks
USPS = (4649, 150, 10)   # gplvm-usps: n, m, q


def build_variants(source: str, variants: dict, parent_src: str,
                   out: pathlib.Path) -> dict:
    """Each variant's library and the parent's, compiled in parallel."""
    src = (ROOT / source).read_text()
    texts = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    texts["parent"] = parent_src
    jobs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def _c_fn(lib, name, dtype, n_ptr, n_int, n_ptr2):
    fn = getattr(lib, name + ("_f64" if dtype == torch.float64 else "_f32"))
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * n_ptr2)
    fn.restype = ctypes.c_int
    return fn


def rs_parent_launch(lib, args, dtype):
    """The previous reg_stats backward design's launch (clusters of
    min(m/128, 8) blocks sharing knm) on the new arguments' operands: the same C interface (it reads hp's
    first 2 + q entries), its own cluster slots and scratch; returns
    (launch, its outputs)."""
    (x, y, w, zp, sp, gcp, hp, m, *_rest) = args
    n, q = x.shape
    mp, d = zp.shape[0], y.shape[1]
    f64, dev = torch.float64, x.device
    clusters = getattr(lib, "reg_stats_bwd_clusters" + (
        "_f64" if dtype == torch.float64 else "_f32"))
    clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    clusters.restype = ctypes.c_int
    slots = ctypes.c_int(0)
    _build.check("parent clusters", clusters(m, q, ctypes.byref(slots)))
    n_slices, per = rs_k.bwd_plan(n, max(1, slots.value))
    width = rs_k.bwd_cluster(m)[0]
    scratch = [torch.empty(sh, dtype=f64, device=dev)
               for sh in ((n_slices, mp, q), (n_slices * width, q),
                          (n_slices * width,))]
    outs = [torch.empty(sh, dtype=f64, device=dev) for sh in ((m, q), (q,), ())]
    rows = [torch.empty((0,), dtype=dtype, device=dev) for _ in range(6)]
    fn = _c_fn(lib, "reg_stats_bwd", dtype, 7, 8, 13)
    ptrs = [t.data_ptr() for t in (x, y, w, zp, sp, gcp, hp)]

    def launch():
        err = fn(*ptrs, n, m, q, d, mp, n_slices, per, 0,
                 *(t.data_ptr() for t in (*scratch, *outs, *rows)),
                 _build.stream_handle(dev))
        _build.check("parent reg_stats_bwd", err)
    launch.keep = scratch + rows
    return launch, outs


def psi2_parent_launch(lib, kin, g, flags, dtype):
    """The previous psi2 design's launch (one block a slice of rows, as
    many slices as SMs, every upper 64 x 64 tile; z zero-padded, hp =
    [sf2^2, l^2] in the dtype); returns (launch, its outputs dz, dell,
    dsf2, dmu, ds)."""
    log_sf2, log_ell, z, mu, s, w = kin
    n, q = mu.shape
    m = z.shape[0]
    f64, dev = torch.float64, mu.device
    mp = -(-m // 64) * 64
    zp = torch.zeros((mp, q), dtype=dtype, device=dev)
    zp[:m] = z
    hp = torch.cat([torch.exp(2.0 * log_sf2).reshape(1),
                    torch.exp(2.0 * log_ell)]).to(dtype).contiguous()
    per = max(1, -(-n // _build.sm_count(dev)))
    n_slices = max(1, -(-n // per))
    scratch = [torch.empty((n,), dtype=dtype, device=dev),
               torch.empty((n, q), dtype=dtype, device=dev),
               torch.empty((n, 2 + 2 * q), dtype=f64, device=dev),
               torch.empty((n_slices, mp, q), dtype=f64, device=dev),
               torch.empty((n_slices, q), dtype=f64, device=dev)]
    outs = [torch.empty(sh, dtype=f64, device=dev) for sh in ((m, q), (q,), ())]
    rows = [torch.empty((n, q) if flags & 1 else (0,), dtype=dtype, device=dev),
            torch.empty((n, q) if flags & 2 else (0,), dtype=dtype, device=dev),
            torch.empty((0,), dtype=dtype, device=dev)]
    fn = _c_fn(lib, "psi2_bwd", dtype, 6, 6, 12)
    ptrs = [t.data_ptr() for t in (mu, s, w, zp, g, hp)]

    def launch():
        err = fn(*ptrs, n, m, q, n_slices, per, flags,
                 *(t.data_ptr() for t in (*scratch, *outs, *rows)),
                 _build.stream_handle(dev))
        _build.check("parent psi2_bwd", err)
    return launch, outs + rows[:2]


def psi1_parent_launch(lib, kin, g, flags, dtype):
    """The previous psi1 design's launch (32-row units, at most one block
    an SM, its three partials allocated apart); returns (launch, its
    outputs dz, dell, dsf2, dmu, ds)."""
    log_sf2, log_ell, z, mu, s = kin
    n, q = mu.shape
    m = z.shape[0]
    f64, dev = torch.float64, mu.device
    n_blocks = max(1, min(-(-n // 32), _build.sm_count(dev)))
    scratch = [torch.empty(sh, dtype=f64, device=dev)
               for sh in ((n_blocks, m, q), (n_blocks, q), (n_blocks,))]
    outs = [torch.empty(sh, dtype=f64, device=dev) for sh in ((m, q), (q,), ())]
    rows = [torch.empty((n, q) if flags & f else (0,), dtype=dtype, device=dev)
            for f in (1, 2)]
    ops = [t.to(dtype) for t in (mu, s, z, log_sf2, log_ell, g)]
    fn = _c_fn(lib, "psi1_bwd", dtype, 6, 5, 9)

    def launch():
        err = fn(*(t.data_ptr() for t in ops), n, m, q, n_blocks, flags,
                 *(t.data_ptr() for t in (*scratch, *outs, *rows)),
                 _build.stream_handle(dev))
        _build.check("parent psi1_bwd", err)
    return launch, outs + rows


def rs_fwd_parent_launch(lib, x, y, w, z, log_sf2, log_ell):
    """The previous forward design's f64 launch: one block an (n-slice,
    upper 128-tile) unit over the card's SMs (``_build.fill_plan``), its
    own scratch; returns (launch, its outputs D, C, b)."""
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    f64, dev = torch.float64, x.device
    hp = torch.cat([torch.exp(log_sf2).reshape(1),
                    torch.exp(-2.0 * log_ell)]).contiguous()
    n_tiles, n_slices, per = _build.fill_plan(n, m, _build.sm_count(dev),
                                              rs_k.TILE, rs_k.ROWS)
    part_d = torch.empty((n_slices, n_tiles, rs_k.TILE, rs_k.TILE), dtype=f64,
                         device=dev)
    keep = [hp, part_d, torch.empty_like(part_d),
            torch.empty((n_slices, -(-m // rs_k.TILE) * rs_k.TILE, d),
                        dtype=f64, device=dev),
            torch.empty((n_slices,), dtype=f64, device=dev)]
    outs = [torch.empty(sh, dtype=f64, device=dev) for sh in ((m, m), (m, d), ())]
    fn = _c_fn(lib, "reg_stats", torch.float64, 5, 6, 8)

    def launch():
        err = fn(*(t.data_ptr() for t in (x, y, w, z, hp)), n, m, q, d,
                 n_slices, per, *(t.data_ptr() for t in (*keep[1:], *outs)),
                 _build.stream_handle(dev))
        _build.check("parent reg_stats_f64", err)
    launch.keep = keep   # the scratch lives as long as the launch
    return launch, outs


def run_reg_stats_fwd(libs, variants):
    """The f64 forward at sgpr-synth-1m and at 3e's 2,048-row blocks (m
    64): the parent, the kernel and its variants by events and from a CUDA
    graph, in turns; the kernel's D, C, b against the parent's."""
    dev = torch.device("cuda")
    order = ["parent", "full", *(v for v in variants if v != "full"), "full",
             "parent"]
    for n, m, q, d in FWD_SHAPES:
        rng = np.random.default_rng(0)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)
        log_sf2, log_ell = t(0.3), t(np.full(q, 0.5 * np.log(q)))
        z, x, y = (t(rng.uniform(-2, 2, sh)) for sh in ((m, q), (n, q), (n, d)))
        w = torch.ones(n, dtype=torch.float64, device=dev)
        kargs = rs_ops.launch_args(log_sf2, log_ell, z, x, y, w)
        parent, parent_out = rs_fwd_parent_launch(libs["parent"], x, y, w, z,
                                                  log_sf2, log_ell)
        timed = {"parent": (parent, None)}
        for name in variants:
            timed[name] = (lambda: rs_k.reg_stats(*kargs), libs[name])
        times, device = {}, {}
        in_turns(order, timed, times)
        in_turns(order, timed, device, lambda fn: graph_ms(fn, launches=4))
        in_turns(["full"], timed, {})
        parent()
        torch.cuda.synchronize()
        rel = rel_to_parent(kargs[-3:], parent_out)
        if max(rel) > 1e-10:
            raise SystemExit(f"the new kernel and the parent differ: {rel}")
        print(json.dumps({"kernel": "reg_stats_f64", "shape": dict(n=n, m=m, q=q, d=d),
                          "slices": kargs[5], "ms": times, "device_ms": device,
                          "rel_to_parent": rel}), flush=True)


def time_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches=20) -> float:
    """One call's device time: ``launches`` calls replayed from a CUDA
    graph, per call."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay) / launches


def parent_source(args) -> str:
    if args.parent:
        return pathlib.Path(args.parent).read_text()
    return subprocess.run(["git", "show", f"{args.parent_rev}:{SOURCES[args.kernel]}"],
                          cwd=ROOT, check=True, capture_output=True,
                          text=True).stdout


def rel_to_parent(new, parent):
    return [float(torch.linalg.vector_norm(a.double() - b.double())
                  / torch.linalg.vector_norm(b.double()).clamp_min(1e-300))
            for a, b in zip(new, parent)]


def in_turns(order, timed, times, timer=time_ms):
    """Time ``timed[name] = (launch, library or None)`` in ``order``; a
    variant's launch runs with ``_build.load`` returning its library."""
    for name in order:
        fn, lib = timed[name]
        with (mock.patch.object(_build, "load", lambda _, lib=lib: lib) if lib
              else contextlib.nullcontext()):
            times.setdefault(name, []).append(timer(fn))


def run_reg_stats(libs, variants):
    n, m, q, d = 1_000_000, 512, 8, 4
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    ins = [t(0.3), t(np.full(q, 0.5 * np.log(q))), t(rng.uniform(-2, 2, (m, q))),
           t(rng.uniform(-2, 2, (n, q))), t(rng.standard_normal((n, d))),
           torch.ones(n, dtype=torch.float64, device=dev)]
    cts = [t(rng.standard_normal(sh)) for sh in ((), (m, d), (m, m))]
    order = ["parent", "full", *(v for v in variants if v != "full"), "full",
             "parent"]
    for dtype in (torch.float64, torch.float32):
        kin = ins[:2] + [v.to(dtype) for v in ins[2:]]
        kargs = rs_ops.bwd_launch_args(
            *kin, *(c.to(dtype) for c in cts), 0,
            rs_k.bwd_slots(dtype, m, q, dev))
        parent, parent_out = rs_parent_launch(libs["parent"], kargs, dtype)
        timed = {"parent": (parent, None)}
        for name in variants:
            timed[name] = (lambda: rs_k.reg_stats_bwd(*kargs), libs[name])
        times = {}
        in_turns(order, timed, times)
        in_turns(["full"], timed, {})
        parent()
        torch.cuda.synchronize()
        rel = rel_to_parent(kargs[-9:-6], parent_out)
        if dtype == torch.float64 and max(rel) > 1e-8:
            raise SystemExit(f"the new kernel and the parent differ: {rel}")
        print(json.dumps({"kernel": "reg_stats_bwd", "dtype": str(dtype),
                          "shape": dict(n=n, m=m, q=q, d=d), "ms": times,
                          "rel_to_parent": rel}), flush=True)


def run_psi(kernel, libs, variants):
    """psi2's or psi1's backward at gplvm-usps, f64 and f32: each variant
    and the parent by events (``ms``) and from a CUDA graph
    (``device_ms``), in turns."""
    n, m, q = USPS
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    ins = [t(rng.uniform(-0.5, 0.8)), t(np.full(q, 0.5 * np.log(q))),
           t(rng.standard_normal((m, q))), t(rng.standard_normal((n, q))),
           t(rng.uniform(0.05, 1.0, (n, q)))]
    if kernel == "psi2":
        ins.append(torch.ones(n, dtype=torch.float64, device=dev))
        g64 = t(rng.standard_normal((m, m)))
    else:
        g64 = t(rng.standard_normal((n, m)))
    flags = 3   # d mu and d s, as the GPLVM takes them
    order = ["parent", "full", *(v for v in variants if v != "full"), "full",
             "parent"]
    sms = _build.sm_count(dev)
    for dtype in (torch.float64, torch.float32):
        kin = ins[:2] + [v.to(dtype) for v in ins[2:]]
        g = g64.to(dtype)
        if kernel == "psi2":
            kargs = ps_ops.psi2_bwd_launch_args(*kin, g, flags, sms)
            launcher, outs = ps_k.psi2_bwd, kargs[-6:-1]
            parent, parent_out = psi2_parent_launch(libs["parent"], kin, g,
                                                    flags, dtype)
        else:
            kargs = ps_ops.psi1_bwd_launch_args(*kin, g, flags, sms)
            launcher, outs = ps_k.psi1_bwd, kargs[-5:]
            parent, parent_out = psi1_parent_launch(libs["parent"], kin, g,
                                                    flags, dtype)
        timed = {"parent": (parent, None)}
        for name in variants:
            timed[name] = (lambda: launcher(*kargs), libs[name])
        times, device = {}, {}
        in_turns(order, timed, times)
        in_turns(order, timed, device, graph_ms)
        in_turns(["full"], timed, {})
        parent()
        torch.cuda.synchronize()
        rel = rel_to_parent(outs, parent_out)
        if dtype == torch.float64 and max(rel) > 1e-8:
            raise SystemExit(f"the new kernel and the parent differ: {rel}")
        print(json.dumps({"kernel": f"{kernel}_bwd", "dtype": str(dtype),
                          "shape": dict(n=n, m=m, q=q), "ms": times,
                          "device_ms": device, "rel_to_parent": rel}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="reg_stats")
    ap.add_argument("--parent", help="the previous design's source file")
    ap.add_argument("--parent-rev", default="HEAD~",
                    help="git revision of the previous design (no --parent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    out = pathlib.Path(tempfile.mkdtemp(prefix="bwd_ablation_"))
    variants = VARIANTS[args.kernel]
    libs = build_variants(SOURCES[args.kernel], variants, parent_source(args),
                          out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.kernel == "reg_stats":
        run_reg_stats(libs, variants)
    elif args.kernel == "reg_stats_fwd":
        run_reg_stats_fwd(libs, variants)
    else:
        run_psi(args.kernel, libs, variants)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
