"""ctypes wrapper for the native read-threading graph construction.

Conformance spec: assembly/graph.py::ReadThreadingGraph.build
(read_threading_graph.rs:111-140,484-660).  The native call returns vertex/
edge/ref-path arrays from which the Python graph object is reconstructed.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_failed = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("graphbuild", ["graph_build.cpp"])
        lib.graph_build.argtypes = [
            _u8p, _i64p, _i32p, _u8p, ctypes.c_int64, ctypes.c_int,
            _i64p, _i32p, _i32p, _i32p, _u8p, _i32p,
            ctypes.c_int64, _i64p]
        lib.graph_build.restype = ctypes.c_int
        lib.graph_build2.argtypes = [
            _u8p, _i64p, _i32p, _u8p, _i32p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i64p, _i32p, _i32p, _i32p, _u8p, _i32p, _i32p,
            ctypes.c_int64, _i64p]
        lib.graph_build2.restype = ctypes.c_int
        lib.graph_build3.argtypes = [
            _u8p, _i64p, _i32p, _u8p, _i32p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            _i64p, _i32p, _i32p, _i32p, _u8p, _i32p, _i32p,
            ctypes.c_int64, _i64p,
            _u8p, _i64p, _i32p, _i32p, _i32p, _u8p,
            ctypes.c_int64, _i64p]
        lib.graph_build3.restype = ctypes.c_int
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to Python
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_graph_native(pending: list, k: int):
    """(vertices, edges, ref_path) from threading `pending` sequences —
    [(name, seq bytes, count, is_ref)] in thread order (reference first) —
    or None when the native library is unavailable.

    vertices: list[bytes kmers]; edges: (u, v, mult, is_ref) int arrays;
    ref_path: int array.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(pending)
    seq_buf = b"".join(p[1] for p in pending)
    seq_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(p[1]) for p in pending], out=seq_off[1:])
    counts = np.fromiter((p[2] for p in pending), np.int32, n)
    is_ref = np.fromiter((1 if p[3] else 0 for p in pending), np.uint8, n)
    cap = int(sum(max(len(p[1]) - k + 1, 0) for p in pending)) + 1
    buf = np.frombuffer(seq_buf, np.uint8)

    v_off = np.empty(cap, np.int64)
    e_u = np.empty(cap, np.int32)
    e_v = np.empty(cap, np.int32)
    e_mult = np.empty(cap, np.int32)
    e_ref = np.empty(cap, np.uint8)
    ref_path = np.empty(cap, np.int32)
    out_counts = np.zeros(3, np.int64)

    rc = lib.graph_build(
        buf.ctypes.data_as(_u8p), seq_off.ctypes.data_as(_i64p),
        counts.ctypes.data_as(_i32p), is_ref.ctypes.data_as(_u8p),
        n, k,
        v_off.ctypes.data_as(_i64p), e_u.ctypes.data_as(_i32p),
        e_v.ctypes.data_as(_i32p), e_mult.ctypes.data_as(_i32p),
        e_ref.ctypes.data_as(_u8p), ref_path.ctypes.data_as(_i32p),
        cap, out_counts.ctypes.data_as(_i64p))
    if rc != 0:
        return None
    nv, ne, nr = (int(x) for x in out_counts)
    vertices = [seq_buf[int(o):int(o) + k] for o in v_off[:nv]]
    return (vertices,
            (e_u[:ne], e_v[:ne], e_mult[:ne], e_ref[:ne]),
            ref_path[:nr])


def pack_pending(pending: list):
    """One-time numpy packing of a pending list, reusable across kmer sizes
    (the native thread() skips sequences shorter than k+1 itself)."""
    n = len(pending)
    seq_buf = b"".join(p[1] for p in pending)
    seq_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(p[1]) for p in pending], out=seq_off[1:])
    counts = np.fromiter((p[2] for p in pending), np.int32, n)
    is_ref = np.fromiter((1 if p[3] else 0 for p in pending), np.uint8, n)
    sample_ids = np.fromiter((p[4] for p in pending), np.int32, n)
    buf = np.frombuffer(seq_buf, np.uint8)
    cap = int(seq_off[-1]) + 1          # >= total kmer positions for any k
    return (seq_buf, buf, seq_off, counts, is_ref, sample_ids, cap)


def build_graph_native3(pending: list, k: int, num_pruning_samples: int,
                        prune_factor: int,
                        start_only_at_existing: bool = True,
                        prepacked=None, allow_zip: bool = True,
                        recovery_on: bool = True):
    """graph_build3: graph_build2 plus the speculative in-C++ seq-graph zip
    (reachability filter + chain collapse) when dangling-end recovery
    cannot apply.  Returns None when native is unavailable, otherwise a
    dict with:
      gates:     (has_cycle, n_nonuniq, n_map, nr)
      zip:       (bounds i64[nsv+1], seq bytes, (u, v, mult, is_ref))
                 or None when the kmer graph was handed over instead
      kmer:      graph_build2-shaped tuple or None (present iff zip None)
    """
    lib = _load()
    if lib is None:
        return None
    if prepacked is None:
        prepacked = pack_pending(pending)
    seq_buf, buf, seq_off, counts, is_ref, sample_ids, cap = prepacked
    n = len(seq_off) - 1

    v_off = np.empty(cap, np.int64)
    e_u = np.empty(cap, np.int32)
    e_v = np.empty(cap, np.int32)
    e_mult = np.empty(cap, np.int32)
    e_ref = np.empty(cap, np.uint8)
    e_pm = np.empty(cap, np.int32)
    ref_path = np.empty(cap, np.int32)
    out_counts = np.zeros(7, np.int64)
    cap_z = cap + 64 * k
    zseq = np.empty(cap_z, np.uint8)
    zv_bounds = np.empty(cap_z, np.int64)
    ze_u = np.empty(cap_z, np.int32)
    ze_v = np.empty(cap_z, np.int32)
    ze_mult = np.empty(cap_z, np.int32)
    ze_ref = np.empty(cap_z, np.uint8)
    zcounts = np.zeros(3, np.int64)

    rc = lib.graph_build3(
        buf.ctypes.data_as(_u8p), seq_off.ctypes.data_as(_i64p),
        counts.ctypes.data_as(_i32p), is_ref.ctypes.data_as(_u8p),
        sample_ids.ctypes.data_as(_i32p), n, k,
        num_pruning_samples, prune_factor,
        1 if start_only_at_existing else 0,
        1 if allow_zip else 0, 1 if recovery_on else 0,
        v_off.ctypes.data_as(_i64p), e_u.ctypes.data_as(_i32p),
        e_v.ctypes.data_as(_i32p), e_mult.ctypes.data_as(_i32p),
        e_ref.ctypes.data_as(_u8p), e_pm.ctypes.data_as(_i32p),
        ref_path.ctypes.data_as(_i32p),
        cap, out_counts.ctypes.data_as(_i64p),
        zseq.ctypes.data_as(_u8p), zv_bounds.ctypes.data_as(_i64p),
        ze_u.ctypes.data_as(_i32p), ze_v.ctypes.data_as(_i32p),
        ze_mult.ctypes.data_as(_i32p), ze_ref.ctypes.data_as(_u8p),
        cap_z, zcounts.ctypes.data_as(_i64p))
    if rc != 0:
        return None
    nv, ne, nr, cyc, n_nonuniq, n_map, zip_done = \
        (int(x) for x in out_counts)
    out = dict(gates=(bool(cyc), n_nonuniq, n_map, nr), zip=None, kmer=None)
    if zip_done:
        nsv, nse, so = (int(x) for x in zcounts)
        out["zip"] = (zv_bounds[:nsv + 1], zseq[:so].tobytes(),
                      (ze_u[:nse], ze_v[:nse], ze_mult[:nse], ze_ref[:nse]))
        return out
    vertices = [seq_buf[o:o + k] for o in v_off[:nv].tolist()]
    last_bytes = buf[v_off[:nv] + (k - 1)].tobytes() if nv else b""
    out["kmer"] = (vertices,
                   (e_u[:ne], e_v[:ne], e_mult[:ne], e_ref[:ne], e_pm[:ne]),
                   ref_path[:nr], bool(cyc), (n_nonuniq, n_map), last_bytes)
    return out


def build_graph_native2(pending: list, k: int, num_pruning_samples: int,
                        prune_factor: int,
                        start_only_at_existing: bool = True,
                        prepacked=None):
    """Thread + per-sample flush + cycle check + (if acyclic and
    prune_factor > 0) low-weight chain pruning with orphan removal, all in
    C++.  `pending` is [(name, seq bytes, count, is_ref, sample_id)] in
    thread order, reference first, sample-grouped.  Returns
    (vertices, (u, v, mult, is_ref, pruning_mult), ref_path, has_cycle) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if prepacked is None:
        prepacked = pack_pending(pending)
    seq_buf, buf, seq_off, counts, is_ref, sample_ids, cap = prepacked
    n = len(seq_off) - 1

    v_off = np.empty(cap, np.int64)
    e_u = np.empty(cap, np.int32)
    e_v = np.empty(cap, np.int32)
    e_mult = np.empty(cap, np.int32)
    e_ref = np.empty(cap, np.uint8)
    e_pm = np.empty(cap, np.int32)
    ref_path = np.empty(cap, np.int32)
    out_counts = np.zeros(6, np.int64)

    rc = lib.graph_build2(
        buf.ctypes.data_as(_u8p), seq_off.ctypes.data_as(_i64p),
        counts.ctypes.data_as(_i32p), is_ref.ctypes.data_as(_u8p),
        sample_ids.ctypes.data_as(_i32p), n, k,
        num_pruning_samples, prune_factor,
        1 if start_only_at_existing else 0,
        v_off.ctypes.data_as(_i64p), e_u.ctypes.data_as(_i32p),
        e_v.ctypes.data_as(_i32p), e_mult.ctypes.data_as(_i32p),
        e_ref.ctypes.data_as(_u8p), e_pm.ctypes.data_as(_i32p),
        ref_path.ctypes.data_as(_i32p),
        cap, out_counts.ctypes.data_as(_i64p))
    if rc != 0:
        return None
    nv, ne, nr, cyc, n_nonuniq, n_map = (int(x) for x in out_counts)
    # plain-int iteration: numpy scalar indexing dominates at ~1e6
    # vertex slices per contig otherwise
    vertices = [seq_buf[o:o + k] for o in v_off[:nv].tolist()]
    # last base of every kmer in one gather: the seq-graph chain zipper
    # consumes exactly one trailing byte per vertex
    last_bytes = buf[v_off[:nv] + (k - 1)].tobytes()
    return (vertices,
            (e_u[:ne], e_v[:ne], e_mult[:ne], e_ref[:ne], e_pm[:ne]),
            ref_path[:nr], bool(cyc), (n_nonuniq, n_map), last_bytes)
