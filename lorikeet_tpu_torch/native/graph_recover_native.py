"""ctypes wrapper for graph_recover.cpp: the native graph build with
dangling-end recovery before the seq-graph zip.

Conformance spec: assembly/graph.py ReadThreadingGraph.build, then
recover_dangling_ends, has_cycle, remove_paths_not_connected_to_ref and
SeqGraph.from_kmer_graph.  graph_recover.cpp includes graph_build.cpp and
sw.cpp whole, so the library's hash covers both.
"""
from __future__ import annotations

import ctypes

import numpy as np

from lorikeet_tpu_torch.native.graph_native import pack_pending

_lib = None
_failed = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_int = ctypes.c_int


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("graphrecover", ["graph_recover.cpp"],
                   headers=["graph_build.cpp", "sw.cpp"])
        lib.graph_build_recover.argtypes = [
            _u8p, _i64p, _i32p, _u8p, _i32p, ctypes.c_int64, _int,
            _int, _int, _int, _int, _int, _int, _int, _i64p,
            _u8p, _i64p, _i32p, _i32p, _i32p, _u8p, ctypes.c_int64, _i64p]
        lib.graph_build_recover.restype = _int
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to Python
        _failed = True
    return _lib


def build_graph_recover(pending: list, k: int, num_pruning_samples: int,
                        prune_factor: int,
                        start_only_at_existing: bool = True,
                        prepacked=None, recovery_on: bool = True,
                        min_dangling_branch_length: int = 1,
                        min_matching_bases: int = -1,
                        recover_all: bool = False):
    """Thread ``pending`` (graph_native.pack_pending's order), flush,
    check for a cycle and prune as graph_native.build_graph_native3 does,
    then recover the dangling ends (when ``recovery_on``) and zip the seq
    graph, all in C++.  None where the graph has to be built another way
    (no library, too many pruning samples, a capacity overflow), else a
    dict with:
      gates:        (has_cycle, n_nonuniq, n_map, nr), before recovery
      cyclic_after: recovery made the graph cyclic
      zip:          (bounds i64[nsv+1], seq bytes, (u, v, mult, is_ref)),
                    or None where the graph is cyclic or has no reference
                    path
    """
    lib = _load()
    if lib is None:
        return None
    if prepacked is None:
        prepacked = pack_pending(pending)
    _, buf, seq_off, counts, is_ref, sample_ids, cap = prepacked
    out_counts = np.zeros(6, np.int64)
    cap_z = cap + 64 * k
    zseq = np.empty(cap_z, np.uint8)
    zv_bounds = np.empty(cap_z, np.int64)
    ze_u = np.empty(cap_z, np.int32)
    ze_v = np.empty(cap_z, np.int32)
    ze_mult = np.empty(cap_z, np.int32)
    ze_ref = np.empty(cap_z, np.uint8)
    zcounts = np.zeros(3, np.int64)
    rc = lib.graph_build_recover(
        buf.ctypes.data_as(_u8p), seq_off.ctypes.data_as(_i64p),
        counts.ctypes.data_as(_i32p), is_ref.ctypes.data_as(_u8p),
        sample_ids.ctypes.data_as(_i32p), len(seq_off) - 1, k,
        num_pruning_samples, prune_factor,
        1 if start_only_at_existing else 0, 1 if recovery_on else 0,
        min_dangling_branch_length, min_matching_bases,
        1 if recover_all else 0, out_counts.ctypes.data_as(_i64p),
        zseq.ctypes.data_as(_u8p), zv_bounds.ctypes.data_as(_i64p),
        ze_u.ctypes.data_as(_i32p), ze_v.ctypes.data_as(_i32p),
        ze_mult.ctypes.data_as(_i32p), ze_ref.ctypes.data_as(_u8p),
        cap_z, zcounts.ctypes.data_as(_i64p))
    if rc != 0:
        return None
    nr, cyc, n_nonuniq, n_map, zipped, cyclic_after = \
        (int(x) for x in out_counts)
    out = dict(gates=(bool(cyc), n_nonuniq, n_map, nr),
               cyclic_after=bool(cyclic_after), zip=None)
    if zipped:
        nsv, nse, so = (int(x) for x in zcounts)
        out["zip"] = (zv_bounds[:nsv + 1], zseq[:so].tobytes(),
                      (ze_u[:nse], ze_v[:nse], ze_mult[:nse], ze_ref[:nse]))
    return out
