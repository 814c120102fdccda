"""ctypes loader for the host C++ kernels of the k-reciprocal rerank
(csrc/rerank.cpp; port of openibl_tpu/ops/_native.py).

The k-reciprocal expansion loop is O(N * k1^2) pointer-chasing that numpy
cannot vectorize, and the Jaccard intersection is one scalar loop per query;
both run in C++ on the host. The library is built by ``g++`` at first use
into ``build/native/`` at the root of the checkout (git-ignored), under a
name that carries the hash of the source and the flags, so a changed source
builds anew. Nothing is built at import time.

When the build or the load fails, ``available()`` is False and the callers
in ops/rerank.py take their numpy/scipy paths, as the JAX package does;
``require()`` raises instead, with the compiler's message, for a caller
that must know the native path ran.
"""

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading

import numpy as np

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
SRC = osp.join(_PKG, "csrc", "rerank.cpp")
BUILD_DIR = osp.join(osp.dirname(_PKG), "build", "native")
# no -march=native: the library must load on any x86-64 host that reads
# this build directory
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB = None
_TRIED = False
_ERROR = None  # why the last load failed
_lock = threading.Lock()


def library_path():
    """Where the build of csrc/rerank.cpp goes (hash of source and flags)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"librerank-{h.hexdigest()[:16]}.so")


def build(verbose=False):
    """Compile csrc/rerank.cpp with g++ unless its build exists; returns the
    library's path. Raises RuntimeError when the compiler fails."""
    path = library_path()
    if osp.isfile(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ / c++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) building "
                           f"{SRC}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: processes building at once agree
    return path


def _bind(path):
    lib = ctypes.CDLL(path)
    lib.expansion_weights.restype = ctypes.c_int64
    lib.expansion_weights.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # original (n*n)
        ctypes.POINTER(ctypes.c_int32),  # initial_rank (n*rank_cols)
        ctypes.c_int64,  # n
        ctypes.c_int64,  # rank_cols
        ctypes.c_int32,  # k1
        ctypes.c_int32,  # half (np.around(k1/2), python is the source of truth)
        ctypes.POINTER(ctypes.c_int32),  # out rows (cap)
        ctypes.POINTER(ctypes.c_int32),  # out cols (cap)
        ctypes.POINTER(ctypes.c_float),  # out vals (cap)
        ctypes.c_int64,  # cap
    ]
    lib.expansion_sets.restype = ctypes.c_int64
    lib.expansion_sets.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # initial_rank (n*rank_cols)
        ctypes.c_int64,  # n
        ctypes.c_int64,  # rank_cols
        ctypes.c_int32,  # k1
        ctypes.c_int32,  # half
        ctypes.POINTER(ctypes.c_int32),  # out rows (cap)
        ctypes.POINTER(ctypes.c_int32),  # out cols (cap)
        ctypes.c_int64,  # cap
    ]
    lib.jaccard_queries.restype = None
    lib.jaccard_queries.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # csr indptr (n+1)
        ctypes.POINTER(ctypes.c_int32),  # csr cols (nnz)
        ctypes.POINTER(ctypes.c_float),  # csr vals (nnz)
        ctypes.POINTER(ctypes.c_int64),  # csc indptr (n+1)
        ctypes.POINTER(ctypes.c_int32),  # csc rows (nnz)
        ctypes.POINTER(ctypes.c_float),  # csc vals (nnz)
        ctypes.c_int64,  # n
        ctypes.POINTER(ctypes.c_int64),  # query rows (n_q)
        ctypes.c_int64,  # n_q
        ctypes.c_int32,  # n_threads (<=0: hardware concurrency)
        ctypes.POINTER(ctypes.c_float),  # out (n_q, n)
    ]
    return lib


def _load():
    global _LIB, _TRIED, _ERROR
    with _lock:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _bind(build())
            except (RuntimeError, OSError, AttributeError) as e:
                # RuntimeError: no compiler or a failed build; OSError: a
                # dlopen failure; AttributeError: a library without one of
                # the symbols. The callers take their numpy/scipy paths.
                _LIB, _ERROR = None, f"{type(e).__name__}: {e}"
    return _LIB


def available():
    return _load() is not None


def require():
    """The loaded library's path; raises RuntimeError (with the reason)
    when csrc/rerank.cpp could not be built or loaded."""
    if _load() is None:
        raise RuntimeError(f"the native rerank library is not available: "
                           f"{_ERROR}")
    return library_path()


def expansion_weights(original, initial_rank, k1):
    """C++ path for ops.rerank steps 2+3. Returns (rows, cols, vals).

    initial_rank may be a partial (n, depth) ranking, depth >= k1+1."""
    lib = _load()
    n = original.shape[0]
    rank_cols = initial_rank.shape[1]
    assert rank_cols >= k1 + 1, "partial ranking too shallow for k1"
    original = np.ascontiguousarray(original, np.float32)
    initial_rank = np.ascontiguousarray(initial_rank, np.int32)
    # np.around rounds half-to-even (12 for k1=25); passed to C++ so both
    # paths and the cap computation agree
    half = int(np.around(k1 / 2.0))
    cap = n * (k1 + 1) * (half + 2)
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float32)
    count = lib.expansion_weights(
        original.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        initial_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, rank_cols, k1, half,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap,
    )
    if count < 0:
        raise RuntimeError("native expansion_weights overflow")
    return rows[:count], cols[:count], vals[:count]


def expansion_sets(initial_rank, k1):
    """C++ path for the k-reciprocal expansion index alone (no distance
    values: the streaming rerank computes weights from features).
    Returns (rows, cols), row-major sorted."""
    lib = _load()
    n = initial_rank.shape[0]
    rank_cols = initial_rank.shape[1]
    assert rank_cols >= k1 + 1, "partial ranking too shallow for k1"
    initial_rank = np.ascontiguousarray(initial_rank, np.int32)
    half = int(np.around(k1 / 2.0))
    cap = n * (k1 + 1) * (half + 2)
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    count = lib.expansion_sets(
        initial_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, rank_cols, k1, half,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    if count < 0:
        raise RuntimeError("native expansion_sets overflow")
    return rows[:count], cols[:count]


def jaccard_queries(csr_indptr, csr_cols, csr_vals, csc_indptr, csc_rows,
                    csc_vals, n, query_rows, n_threads=0):
    """C++ path for the re_ranking step-5 min/sum intersection.

    CSR/CSC of the same sparse V matrix (int64 indptrs, int32 indices, f32
    values); returns (len(query_rows), n) f32 Jaccard distances. Parallel
    over queries (n_threads<=0: hardware concurrency); each query is summed
    by one thread in CSR order, so the result does not depend on the
    thread count."""
    lib = _load()
    csr_indptr = np.ascontiguousarray(csr_indptr, np.int64)
    csr_cols = np.ascontiguousarray(csr_cols, np.int32)
    csr_vals = np.ascontiguousarray(csr_vals, np.float32)
    csc_indptr = np.ascontiguousarray(csc_indptr, np.int64)
    csc_rows = np.ascontiguousarray(csc_rows, np.int32)
    csc_vals = np.ascontiguousarray(csc_vals, np.float32)
    query_rows = np.ascontiguousarray(query_rows, np.int64)
    out = np.empty((len(query_rows), n), np.float32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.jaccard_queries(
        csr_indptr.ctypes.data_as(i64p), csr_cols.ctypes.data_as(i32p),
        csr_vals.ctypes.data_as(f32p), csc_indptr.ctypes.data_as(i64p),
        csc_rows.ctypes.data_as(i32p), csc_vals.ctypes.data_as(f32p),
        n, query_rows.ctypes.data_as(i64p), len(query_rows),
        int(n_threads), out.ctypes.data_as(f32p),
    )
    return out
