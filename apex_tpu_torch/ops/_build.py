"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``apex_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` — one ``nvcc`` process per source, all started together — and
linked into ONE shared library with a plain C interface, loaded with
``ctypes``. No PyTorch header is compiled (that build takes minutes; this
one seconds). ``--use_fast_math`` is deliberately absent: the sampling
kernel's ``logf``/``expf`` must be the accurate ones its plain version
matches.

The build runs at first use, never at import (the CPU tests import every
module), into ``apex_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a digest of the sources and flags, so an edit
to any source rebuilds and a stale library is never loaded.

Each C entry point returns the ``cudaGetLastError()`` of its launch;
:func:`check` raises on anything but 0 — a launch the card refuses (too
much shared memory, a bad configuration) never runs, and a later
``synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

from apex_tpu_torch import nvcc_path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)  # an array of strides
_IP = ctypes.POINTER(ctypes.c_int)  # an array of ints written back
_U = ctypes.c_uint
# the flash entries' dropout arguments: the seed's bits, the 24-bit
# threshold (0: no dropout), float32(1 / (1 - rate)), the planted fault
_DROP = [_U, _I, _F, _I]
# name -> argtypes of every C entry point the library exports
ENTRY_POINTS = {
    # q, k_pool, v_pool, tables, lengths, out, dtype, b, h_kv, group, d,
    # bs, nb, scale, splits, tiles, smem, k_scale, v_scale, kv_dtype, lut,
    # maxd, stream
    "apex_paged_decode_attn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _I, _I, _P, _P, _I, _P, _I,
                               _P],
    # paged, dtype, d, group, bs, splits, tiles, smem, kv_dtype, maxd, out
    # (clusters)
    "apex_decode_attn_clusters": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _IP],
    # logits, u, out, dtype, b, V, inv_temp, top_k, use_top_p, top_p,
    # splits, threads, values, share, fault, stream
    "apex_fused_sample": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _I, _I,
                          _I, _I, _I, _P],
    # dtype, V, splits, threads, values, share, out (clusters)
    "apex_fused_sample_clusters": [_I, _I, _I, _I, _I, _I, _IP],
    # qkv, out, lse, kv_lens, b, s, h, h_kv, d, causal, scale, variant,
    # stream
    # drop_seed, drop_thresh, drop_scale, drop_fault, stream
    "apex_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                       *_DROP, _P],
    # the packed forward's fp16 instance: qkv, out, lse, b, s, h, h_kv, d,
    # causal, scale, fault, stream
    "apex_flash_fwd_f16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # the backward pair's fp16 instances on the packed buffer's views: q,
    # k, v, o, do, lse, dq, delta, strides (q, kv, o, do, dq), b, h, h_kv,
    # sq, sk, d, causal, scale, fault, stream
    "apex_flash_bwd_dq_f16": [_P, _P, _P, _P, _P, _P, _P, _P, _S, _I, _I,
                              _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, do, lse, delta, dk, dv, strides (q, kv, o, do, dk/dv), b,
    # h, h_kv, sq, sk, d, causal, scale, fault, stream
    "apex_flash_bwd_dkv_f16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _S, _I,
                               _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # logits, labels, m, l, t, row_sum, dtype, labels_int64, n, V, stream
    "apex_xent_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, lse, kv_lens, bias, q_bstride, kv_bstride, q_stride,
    # kv_stride, b, sq, sk, h, h_kv, d, causal, scale, hb, variant,
    # bias_tma, the dropout arguments, lut, maxd, rel_off, stream
    "apex_flash_fwd_bshd": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, *_DROP,
                            _P, _I, _I, _P],
    # q, k, v, out, lse, kv_lens, lut, bias, strides (q, kv, o), b, h,
    # h_kv, sq, sk, d, causal, scale, maxd, rel_off, hb, variant,
    # bias_tma, the dropout arguments, stream
    "apex_flash_fwd_flat": [_P, _P, _P, _P, _P, _P, _P, _P, _S, _I, _I, _I,
                            _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, *_DROP,
                            _P],
    # q, k, v, o, do, lse, delta, dk, dv, dtab, kv_lens, lut, bucket, bias,
    # strides (q, kv, o, do, dk/dv), b, h, h_kv, sq, sk, d, causal, scale,
    # maxd, rel_off, hb, nb, lens_b, lens_h, variant, bias_tma, the
    # dropout arguments, stream
    "apex_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _S, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                           _I, _I, _I, _I, _I, _I, _I, *_DROP, _P],
    # q, k, v, o, do, lse, dq, delta, kv_lens, lut, bias, strides (q, kv,
    # o, do, dq), b, h, h_kv, sq, sk, d, causal, scale, maxd, rel_off, hb,
    # lens_b, lens_h, variant, bias_tma, the dropout arguments, stream
    "apex_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _S,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                          _I, _I, _I, *_DROP, _P],
    # q, k, v, o, do, lse, delta, bias, dbias, ws, kv_lens, strides (q,
    # kv, o, do), b, h, h_kv, sq, sk, d, causal, scale, hb, lens_b, lens_h,
    # splits, variant, the dropout arguments, stream
    "apex_flash_bwd_dbias": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _S,
                             _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                             _I, *_DROP, _P],
    # q, k, v, lengths (b,), out, dtype, b, h_kv, group, d, max_s, scale,
    # splits, tiles, smem, lut, maxd, stream
    "apex_decode_attn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                         _I, _I, _P, _I, _P],
    # logits, drafted, u_acc, u_gum, a, next, slots, arrivals, epoch,
    # dtype, b, k1, V, sampled, inv_temp, top_k, use_top_p, top_p, splits,
    # threads, values, share, fault, stream
    "apex_fused_verify": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _F, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # logits, tokens, parents, anc, u_acc, u_gum, a, j_star, next, slots,
    # arrivals, epoch, dtype, b, n1, V, sampled, inv_temp, top_k, use_top_p,
    # top_p, splits, threads, values, share, fault, stream
    "apex_fused_verify_tree": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I,
                               _I, _I, _I, _I, _P],
    # tree, top_p, dtype, V, splits, threads, values, share, out (clusters,
    # smem)
    "apex_fused_verify_occupancy": [_I] * 8 + [_IP],
    # x, w, b, y, mean, rstd, dtype, w_dtype, affine, rms, rows, n, eps,
    # chunks, warps, groups, ctas, smem, stream
    "apex_ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                    _I, _I, _I, _I, _P],
    # dy, x, mean, rstd, w, dx, part, dw, db, dtype, w_dtype, rms, rows, n,
    # rows_per_cta, stream
    "apex_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _P],
    # dtype, n, out (chunks a thread, warps a row, threads a CTA)
    "apex_ln_bwd_shape": [_I, _I, _IP],
    # x, w, b, y, mean, rstd, dtype, w_dtype, affine, rms, rows, n, eps,
    # warps, ranks, clusters, fault, stream
    "apex_ln_fwd_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                         _I, _I, _I, _I, _P],
    # dy, x, mean, rstd, w, dx, part, dw, db, dtype, w_dtype, rms, rows, n,
    # warps, ranks, parts, fault, stream
    "apex_ln_bwd_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P],
    # x, y, mask, mask strides (b, h, q, k), heads, q_rows, dtype, mode,
    # rows, n, sq, scale, stream
    "apex_softmax_fwd": [_P, _P, _P, _S, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P],
    # dy, y, dx, mask, mask strides (b, h, q, k), heads, q_rows, dtype,
    # mode, rows, n, sq, scale, stream (the forward's mask arguments)
    "apex_softmax_bwd": [_P, _P, _P, _P, _S, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P],
    # x, y, dtype, numel, n, seed, thresh, div, inv, fault, stream
    "apex_dropout": [_P, _P, _I, _L, _L, _U, _I, _F, _F, _I, _P],
    # x, res, y, scale, bias, rmean, rvar, stats, part, dtype, out_dtype,
    # w_dtype, M, C, train, relu, eps, vec, tx, ty, chunks, rows_per_chunk,
    # apply_ctas, fault, stream
    "apex_bn_fwd": [_P] * 9 + [_I] * 7 + [_F] + [_I] * 7 + [_P],
    # dy, x, y, stats, dx, dres, dscale, dbias, part, dtype, out_dtype,
    # w_dtype, M, C, train, relu, vec, tx, ty, chunks, rows_per_chunk,
    # apply_ctas, fault, stream
    "apex_bn_bwd": [_P] * 9 + [_I] * 14 + [_P],
    # a, b, bias, c, ws, dtype, variant, a_k, b_k, a_vec, b_vec, act,
    # bias_f32, out_f32, M, N, K, lda, ldb, ldc, split, kt_split, stream
    "apex_matmul_bias_act": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _P],
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libapex_tpu_torch_{_digest()}.so"


def compile_library(srcs: List[Path], include_dir: Path,
                    lib: Path) -> Tuple[str, List[str]]:
    """Compile ``srcs`` (one ``nvcc`` each, all started together) and link
    them into ``lib``: (the compiler's output, the names that failed)."""
    tag = f"{os.getpid()}"
    procs = []
    for src in srcs:
        obj = lib.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc_path(), *ARCH_FLAGS, *COMPILE_FLAGS, "-I",
               str(include_dir), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = lib.parent / f"{lib.name}.{tag}.tmp"
        link = subprocess.run(
            [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    return "\n".join(log), failed


def build() -> Path:
    """Compile (if the digest-named library is missing) and return its
    path. Raises with the compiler's output when a source fails."""
    lib = library_path()
    if lib.exists():
        return lib
    if nvcc_path() is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc "
            "or PATH): the port's CUDA kernels are built from source at "
            "first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log, failed = compile_library(sources(), CSRC_DIR, lib)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + log)
    return lib


def build_log() -> str:
    """The last build's compiler output (``-Xptxas -v``: registers,
    shared memory and spills per kernel), or '' before any build."""
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().apex_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
