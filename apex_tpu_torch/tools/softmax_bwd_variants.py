"""Variants of the softmax backward, timed in turns at the main paths'
softmax calls.

Each variant is this tree's ``csrc/softmax.cu`` with the edits of
:data:`VARIANTS` applied to a copy under ``_build/`` (never to the
source), built with ``errors.cu`` into a library of its own and run
through the port's wrapper (``rowwise_ab.using``). At each call of
``chip_smoke.SOFTMAX_CALLS`` and the T5 legs' unmasked cross call, the
tree's kernel, each variant and (with ``--parent DIR``) the parent
commit's kernel are timed in turns, twice, in opposite orders; every
variant's dx is held against the tree's (``max_rel_diff``: the largest
difference over the largest entry). The variants that leave work out
(``no_dx_store``, ``no_mask_read``) give wrong dx and are there for
their times only. One JSON line a call, then the variants' registers and
spills. Needs the card and ``nvcc``:

    python3 apex_tpu_torch/tools/softmax_bwd_variants.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from apex_tpu_torch.ops import _build  # noqa: E402
from apex_tpu_torch.tools import rowwise_ab  # noqa: E402

_STORE = "      put_chunk<T>(dxr, i0, n, w, pack_chunk<T>(v, 1.f));"
#: name -> [(text of csrc/softmax.cu, its replacement)], each text found
#: once
VARIANTS = {
    # a fully masked chunk's zeros packed from the floats like any other
    "pack_zeros": [(
        "      if (out == kAll) {  // every entry masked: dx 0, nothing to "
        "pack\n        put_chunk<T>(dxr, i0, n, w, make_uint4(0u, 0u, 0u, "
        "0u));\n        continue;\n      }\n", "")],
    # rows of at most 16 chunks two a warp (the forward's by_width)
    "two_rows_a_warp": [("if (!bwd_width<T>(n,", "if (!by_width<T>(n,")],
    # no row in flight ahead of the reduced one, with a mask too
    "depth_1": [("{ return mode == kNoMask ? 1 : 2; }", "{ return 1; }")],
    # the next row in flight without a mask too (persistent warps)
    "depth_2": [("{ return mode == kNoMask ? 1 : 2; }", "{ return 2; }")],
    # every mask read byte by byte where its rows are unaligned
    "mask_bytes": [("  const bool words =\n      kMode == kMask &&",
                    "  const bool words =\n      false && kMode == kMask &&")],
    # every mask read by words, aligned rows too
    "mask_words": [("  const bool words =\n      kMode == kMask &&",
                    "  const bool words =\n      true || kMode == kMask &&")],
    # attribution, wrong dx: no dx store; no mask read (every entry read)
    "no_dx_store": [
        (_STORE, "      if (dot == 12345.f)\n  " + _STORE),
        ("        put_chunk<T>(dxr, i0, n, w, make_uint4(0u, 0u, 0u, 0u));",
         "        if (dot == 12345.f)\n          put_chunk<T>(dxr, i0, n, w, "
         "make_uint4(0u, 0u, 0u, 0u));")],
    "no_mask_read": [(
        "    bwd_bits<kMode, C, V, L>(row.mk, walk, m, sl, n, active, words);",
        "    bwd_bits<kNoMask, C, V, L>(row.mk, walk, m, sl, n, active, "
        "words);")],
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def edited_source(name: str) -> str:
    """``csrc/softmax.cu`` with variant ``name``'s edits applied."""
    text = (_build.CSRC_DIR / "softmax.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"softmax.cu no longer has the text variant "
                               f"{name} edits: {old!r}")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """Variant ``name`` built and loaded: (library, ptxas report)."""
    out = _build.BUILD_DIR / f"softmax_bwd_{name}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC_DIR, out)
    (out / "softmax.cu").write_text(edited_source(name))
    lib_path = out / "libvariant.so"
    log, failed = _build.compile_library(
        [out / "softmax.cu", out / "errors.cu"], out, lib_path)
    if failed:
        raise RuntimeError(f"building variant {name} failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in _build.ENTRY_POINTS.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib, rowwise_ab.ptxas_report(log)


def main(argv=None) -> int:
    import torch

    from apex_tpu_torch.ops import softmax as S

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout whose softmax_bwd is timed too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("softmax_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        parent = (pool.submit(rowwise_ab.other_library, args.parent)
                  if args.parent else None)
        built = {v: pool.submit(build_variant, v) for v in VARIANTS}
        _build.library()
        libs = {v: f.result() for v, f in built.items()}
        plib = parent.result()[0] if parent else None
    dev = torch.device("cuda")
    calls = dict(cs.SOFTMAX_CALLS, t5_cross_unmasked=(
        (cs.T5_BATCH, 12, cs.T5_DEC, cs.T5_ENC), None))
    names = ["tree", *VARIANTS] + (["parent"] if plib else [])
    for what, (shape, kind) in calls.items():
        x, dy, mask = cs.softmax_case(torch, dev, shape, kind, 9)
        causal = kind == "causal"
        y = S.softmax_fwd_cuda(x, mask, 0.125, causal)
        del x
        ref = S.softmax_bwd_cuda(dy, y, 0.125, causal=causal, mask=mask)

        def run():
            return S.softmax_bwd_cuda(dy, y, 0.125, causal=causal,
                                      mask=mask)

        times = {k: [] for k in names}
        diff = {}
        for order in (names, names[::-1]):
            for k in order:
                if k == "parent":
                    with rowwise_ab.using(plib):
                        times[k].append(cs.time_ms(run, [()]))
                elif k == "tree":
                    times[k].append(cs.time_ms(run, [()]))
                else:
                    with rowwise_ab.using(libs[k][0]):
                        times[k].append(cs.time_ms(run, [()]))
                        got = run()
                    diff[k] = ((got.float() - ref.float()).abs().max()
                               / ref.float().abs().max()).item()
        print(json.dumps({"call": what, "shape": list(shape), "mask": kind,
                          "ms": {k: sum(t) / 2 for k, t in times.items()},
                          "max_rel_diff": diff}), flush=True)
        del dy, y, ref
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas": {v: {k: i for k, i in rep.items()
                                    if "softmax_bwd_kernel<__nv_bfloat16"
                                    in k}
                                for v, (_, rep) in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
