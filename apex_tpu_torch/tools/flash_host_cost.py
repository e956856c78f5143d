"""The host time of one flash-wrapper call, launch excluded.

Times the Python work each ``*_cuda`` wrapper of
``apex_tpu_torch/ops/attention.py`` does before and after its C entry
point — argument checks past the device check, views, the launch plan,
output allocation, the launch counters — on CPU tensors, with the kernel
library replaced by a stub that returns at once and the device checks
(the same in every version) skipped. It needs no card, so it can time a
second checkout of the repo beside this one in one process each:

    python apex_tpu_torch/tools/flash_host_cost.py [--root DIR]

``--root`` is the checkout whose ``apex_tpu_torch`` is timed (default:
this one). Prints one JSON object: microseconds per call at each wrapper
call, the median of 5 runs of ``--calls`` calls, each after a warm-up.
The shapes are small (the host work depends on the layouts, not the
sizes) but the layouts are the paths': BERT's bshd views of one packed
projection with kv_lens, GPT's packed buffer, T5's flat (b, h, s, d)
operands with the array bias, and T5's dbias with the dQ kernel's delta
(where the version takes one).
"""

import argparse
import inspect
import json
import statistics
import sys
import time
import types
from pathlib import Path


class _Stub:
    """The kernel library: every entry point returns 0 at once."""

    def __getattr__(self, name):
        return lambda *args: 0


def _per_call_us(fn, calls):
    for _ in range(200):
        fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(runs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--calls", type=int, default=3000)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from apex_tpu_torch.ops import attention as A

    A._build.library = lambda: _Stub()
    torch.cuda.current_stream = (
        lambda *a, **k: types.SimpleNamespace(cuda_stream=0))
    A._sm_count = lambda index: 132
    for name in ("_check_packed", "_check_bshd", "_check_flat"):
        setattr(A, name, lambda *a, **k: None)

    bf = torch.bfloat16
    b, s, h, d = 2, 512, 16, 64  # BERT's heads on one packed projection
    qkv = torch.zeros(b, s, 3 * h * d, dtype=bf)
    q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
    lens = torch.full((b,), s, dtype=torch.int32)
    gpt = torch.zeros(2, 256, 3 * 8 * 128, dtype=bf)  # 8 heads of 128
    t5 = torch.zeros(2, 12, 128, 64, dtype=bf)  # T5's 12 heads of 64
    bias = torch.zeros(12, 128, 128)
    lse = torch.zeros(24, 128)
    # a version whose dbias reads o instead takes no delta
    delta = ({"delta": lse} if "delta" in inspect.signature(
        A.flash_bwd_dbias_cuda).parameters else {})
    calls = {
        "bshd_fwd_bert": lambda: A.flash_fwd_bshd_cuda(
            q, k, v, scale=d ** -0.5, causal=False, kv_lens=lens),
        "packed_fwd_gpt": lambda: A.flash_fwd_cuda(
            gpt, 8, 8, 128, scale=128 ** -0.5, causal=True),
        "flat_fwd_t5_bias": lambda: A.flash_fwd_flat_cuda(
            t5, t5, t5, scale=1.0, causal=False, bias=bias),
        "dbias_t5": lambda: A.flash_bwd_dbias_cuda(
            t5, t5, t5, t5, lse, t5, bias, scale=1.0, causal=False,
            **delta),
    }
    out = {"root": args.root, "torch": torch.__version__,
           "us_per_call": {n: _per_call_us(fn, args.calls)
                           for n, fn in calls.items()}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
