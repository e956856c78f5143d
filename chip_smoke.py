#!/usr/bin/env python3
"""chip_smoke.py — drive apex_tpu_torch's serving path on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 (no
arguments, one card, no network):

    python3 chip_smoke.py

Phases, none of whose failures is caught (any failure exits non-zero
without the final line):

1. the toolchain report (``apex_tpu_torch.env_report()``);
2. the CUDA kernels' build from ``apex_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, timed, with ptxas's register/shared-memory report;
3. each kernel against its plain PyTorch version at the slice's shapes in
   bf16 — ``paged_decode_attn`` (8 slots, MHA and GQA, block 128, d 128,
   41 blocks, permuted tables, ragged lengths with 0) and
   ``fused_sample`` ((8, 32768) at T=0.8 with top-k/top-p on and off) —
   with the kernel's time (CUDA events, median), the plain version's,
   a library call's where one computes the same function, and the bound;
4. the main path: GPT-medium at full width (bf16, vocab 32768, hidden
   1024, 12 layers, 8 heads of 128; random weights from a seed) served by
   ``ServingEngine`` (8 slots, block 128, chunk 256, 41 blocks — ~60% of
   worst case, so preemption happens) over 16 seeded requests sharing two
   256-token system prompts: a greedy serve, then a sampled one
   (T=0.8, top_k 50, top_p 0.9). The launch counters are zeroed just
   before and read just after, and must equal 12 paged-decode launches
   per decode step and one sampling launch per sampled step;
5. outside the counted window: the greedy serve again on a fresh engine
   (tokens must be identical), a serve through the plain versions (the
   share of requests with identical tokens is printed; bf16 near-ties may
   flip a token), and a profiled greedy serve (device time by kernel and
   the device-busy share of the serve's wall time);
6. one ``{"kernels": [...]}`` line, the card's name and power limit as
   nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

# the serving slice's configuration (bench.py's GPT-medium serve cell)
MODEL = dict(vocab_size=32768, max_seq_len=1024, hidden_size=1024,
             num_layers=12, num_heads=8)
ENGINE = dict(num_slots=8, block_size=128, prefill_chunk=256, num_blocks=41)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
DECODE_TOL = 2e-2   # bf16 output: a few bf16 ulps at unit scale
NEAR_TIE = 1e-5     # relative gap of the two best perturbed scores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def time_ms(fn, arg_sets, reps=20, trials=11):
    """Device time of one call: the median over ``trials`` of the mean of
    ``reps`` back-to-back calls between two CUDA events, cycling through
    ``arg_sets`` (distinct copies keep the inputs out of the 50 MB L2,
    where the real caller finds them cold). A spin kernel queued first
    holds the card while the host enqueues the calls, so the events
    measure the device's work and not the Python wrapper's."""
    import torch

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    spin_cycles = int(4 * host_s * 2e9) + 1_000_000
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def decode_case(torch, dev, h_kv, lengths, seed, copies=1):
    """q and ``copies`` (pool, tables) sets: 41-block pools, each slot's
    live blocks at permuted ids, unused entries the dead block 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    b, h, d, bs, nb, nblocks = 8, 8, 128, 128, 8, 41
    q = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sets = []
    for _ in range(copies):
        pk = torch.randn((nblocks, h_kv, bs, d), generator=g,
                         device=dev).bfloat16()
        pv = torch.randn((nblocks, h_kv, bs, d), generator=g,
                         device=dev).bfloat16()
        ids = list(rng.permutation(np.arange(1, nblocks)))
        tables = np.zeros((b, nb), np.int32)
        for i, n in enumerate(lengths):
            for j in range(-(-n // bs)):
                tables[i, j] = ids.pop()
        sets.append((q, pk, pv, lens, torch.tensor(tables, device=dev)))
    return sets


def phase_decode_kernel(torch, dev):
    from apex_tpu_torch.ops.decode_attention import (_gather_blocks,
                                                     decode_attention)
    import torch.nn.functional as F

    ragged = [0, 1, 127, 128, 129, 300, 512, 1000]
    err = 0.0
    for h_kv in (8, 2):  # MHA, then GQA
        for (q, pk, pv, lens, tables) in decode_case(torch, dev, h_kv,
                                                     ragged, seed=h_kv):
            got = decode_attention(q, pk, pv, lens, block_tables=tables)
            want = decode_attention(q, pk, pv, lens, block_tables=tables,
                                    impl="torch")
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got.float()).all().item(),
                  "paged decode kernel output not finite")
            check(not got[lens == 0].any().item(),
                  "paged decode kernel: length-0 slot not zeros")
            emit("decode_check", {"h_kv": h_kv, "lengths": ragged,
                                  "max_abs_err": e, "tol": DECODE_TOL})
            check(e <= DECODE_TOL, f"paged decode kernel vs plain: max abs "
                  f"err {e} > {DECODE_TOL} (h_kv={h_kv})")
            err = max(err, e)

    # timing: every slot at 512 live rows (MHA), six pool copies in turn
    lengths = [512] * 8
    sets = decode_case(torch, dev, 8, lengths, seed=3, copies=6)

    def library(q, pk, pv, lens, tables):
        k, v = _gather_blocks(pk, tables), _gather_blocks(pv, tables)
        mask = (torch.arange(k.shape[2], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                              attn_mask=mask)

    kern = lambda *a: decode_attention(*a[:4], block_tables=a[4])  # noqa
    plain = lambda *a: decode_attention(*a[:4], block_tables=a[4],  # noqa
                                        impl="torch")
    ms = time_ms(kern, sets)
    plain_ms = time_ms(plain, sets, reps=5)
    library_ms = time_ms(library, sets, reps=5)
    b, h, d = 8, 8, 128
    live = sum(lengths)
    nbytes = (2 * b * h * d * 2            # q in, out
              + 2 * live * 8 * d * 2       # live K and V rows, read once
              + b * 8 * 4 + b * 4)         # tables, lengths
    ops = 4 * live * h * d                 # q.k and p.v
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return {"name": "paged_decode_attn", "route": "cuda",
            "source": "apex_tpu_torch/csrc/paged_decode_attn.cu",
            "replaces": "apex_tpu/ops/pallas/decode_attention.py:211",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / BF16_OPS_PER_S else "operations"),
            "library_ms": library_ms,
            "timed_shape": {"slots": b, "heads": h, "kv_heads": 8,
                            "head_dim": d, "block": 128,
                            "live_rows_per_slot": 512, "dtype": "bf16"}}


def phase_sample_kernel(torch, dev):
    from apex_tpu_torch.ops.sampling import filtered_scaled, fused_sample

    b, V = 8, 32768
    knobs = [(0, 1.0), (50, 1.0), (0, 0.9), (50, 0.9)]
    mismatches = ties_total = rows = 0
    err = 0
    for seed in range(4):
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        logits = (torch.randn((b, V), generator=g, device=dev)
                  * 3.0).bfloat16()
        u = torch.rand((b, V), generator=g, device=dev).clamp_min(
            torch.finfo(torch.float32).tiny)
        for top_k, top_p in knobs:
            kw = dict(temperature=0.8, top_k=top_k, top_p=top_p, u=u)
            got = fused_sample(logits, **kw)
            want = fused_sample(logits, impl="torch", **kw)
            s = filtered_scaled(logits, temperature=0.8, top_k=top_k,
                                top_p=top_p)
            x = (s - torch.log(-torch.log(u))).double()
            top2 = x.topk(2, dim=-1).values
            ties = ((top2[:, 0] - top2[:, 1]).abs()
                    <= NEAR_TIE * top2[:, 0].abs())
            bad = (got != want) & ~ties
            mismatches += int(bad.sum())
            ties_total += int(ties.sum())
            rows += b
            diff = (got.long() - want.long()).abs()[~ties]
            err = max(err, int(diff.max()) if diff.numel() else 0)
    emit("sample_check", {"rows": rows, "near_ties_excluded": ties_total,
                          "mismatches": mismatches})
    check(mismatches == 0, f"fused_sample kernel vs plain: {mismatches} "
          f"token mismatches outside near-ties")
    check(ties_total <= 0.01 * rows, f"{ties_total} near-tie rows "
          f"excluded of {rows}")

    g = torch.Generator(device=dev).manual_seed(7)
    logits = (torch.randn((b, V), generator=g, device=dev) * 3.0).bfloat16()
    u = torch.rand((b, V), generator=g, device=dev).clamp_min(
        torch.finfo(torch.float32).tiny)
    kern = lambda lg, uu: fused_sample(lg, u=uu, **SAMPLED)  # noqa: E731
    plain = lambda lg, uu: fused_sample(lg, u=uu, impl="torch",  # noqa
                                        **SAMPLED)
    ms = time_ms(kern, [(logits, u)])
    plain_ms = time_ms(plain, [(logits, u)], reps=3, trials=5)
    nbytes = b * V * 2 + b * V * 4 + b * 4
    # per element: scale 1, top-k bisection 48 x (compare, add), filter 1,
    # max 1, exp + sum 2, live min 1, top-p bisection 48 x (compare, add),
    # filter 1, Gumbel (2 logs, add, compare) 4
    ops = b * V * (1 + 96 + 1 + 1 + 2 + 1 + 96 + 1 + 4)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    return {"name": "fused_sample", "route": "cuda",
            "source": "apex_tpu_torch/csrc/fused_sample.cu",
            "replaces": "apex_tpu/ops/pallas/sampling.py:150",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations"),
            "library_ms": None,
            "library_note": "no single PyTorch call computes temperature + "
                            "top-k + top-p + a draw on given noise",
            "timed_shape": {"rows": b, "vocab": V, "dtype": "bf16",
                            **SAMPLED}}


def build_trace(seed=2, n_req=16, vocab=32768, sys_len=256):
    """16 requests, all arriving at t=0: half open with one of two shared
    256-token system prompts, the rest with a fresh 256-token prefix; a
    64-512-token tail; 16-128 new tokens (bench.py's serve trace shape)."""
    from apex_tpu_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, sys_len).astype(np.int32)
                   for _ in range(2)]
    out = []
    for i in range(n_req):
        tail = rng.integers(0, vocab, int(rng.integers(64, 513))).astype(
            np.int32)
        head = (sys_prompts[int(rng.integers(2))] if rng.random() < 0.5
                else rng.integers(0, vocab, sys_len).astype(np.int32))
        out.append(Request(rid=i, prompt=np.concatenate([head, tail]),
                           max_new_tokens=int(rng.integers(16, 129))))
    return out


def serve(torch, model, params, dev, *, gen_seed=None, impl="auto",
          **engine_kw):
    from apex_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, device=dev, impl=impl, **ENGINE, **engine_kw)
    sched = eng.make_scheduler()
    reqs = build_trace()
    gen = (None if gen_seed is None
           else torch.Generator(device=dev).manual_seed(gen_seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.serve(params, reqs, scheduler=sched, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == len(reqs), "serve lost requests")
    for r in done:
        check(len(r.tokens) == r.max_new_tokens, f"request {r.rid} "
              f"generated {len(r.tokens)} of {r.max_new_tokens} tokens")
        check(all(0 <= t < MODEL["vocab_size"] for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    sched.allocator.check_accounting()
    check(sched.allocator.num_live == sched.allocator.num_resident,
          "blocks live beyond the prefix cache's residents after drain")
    st = eng.last_stats
    info = {"requests": len(done),
            "tokens": sum(len(r.tokens) for r in done),
            "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in done) / wall,
            "decode_steps": st.decode_steps,
            "prefill_chunks": st.prefill_chunks,
            "decode_step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
            "prefill_chunk_ms": 1e3 * st.prefill_s / max(st.prefill_chunks,
                                                         1),
            "preemptions": sched.preemptions,
            "prefix_hit_blocks": sum(r.prefix_hit_blocks for r in done),
            "blocks_high_water": st.blocks_high_water}
    return {r.rid: list(r.tokens) for r in done}, info


def phase_profile(torch, model, params, dev, wall_s):
    """Where the time goes in a greedy serve: torch.profiler's device time
    by kernel, and its sum against the unprofiled serve's wall time (one
    stream, so kernels never overlap: the sum is the device-busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(torch, model, params, dev)
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6
    return {"device_busy_s": busy_s, "serve_wall_s": wall_s,
            "device_busy_share": busy_s / wall_s,
            "device_launches": sum(k[1] for k in kernels),
            "top": [{"kernel": name[:90], "device_s": t / 1e6,
                     "launches": n} for t, n, name in kernels[:6]]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import apex_tpu_torch
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import decode_attention as dmod
    from apex_tpu_torch.ops import sampling as smod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit("env", apex_tpu_torch.env_report())

    # --- build ----------------------------------------------------------------
    _build.library_path().unlink(missing_ok=True)  # build from the sources
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", {"seconds": build_s, "library": str(
        _build.library_path().relative_to(ROOT)), "ptxas": ptxas})

    # --- each kernel against its plain version --------------------------------
    kernels = [phase_decode_kernel(torch, dev),
               phase_sample_kernel(torch, dev)]
    for k in kernels:
        emit("kernel", k)

    # --- the main path --------------------------------------------------------
    model = GPTModel(GPTConfig(**MODEL, dtype=torch.bfloat16))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    # warm-up: library handles and allocator, outside every count
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.serving.scheduler import Request
    warm = ServingEngine(model, device=dev, **ENGINE, **SAMPLED)
    warm.serve(params, [Request(rid=0, prompt=np.arange(300, dtype=np.int32),
                                max_new_tokens=4)],
               generator=torch.Generator(device=dev).manual_seed(9))

    dmod.paged_decode_attn_cuda.launches = 0
    smod.fused_sample_cuda.launches = 0
    greedy, g_info = serve(torch, model, params, dev)
    g_dec = dmod.paged_decode_attn_cuda.launches
    g_smp = smod.fused_sample_cuda.launches
    sampled, s_info = serve(torch, model, params, dev, gen_seed=1,
                            **SAMPLED)
    launches = {"paged_decode_attn": dmod.paged_decode_attn_cuda.launches,
                "fused_sample": smod.fused_sample_cuda.launches}
    emit("serve_greedy", g_info)
    emit("serve_sampled", s_info)
    L = MODEL["num_layers"]
    check(g_info["preemptions"] > 0, "the greedy serve preempted nothing")
    check(g_info["prefix_hit_blocks"] > 0, "the greedy serve had no "
          "prefix-cache hits")
    check(g_dec == g_info["decode_steps"] * L,
          f"greedy serve: {g_dec} paged-decode launches for "
          f"{g_info['decode_steps']} decode steps x {L} layers")
    check(g_smp == 0, "greedy serve launched the sampling kernel")
    check(launches["paged_decode_attn"] - g_dec
          == s_info["decode_steps"] * L,
          "sampled serve: paged-decode launches != decode steps x layers")
    check(launches["fused_sample"]
          == s_info["decode_steps"] + s_info["prefill_chunks"],
          f"sampled serve: {launches['fused_sample']} sampling launches "
          f"for {s_info['decode_steps']} decode steps + "
          f"{s_info['prefill_chunks']} prefill chunks")
    check(any(t != greedy[r] for r, t in sampled.items()),
          "the sampled serve reproduced the greedy tokens")

    # --- outside the counted window -------------------------------------------
    again, _ = serve(torch, model, params, dev)
    check(again == greedy, "greedy serve not reproducible on a fresh engine")
    plain, p_info = serve(torch, model, params, dev, impl="torch")
    same = sum(plain[r] == greedy[r] for r in greedy) / len(greedy)
    emit("serve_plain_path", {"share_of_requests_token_identical": same,
                              "tokens_per_s": p_info["tokens_per_s"],
                              "decode_step_ms": p_info["decode_step_ms"]})

    emit("profile", phase_profile(torch, model, params, dev,
                                  g_info["wall_s"]))

    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
