#!/usr/bin/env python3
"""chip_smoke.py — drive apex_tpu_torch's serving path, its decode engine
(with speculative decoding), its GPT-medium train step (also with GPT-2's
dropout 0.1, under each remat policy, and under amp at fp16: O2 with fp32
master weights and the dynamic loss scaler, and O1), its T5-base train
step (with the bucketed and the materialised relative bias, and under
``remat_policy="encode_only"``), its
BERT-large padded MLM train step, the three train steps again on the
models' default softmax attention route, and the fused-dense block and
MLP train steps, on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 (no
arguments, one card, no network):

    python3 chip_smoke.py [--parent DIR]

Phases, none of whose failures is caught (any failure exits non-zero
without the final line):

1. the toolchain report (``apex_tpu_torch.env_report()``);
2. the CUDA kernels' build from ``apex_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, all started together), timed,
   with ptxas's register/shared-memory report (under ``--parent`` also
   every parent kernel's registers and spills against this tree's, which
   must not differ: ``ptxas_changes``);
3. each kernel against its plain PyTorch version at the slices' shapes in
   bf16 — ``paged_decode_attn`` (8 slots, MHA and GQA, block 128, d 128,
   41 blocks, permuted tables, ragged lengths with 0; each row's walk
   split over a cluster of S CTAs by the host's plan, which is printed
   with the instance's registers and spills (``decode_plan``); output
   bit-identical across two runs; timed at 8 x 512 live rows and at a
   ragged serve-like mix, through ``decode_attention`` and the kernel
   entry alone, the parent's kernel in turns under ``--parent``, and at
   each split 1, 2, 4, 8 beside every length 0, ``decode_sweep``),
   ``fused_sample`` (each row over a cluster of S CTAs by the host's
   plan; the serve's decode step (8, 32768) and prefill chunk (1, 32768)
   at T=0.8 with top-k/top-p on and off, 4 seeds each, tokens
   bit-identical across two runs; timed at both with the serve's knobs,
   the parent's kernel in turns under ``--parent`` (its tokens
   bit-identical to this tree's), and with each knob
   set, ``sample_times``), the flash forward
   and the dK/dV and dQ backward kernels (the train step's b 20, s 1024,
   8 heads of 128, and a GQA case: b 8, s 1000, 2 kv heads) and
   ``xent_stats`` ((20480, 32768) with out-of-range labels), ``ln_fwd``
   and ``ln_bwd`` at every path's norm shape (GPT 20480 x 1024, BERT
   16384 x 1024, T5 65536 and 14592 x 768, decode 16 x 1024; RMSNorm,
   no affine, gamma only, a tail hidden of 1000; dgamma/dbeta
   bit-identical across two runs), ``softmax_fwd`` and ``softmax_bwd`` at
   every path's softmax call (GPT causal 20 x 8 x 1024², BERT's key mask
   32 x 16 x 512², T5's decoder triangle 114², cross 114 x 512 and
   encoder 512², fully masked rows, a 4096-long row; planted faults in
   their outputs must fail the rule, the backward told the forward's mask,
   its dx unchanged by NaN in dy at masked entries; y, mean, rstd and the
   softmax's dx bit-identical across two runs, and under ``--parent`` the
   softmax's y bit-identical to the parent's; ``ln_fwd`` timed at every
   main path's call — the serve's 8 and 256 rows, the decode leg's 16 and
   8192, BERT's, GPT's, T5's two — and at one row, each with its plan
   (``ln_fwd_times``), ``ln_bwd`` at each train path's norm call,
   ``softmax_fwd`` and ``softmax_bwd`` at each of the five softmax calls
   and at the T5 legs' unmasked cross call (``softmax_bwd_times``; after
   the softmax legs, their launches x (time - bound), ``softmax_bwd_gap``),
   with the row kernel's launch shape and ptxas registers and spills, and
   with ``--parent DIR`` the kernels of that checkout — a git archive of
   the parent commit — built into a library of their own and timed in
   turns with this tree's, ``parent_ms``) — with the kernel's
   time (CUDA events, median), the plain version's, a library call's
   where one computes the same function, and the bound (for the two
   flash backward kernels also the pair's time against the bound of the
   one function they replace). The flash backward pair (dQ first: it
   writes delta, which dK/dV reads) runs on its wgmma/TMA variant on
   every path; at every family call of this and the later slices it is
   also checked on the sm80 variant (the first mma.sync pair) by the
   same rules, its dq, dk and dv on wgmma must be bit-identical across
   two runs, two faults each wrapper plants from its inputs (the keys
   of the last 64-row kv tile masked off; the bias left out, where the
   call has one) must fail the rules, and the pair is timed on both
   variants in turns (wgmma, sm80, sm80, wgmma) beside SDPA's backward
   (the ``flash_bwd_ab`` line lists every call, and any where wgmma is
   not the faster). The flash forward runs on its wgmma/TMA variant on
   every path too (one body for the packed, bshd and bh-flat entries),
   and at every family call (GPT packed and GQA, the prefill and the
   ragged GQA bshd, BERT's padded bshd and its GQA case, T5's five calls,
   the four array-bias calls) it is also checked on the sm80 variant
   (the first mma.sync forward) by the same rules, its o and lse on
   wgmma must be bit-identical across two runs, the same two planted
   faults must fail the rules, and it is timed on both variants in turns
   beside SDPA's forward (the ``flash_fwd_ab`` line); so is dbias at its
   four calls (the wgmma kernel on the dQ kernel's delta, its sharing
   rows split into groups summed in a fixed order): the sm80 variant
   within 1e-3, wgmma bit-identical across two runs, the last group of
   sharing rows dropped and the bias left out refused, both variants
   timed in turns beside SDPA's backward with the mask's gradient (the
   ``dbias_ab`` line);
4. the serving path: GPT-medium at full width (bf16, vocab 32768, hidden
   1024, 12 layers, 8 heads of 128; random weights from a seed) served by
   ``ServingEngine`` (8 slots, block 128, chunk 256, 41 blocks — ~60% of
   worst case, so preemption happens) over 16 seeded requests sharing two
   256-token system prompts: a greedy serve, then a sampled one
   (T=0.8, top_k 50, top_p 0.9). The launch counters are zeroed just
   before and read just after, and must equal 12 paged-decode launches
   per decode step, one sampling launch per sampled step and 25
   ``ln_fwd`` launches per model forward (decode step or prefill
   chunk);
5. outside the counted window: the greedy serve again on a fresh engine
   (tokens must be identical), a serve through the plain versions (the
   share of requests with identical tokens is printed; bf16 near-ties may
   flip a token), and a profiled greedy serve (device time by kernel and
   the device-busy share of the serve's wall time);
6. the decode-engine slice, on the serve's model and weights:
   * the bshd flash forward (the prefill's views of the packed projection
     at b 16, s 512, 8 heads of 128, causal, and a ragged GQA case: b 4,
     s 300, 8 heads over 2 kv heads; bit-identical to the packed kernel on
     the same views), the contiguous decode kernel (16 x 8 rows, max_s
     1024, ragged lengths with 0 and 1024, MHA and GQA, and the spec
     leg's batch 1: every split the legs reach; bit-identical across two
     runs; timed at 640 and 513 live rows through ``decode_attention``
     and the entry alone, the parent's in turns, and at each split) and
     both verify kernels (each verify row over a cluster of S CTAs by
     the host's plan, the tree resolved by the last row to arrive;
     greedy and sampled at (1, 5), (1, 9), (4, 5), (4, 9), (1, 33),
     (8, 5) and (8, 9) x V, with forced ties, over 4 seeds; and with
     top-p 0.9 after top-k 50 and alone at (1, 5), (1, 9), (8, 5) and
     (8, 9), on plain logits and on ties that overflow the survivors
     rank 0 gathers, over 2 seeds) against their plain versions,
     verdicts bit-identical across two runs, two planted faults (the
     last rank left out of the merges, row 0's slots never published)
     refused at every shape and mode, and a third (top-p skipped)
     refused at a row whose draft lies outside the nucleus, which the
     sound kernel rejects at every batch row; the card's room for the
     plan's clusters and its shared memory; each shape and mode timed
     (the parent's kernel in turns under ``--parent``, but for top-p,
     which the parent's has not), an empty launch of the plan, the plain
     version, the bound, the plan and the instance's registers and
     spills (``verify_times``);
   * the decode leg of bench.py (batch 16, prompt 512, 128 new tokens):
     with the counters zeroed just before and read just after, 3 timed
     prefills and 3 timed loops of 127 greedy decode steps into one
     cache; 12 flash_fwd_bshd launches per prefill and 12 decode_attn
     launches per step, 25 ln_fwd per prefill and per step; the cache's
     storage must not move and the passes' tokens must agree. Outside
     the window: a sampled generate (must differ), a plain-path
     generate (share of identical tokens printed) and a profiled decode
     loop (device-busy share);
   * the spec leg at batch 1 (a 64-token block repeated 4 times, 64 new
     tokens): the chain with ModelDrafter (the target as its own
     drafter) and NGramDrafter(4), the tree with NGramTreeDrafter(4, 2),
     greedy, then the n-gram chain sampled; each run's verify counter
     zeroed just before and read just after must equal its rounds;
     acceptance, tokens per round, the share of tokens identical to
     plain greedy and the verify launches by mode are printed, and the
     leg's launches x (time - bound) of each verify kernel and mode
     (``spec_verify_gap``);
   * the spec_serve leg (``ServingEngine.serve(draft=...)`` on the
     serve's model, engine and trace): a) NGramDrafter(4), chain; b)
     NGramTreeDrafter(4, 2), tree; c) a PagedModelDrafter (a 2-layer GPT
     at GPT-medium's widths, its own seed; depth 4 x branching 2) whose
     blocks come from the serve's own pool; d) the target as its own
     paged drafter on 2 requests; e) a) and b) sampled at T 0.8, top_k
     50, top_p 0.9; f) c) with the pool lowered until a stream holding
     drafter blocks is preempted; g) b) with an AdaptiveSpecController.
     Each serve's counters zeroed just before and read just after: one
     fused_verify launch per chain round, one fused_verify_tree launch
     per tree round (each a top-p launch when sampled), 12 paged-decode
     launches per plain step and one per drafter layer each drafter step
     (2; the self-drafter's 12), 25 ln_fwd per model forward and 2 x the
     drafter's layers + 1 per drafter step; exact accounting at drain,
     no block live beyond the prefix cache's, no drafter block left.
     Every greedy serve's tokens against the plain greedy serve at the
     same pool size: the share of identical requests, and at each
     divergence the plain path's top-2 logit gap from a teacher-forced
     forward, which must be a near-tie (at most 2^-6 x |top-1|); tokens/s,
     rounds, acceptance, tokens per round, degraded rounds, the leg's
     seconds (``spec_serve``), and its launches x (time - bound) by mode
     (``spec_serve_verify_gap``);
7. the train path: the same GPT-medium in bf16 (flash attention, no
   remat), batch 20 x 1024 seeded tokens, ``loss_fn`` + ``backward`` + one
   ``FusedAdam(lr=1e-4)`` step: a warm-up step, then 10 timed steps with
   the counters zeroed just before and read just after (12 flash
   forward, 12 dK/dV, 12 dQ — every backward launch on the wgmma
   variant — 25 ``ln_fwd``, 25 ``ln_bwd`` and 1 ``xent_stats`` launch
   per step); every loss finite and the last below
   the first; tokens/s, step ms, model TFLOP/s and MFU against the
   card's dense bf16 peak;
8. outside the counted window: one step's loss and gradients on the
   kernel path against the plain path (``impl="torch"``, same weights and
   batch) within stated bounds, and 2 profiled train steps (device time
   by kernel, launches per step, device-busy share);
8b. dropout: each flash family with dropout 0.1 against its
   plain version on the same seed under the bf16 rule, forward and
   backward, lse bit-identical to the dropout-free call's — packed at
   GPT's call, bshd at BERT's with kv_lens, bh-flat at T5's encoder call
   with the bucketed bias (the table gradient), a packed GQA 8/2 case —
   and four planted faults refused on the GQA case (the key of the kv
   head's row, row and column swapped, the mask left out of dK/dV's dS,
   l summed from the dropped p; ``dropout_faults``); the elementwise
   dropout kernel bit-identical to its plain version forward and
   backward in fp32 and bf16, its kept share over the GPT activation
   within 5 binomial sigmas of 0.9 and its fp32-scale fault refused
   (``dropout_kernel_check``); times of each flash kernel with and
   without dropout at GPT's, BERT's and T5's calls, without beside the
   parent's in turns under ``--parent`` (``flash_dropout_times``); then
   the ``gpt_dropout_train`` leg (the train config with dropout 0.1: one
   step kernel vs plain on one set of seeds, 5 timed steps with fresh
   seeds, per step 12 flash forwards, dQ and dK/dV all with dropout and
   24 + 24 dropout-kernel launches asserted; step ms, tokens/s and MFU
   beside the dropout-free leg's) and the ``gpt_remat_policies`` leg
   (each remat policy's loss and gradients against remat off on one set
   of seeds, then 2 steps each: step ms, peak memory, launches); then
   amp: the fp16 instances of the packed flash forward, dQ and
   dK/dV at GPT-medium's calls (20 x 1024 and the flagship's 16 x 1024,
   8 heads of 128, causal), of ``ln_fwd``/``ln_bwd`` at 16384 x 1024
   (fp16 parameters) and of ``xent_stats`` at 16384 x 32768, each by the
   fp16 rule (F16_SLACK) against the fp32 truth and bit-identical across
   two runs, the overflow checks (a dO or dy scaled past fp16's range:
   the plain version's infs, robust to 2^-6 of the scale, are the
   kernel's; inf inputs to the forwards), two planted faults refused at
   every flash call (``bf16_p``: P and dS rounded through bf16, by the
   rule; ``satfinite``: outputs clamped to +-65504, by the overflow
   check), the times of each fp16 instance beside its bf16 one in turns
   and, under ``--parent``, the bf16 ones beside the parent's (within
   1%); the ``amp_o2_fp16_train`` leg (the flagship of
   tools/fp16_and_cp_bench.py: amp.initialize O2 at fp16 over
   FusedAdam(lr 1e-4), the dynamic scaler, batch 16 x 1024, 2 warm-up
   and 20 timed steps with 12/12/12 flash, 25/25 norm and 1 xent_stats
   launches a step all on the fp16 instances; loss and scale
   trajectories, skipped steps, step ms, tokens/s, MFU, peak memory, and
   the bf16 train step's at the same batch), the ``amp_o1_fp16_train``
   leg (O1 at fp16: one step against the plain path and an fp32 truth,
   5 steps with the flash trio on fp16 and the norms and xent_stats on
   fp32) and ``amp_overflow`` (the flagship step from a scale of 2**24:
   skipped steps leave the masters, the model params and Adam's state
   bit-identical, the scale halves, finite steps follow);
9. the T5 slice (T5-base widths, relative position bias, per-block
   remat, batch 128 x (512 in, 114 out)):
   * the bh-flat flash forward, dK/dV (with the fused bucket-table
     gradient) and dQ kernels against their plain versions at the step's
     three attention shapes — encoder self 512 x 512 (bidirectional
     buckets), decoder self 114 x 114 (causal buckets), cross 114 x 512;
     the encoder self and cross calls with kv_lens in [256, 512] and
     without — each timed beside its plain version, SDPA with the
     materialised bias as attn_mask, and its bound; the table's marginal
     cost on both variants;
   * one step at the initial params on a padded batch, kernel path
     against plain path and both against an fp32 truth;
   * a warm-up, then 10 timed steps with the counters zeroed just before
     and read just after (per step 72 flat forward launches — 36
     attention calls, each run again by the remat — 36 dK/dV, 24 of them
     with the table gradient, 36 dQ, all 72 on wgmma, 1 xent_stats, 122
     ln_fwd — 62
     norms, run again by the remat but for the two final ones — and 62
     ln_bwd); losses finite and falling; tokens/s, step ms, model
     TFLOP/s and MFU;
   * the kernel path and the plain path against an fp32 truth again, at
     the params the timed steps left, on their batch;
   * a padded step (encoder lengths in [256, 512]) with the same counts,
     and 2 profiled steps;
   * ``remat_policy="encode_only"`` beside ``"blocks"`` (the whole
     encoder one checkpoint, the decoder not rematted): one step's loss
     and gradients against blocks' and each policy's peak memory, then 2
     steps each (48/36/36/24 flat forward/dK-dV/dQ/table launches a step
     under encode_only);
10. the BERT slice (BERT-large: 24 layers, hidden 1024, 16 heads of 64,
    FFN 4096, vocab 30592, sequence 512, bf16, per-block remat):
    * the bshd forward with per-batch kv_lens, dQ and dK/dV kernels
      against their plain versions at BERT's call (b 32, views of one
      packed projection, lengths in [64, 512] with one full row and one of
      length 0) and at a GQA shape, timed beside the plain versions, SDPA
      with the key-padding mask, and the bounds;
    * one step at the initial params, kernel path against plain path and
      both against an fp32 truth;
    * a warm-up, then 10 timed steps of ``mlm_loss`` + backward + one
      ``FusedAdam(lr=1e-4)`` step on a padded batch 32 x 512 (lengths
      uniform in [64, 512], token types, 15% of the valid positions in the
      loss mask) with 48/24/24/1/97/49 bshd-forward/dQ/dK-dV/xent_stats/
      ln_fwd/ln_bwd launches and no other flash launch per step asserted;
      tokens/s over all and over the valid positions, step ms, TFLOP/s,
      MFU, peak memory, the pad-mask host read's cost; 2 profiled steps;
11. the array bias: the flat forward, dK/dV and dQ with an fp32 bias and
    the dbias kernel against their plain versions (dbias within 1e-3
    relative norm of the fp32 plain version) at T5's encoder call (hb 12,
    padded) and decoder call (causal 114²), and the bshd kernels with one
    bias row; then the T5 materialized leg (``relative_bias_impl=
    "materialized"``): one step against the bucketed path at the same
    params and batch, a warm-up and 3 timed steps with 72 (48 biased) flat
    forwards, 36 (24) dK/dV, 36 (24) dQ and 24 dbias launches per step;
12. the softmax routes (``attention_impl="softmax"``, the reference's
    default): each leg one step at the initial params against the plain
    path and an fp32 truth, a warm-up, then timed steps with the counters
    zeroed just before and read just after and no flash launch allowed —
    GPT-medium (batch 20 x 1024, 5 steps: 12/12 causal softmax, 25/25
    norm, 1 xent_stats launches per step); BERT-large (the BERT leg's
    batch, 10 steps: 48/24 softmax, 97/49 norm, 1 xent_stats; tokens/s,
    MFU, peak memory), then one step on the batch
    with interior holes punched in every pad mask (which the flash route
    refuses): finite loss, the same launches; T5 in both position modes
    (128 x (512, 114), 5 steps: learned 72/36 softmax, relative 24/12 —
    the cross-attention only, the biased self-attention taking the fp32
    composition — and 122/62 norm, 1 xent_stats); each leg ends with 2
    profiled steps (device time by layer, busy share); then one step of
    the GPT route with dropout 0.1 (``gpt_softmax_dropout``), kernel path
    against plain path, with 12/12 softmax and 36/36 dropout-kernel
    launches;
13. the fused-dense and MLP slice (``ops/fused_dense.py``, ``ops/mlp.py``
    over ``matmul_bias_act``, whose bf16 calls take the wgmma/TMA variant
    when a tensor map describes both operands and the kernel's first,
    mma.sync body, the sm80 variant, otherwise):
    * the kernel against its plain version by MATMUL_SLACK's rule (max abs
      error vs the fp32 plain version <= 2x the bf16 plain version's +
      1e-3 x the truth's largest entry; two planted faults — the last K
      block dropped, the bias left out — refused at every call): the
      forward layout with each activation, with and without the bias, at
      the block's up-projection, every call of both legs below (forward,
      dgrad and wgrad layouts; K = 480, N = 1 and K = 1 among them), each
      also on the sm80 variant by the same rule, and the fp32
      instantiation at 300 x 200 x 130 within 1e-5 of the largest entry;
      every leg call planned onto the wgmma variant, and each split-K
      call (the MLP's weight gradients) bit-identical across two runs;
      each leg call timed on the wgmma and the sm80 variant in turns
      (wgmma, sm80, sm80, wgmma) beside its bound (2MNK over 989 TFLOP/s
      against the bytes over 3.35 TB/s), the plain version, torch.addmm
      with the eager activation (torch.mm without a bias) and
      torch._addmm_activation where it covers the activation;
    * the block leg: FusedLayerNorm(1024), FusedDenseGeluDense(1024,
      4096, 1024) and a residual (BASELINE.json line 10 at GPT-medium's
      widths) over 20 x 1024 bf16 tokens, an fp32 MSE, backward and one
      FusedAdam(lr=1e-4) step: one step at the initial params against the
      plain path and an fp32 truth, then 10 timed steps with 6
      matmul_bias_act launches, all 6 on the wgmma variant, 1 ln_fwd and
      1 ln_bwd and nothing else per step; step ms, TFLOP/s against 6 x
      171.8 GFLOP, peak memory, 2 profiled steps;
    * the MLP leg: MLP([480, 1024, 1024, 512, 256, 1], relu) in bf16 at
      batch 32768 (DLRM's top MLP): 10 timed train steps with 15 launches
      a step, all on the wgmma variant, the 5 weight gradients split-K; a
      no-grad forward with 5 wgmma launches (relu in the epilogue), and
      it and the sigmoid forward against the plain version and an fp32
      truth by MATMUL_SLACK's rule; 2 profiled steps;
14. one ``{"kernels": [...]}`` line (all twenty-three kernels and the six
    fp16 instances, ``<name>_f16``, each with
    its launches by main path; matmul_bias_act and the flash kernels
    also by variant, every train leg's, the decode leg's and the T5
    materialized leg's flash forward and dbias launches asserted on
    wgmma; the flash kernels' ``sm80_ms`` from the A/B), the
    card's name and power limit as nvidia-smi prints them, and last
    ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
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
             num_layers=12, num_heads=8, attention_impl="flash")
ENGINE = dict(num_slots=8, block_size=128, prefill_chunk=256, num_blocks=41)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
DECODE_TOL = 2e-2   # bf16 output: a few bf16 ulps at unit scale
NEAR_TIE = 1e-5     # relative gap of the two best perturbed scores
# the nucleus boundary's near-tie: a cumulative mass within this share of
# top_p x z. The kernel sums fixed-point masses (2^-41 each: < 2e-8 of z
# over 32768 entries), the plain version fp32 exps in a pairwise sum (about
# log2(32768) x 2^-24 < 1e-6 relative), so a boundary farther off than
# 1e-6 is decided alike by both
TOP_P_EDGE = 1e-6

# the train slice's configuration (bench.py:2517-2524): GPT-medium, flash
# attention, no remat; batch 20 x 1024 tokens
TRAIN = dict(MODEL, remat=False)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 20, 1024, 10
# the flash kernels' bf16 rule: the truth is the plain version in fp32 on
# the same bf16 inputs; the kernel's max abs error must be at most twice
# the bf16 plain version's own, plus FLASH_SLACK
FLASH_SLACK = 1e-3
VARIANT_NOTE = ("ms: the wgmma/TMA pair (every path's); sm80_ms: the first "
                "mma.sync pair, timed in turns with it in this run")
# the softmax kernels' bf16 rule: their outputs (probabilities near 1/sk,
# gradients near scale/sk) sit far below the flash outputs' unit scale,
# so the slack scales with the output compared: the max abs error vs the
# fp32 truth at most twice the bf16 plain version's + SOFTMAX_SLACK x the
# truth's largest entry, AND the error's norm relative to the truth's at
# most twice the plain version's + SOFTMAX_SLACK. Each call also plants
# faults in the kernel's output (every entry 10% off; the backward
# without its - sum(dy * y) term) and fails unless the rule refuses them
SOFTMAX_SLACK = 1e-3
# kernel path vs plain path over one whole bf16 train step. At random
# init the loss sits near ln V whatever attention does, so the loss bound
# catches little; the gradient bound is the one that separates a faulty
# kernel
TRAIN_LOSS_TOL = 1e-4   # relative difference of the two losses
TRAIN_GRAD_TOL = 5e-2   # each gradient leaf's relative norm error

# the T5 slice: the widths of the repo's own T5 training script
# (tools/t5_relative_bench.py:21-25: hidden 768, FFN 3072, 12 + 12 layers,
# vocab 32128, bf16, relative bias, per-block remat), the heads and
# buckets of the public t5-base (12 heads of 64, 32 buckets, max distance
# 128), and T5's span-corruption lengths: batch 128 x (512 in, 114 out)
T5 = dict(vocab_size=32128, max_seq_len=512, hidden_size=768,
          ffn_hidden_size=3072, num_encoder_layers=12, num_decoder_layers=12,
          num_heads=12, remat=True, position_encoding="relative",
          relative_num_buckets=32, relative_max_distance=128,
          attention_impl="flash")
T5_BATCH, T5_ENC, T5_DEC, T5_STEPS = 128, 512, 114, 10
T5_PAD_MIN = 256        # padded batches: encoder lengths in [256, 512]
T5_DTABLE_TOL = 1e-3    # bucket-table gradient: relative norm error
# ``--parent DIR``: that checkout's row-wise, decode, sampling and verify
# kernels, built into a library of their own, (library, ptxas log); None
# without it
PARENT = None
# registers and spills of every kernel of this run's build, by name
PTXAS = {}
# this tree's ln_fwd, sampling and verify kernels returning at once
# (rowwise_ab.empty_library): the fixed cost of their launches
EMPTY = None


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


def decode_plan_info(torch, q3, nb, bs, paged):
    """The split plan of a decode call on q (rows, group, d): S (the
    cluster's size), the ring's tiles, the CTAs, the shared memory, how
    many such clusters the card holds at once, and the instance's
    registers and spills (ptxas)."""
    from apex_tpu_torch.ops import decode_attention as D

    rows, group, d = q3.shape
    plan = D._plan_for(q3, nb, bs)
    clusters = D.max_active_clusters(plan, q3.dtype, d, group, bs, paged)
    check(clusters >= 1, f"the card holds no cluster of the decode plan "
          f"{plan}")
    dtype = "__nv_bfloat16" if q3.dtype == torch.bfloat16 else "float"
    return {"rows": rows, "group": group, "blocks": nb, "block_rows": bs,
            "splits": plan.splits, "cluster": [plan.splits, 1, 1],
            "ctas": rows * plan.splits, "tiles": plan.tiles,
            "smem_bytes": plan.smem, "max_active_clusters": clusters,
            "ptxas": ptxas_of("decode_kernel", (dtype, str(d), str(group),
                                                "true" if paged else
                                                "false"))}


def decode_split_sweep(torch, fn, sets, zero_sets, q3, nb, bs, what):
    """``fn``'s device time at each split S (1, 2, 4, 8) with the ring
    the plan gives that S, on ``sets`` and on ``zero_sets`` (every length
    0: the launch's fixed cost at that S) — what the plan's choice of S
    rests on; the ``decode_sweep`` line."""
    from apex_tpu_torch.ops import decode_attention as D

    rows, group, d = q3.shape
    sms = torch.cuda.get_device_properties(q3.device).multi_processor_count
    plan_s = D._plan_for(q3, nb, bs).splits
    saved, per_split = D._plan_for, {}
    try:
        for s in D.DECODE_SPLITS:
            plan = D.plan_at(rows, nb, bs, d, group, q3.dtype, sms, s)
            D._plan_for = lambda *_, plan=plan: plan
            per_split[f"S{s}"] = {"tiles": plan.tiles,
                                  "ms": time_ms(fn, sets),
                                  "empty_ms": time_ms(fn, zero_sets)}
    finally:
        D._plan_for = saved
    out = {"call": what, "plan_splits": plan_s, "per_split": per_split}
    emit("decode_sweep", out)
    return out


def decode_repeat_check(torch, got, again, what):
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: not bit-identical across two "
          f"runs")


def phase_decode_kernel(torch, dev):
    """The paged decode kernel against its plain version at the serve
    leg's shape (8 slots, MHA: 64 rows, the plan's S) and GQA (16 rows),
    ragged lengths with 0, bit-identical across two runs; its plan; times
    with every slot at 512 live rows and at a ragged serve-like mix, each
    through ``decode_attention`` (what the path launches) and the kernel
    entry alone, with the parent's kernel in turns under ``--parent``; and
    at 8 x 512 at each split (``decode_split_sweep``)."""
    from apex_tpu_torch.ops import decode_attention as D
    import torch.nn.functional as F

    ragged = [0, 1, 127, 128, 129, 300, 512, 1000]
    err, plans = 0.0, {}
    for h_kv in (8, 2):  # MHA, then GQA
        for (q, pk, pv, lens, tables) in decode_case(torch, dev, h_kv,
                                                     ragged, seed=h_kv):
            got = D.decode_attention(q, pk, pv, lens, block_tables=tables)
            again = D.decode_attention(q, pk, pv, lens, block_tables=tables)
            want = D.decode_attention(q, pk, pv, lens, block_tables=tables,
                                      impl="torch")
            decode_repeat_check(torch, got, again, "paged decode kernel")
            e = (got.float() - want.float()).abs().max().item()
            check(torch.isfinite(got.float()).all().item(),
                  "paged decode kernel output not finite")
            check(not got[lens == 0].any().item(),
                  "paged decode kernel: length-0 slot not zeros")
            q3 = q.reshape(8 * h_kv, 8 // h_kv, 128)
            plans[f"h_kv={h_kv}"] = decode_plan_info(torch, q3, 8, 128,
                                                     True)
            emit("decode_check", {"h_kv": h_kv, "lengths": ragged,
                                  "splits": plans[f"h_kv={h_kv}"]["splits"],
                                  "max_abs_err": e, "tol": DECODE_TOL})
            check(e <= DECODE_TOL, f"paged decode kernel vs plain: max abs "
                  f"err {e} > {DECODE_TOL} (h_kv={h_kv})")
            err = max(err, e)
    emit("decode_plan", {"kernel": "paged_decode_attn", "plans": plans})

    b, h, d, scale = 8, 8, 128, 128 ** -0.5
    kern = lambda *a: D.decode_attention(*a[:4], block_tables=a[4])  # noqa
    entry = lambda q, pk, pv, lens, t: D.paged_decode_attn_cuda(  # noqa
        q.reshape(b * 8, 1, d), pk, pv, lens, t, scale=scale)
    per_shape = {}
    # every slot at 512 live rows (MHA), and a ragged serve-like mix; six
    # pool copies in turn
    for what, lengths in (("serve_512", [512] * 8),
                          ("ragged", [330, 1000, 512, 640, 384, 896, 600,
                                      350])):
        sets = decode_case(torch, dev, 8, lengths, seed=3, copies=6)
        ms, parent_ms = parent_turns(torch, kern, sets)
        entry_ms, parent_entry_ms = parent_turns(torch, entry, sets)
        live = sum(lengths)
        bms, by = bound(2 * b * h * d * 2           # q in, out
                        + 2 * live * 8 * d * 2      # live K and V, once
                        + b * 8 * 4 + b * 4,        # tables, lengths
                        4 * live * h * d, BF16_OPS_PER_S)
        per_shape[what] = {"lengths": lengths, "ms": ms,
                           "parent_ms": parent_ms, "entry_ms": entry_ms,
                           "parent_entry_ms": parent_entry_ms,
                           "bound_ms": bms, "bound_by": by}
        emit("decode_times", dict(per_shape[what], call=what))
        if what == "serve_512":
            serve_sets, serve_bound = sets, (bms, by)
    sweep = decode_split_sweep(
        torch, kern, serve_sets,
        decode_case(torch, dev, 8, [0] * 8, seed=3, copies=6),
        serve_sets[0][0].reshape(b * 8, 1, d), 8, 128, "serve_512")

    def library(q, pk, pv, lens, tables):
        k = D._gather_blocks(pk, tables)
        v = D._gather_blocks(pv, tables)
        mask = (torch.arange(k.shape[2], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                              attn_mask=mask)

    plain = lambda *a: D.decode_attention(*a[:4], block_tables=a[4],  # noqa
                                          impl="torch")
    serve = per_shape["serve_512"]
    return {"name": "paged_decode_attn", "route": "cuda",
            "source": "apex_tpu_torch/csrc/paged_decode_attn.cu",
            "replaces": "apex_tpu/ops/pallas/decode_attention.py:211",
            "max_abs_err": err, "ms": serve["ms"],
            "parent_ms": serve["parent_ms"],
            "plain_ms": time_ms(plain, serve_sets, reps=5),
            "bound_ms": serve_bound[0], "bound_by": serve_bound[1],
            "library_ms": time_ms(library, serve_sets, reps=5),
            "kernel_note": "each row's walk split over a cluster of S CTAs "
                           "(decode_plan), blocks by the bulk-copy engine; "
                           "parent_ms: the parent commit's kernel in turns "
                           "(--parent)",
            "timed_shape": {"slots": b, "heads": h, "kv_heads": 8,
                            "head_dim": d, "block": 128,
                            "live_rows_per_slot": 512, "dtype": "bf16"},
            "plan": plans["h_kv=8"], "split_sweep": sweep,
            "per_shape": per_shape}


def sample_case(torch, dev, b, V, seed):
    """bf16 logits (randn x 3) and fp32 noise in [tiny, 1) of (b, V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = (torch.randn((b, V), generator=g, device=dev) * 3.0).bfloat16()
    u = torch.rand((b, V), generator=g, device=dev).clamp_min(
        torch.finfo(torch.float32).tiny)
    return logits, u


# the sampler's knob sets (top_k, top_p) at T 0.8: none, top-k, top-p, both
SAMPLE_KNOBS = [(0, 1.0), (50, 1.0), (0, 0.9), (50, 0.9)]


def phase_sample_kernel(torch, dev):
    """The sampling kernel against its plain version at the serve's decode
    step (8 rows) and prefill chunk (1 row), V 32768, over 4 seeds x 4 knob
    sets: no token mismatch outside near-ties (at most 1% of rows
    excluded), tokens bit-identical across two runs and, under
    ``--parent``, to the parent's kernel's; the plans and the card's room
    for their clusters; times at (8, V) and (1, V) with the serve's knobs,
    the parent's kernel in turns under ``--parent`` (``within_3pct_of_
    parent``), a copy
    of the kernel that returns at once on the same clusters (``empty_ms``)
    and each knob set (``none``: the loads, one cluster barrier and the
    draw)."""
    from apex_tpu_torch.ops import sampling as SM
    from apex_tpu_torch.ops.matmul import _sm_count
    from apex_tpu_torch.tools import rowwise_ab

    V = MODEL["vocab_size"]
    mismatches = ties_total = rows = 0
    err = 0
    for b in (8, 1):
        for seed in range(4):
            logits, u = sample_case(torch, dev, b, V, 100 + 10 * b + seed)
            for top_k, top_p in SAMPLE_KNOBS:
                kw = dict(temperature=0.8, top_k=top_k, top_p=top_p, u=u)
                got = SM.fused_sample(logits, **kw)
                again = SM.fused_sample(logits, **kw)
                check(torch.equal(got, again), f"fused_sample not "
                      f"bit-reproducible at b {b}, knobs {top_k, top_p}")
                if PARENT is not None:  # the kernel's results unchanged
                    with rowwise_ab.using(PARENT[0]):
                        before = SM.fused_sample(logits, **kw)
                    check(torch.equal(got, before), f"fused_sample differs "
                          f"from the parent's at b {b}, knobs "
                          f"{top_k, top_p}")
                want = SM.fused_sample(logits, impl="torch", **kw)
                s = SM.filtered_scaled(logits, temperature=0.8, top_k=top_k,
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

    sms = _sm_count(torch.cuda.current_device())
    per_shape = {}
    for b in (8, 1):
        sets = [sample_case(torch, dev, b, V, 7 + b)]
        plan = SM._sample_plan(b, V, sms)
        clusters = SM.max_active_clusters(plan, torch.bfloat16, V)
        check(clusters > 0, f"the card holds no cluster of the sampling "
              f"plan {plan}")
        kern = lambda lg, uu: SM.fused_sample(lg, u=uu, **SAMPLED)  # noqa
        ms, parent_ms = parent_turns(torch, kern, sets)
        with rowwise_ab.using(EMPTY):
            empty_ms = time_ms(kern, sets)
        knobs = {}
        for top_k, top_p in SAMPLE_KNOBS:
            kw = dict(temperature=0.8, top_k=top_k, top_p=top_p)
            name = ("none" if not top_k and top_p == 1.0 else
                    f"top_k {top_k}" if top_p == 1.0 else
                    f"top_p {top_p}" if not top_k else "both")
            knobs[name] = time_ms(lambda lg, uu: SM.fused_sample(
                lg, u=uu, **kw), sets)
        nbytes = b * V * 2 + b * V * 4 + b * 4
        # per value: the scale, its key and the largest key 3, four
        # top-k rounds (prefix compare, bin, count) 12, the Gumbel term (2
        # logs, an add) 3, the draw 2; top-p over the 50 live entries
        # top-k leaves: each entry's exp and mass against every other's
        ops = b * V * 20 + b * (2 * 50 * 50 + 50)
        bms, by = bound(nbytes, ops, FP32_OPS_PER_S)
        per_shape[f"b{b}"] = {
            "rows": b, "vocab": V, "ms": ms, "parent_ms": parent_ms,
            "within_3pct_of_parent": (None if parent_ms is None
                                      else ms <= 1.03 * parent_ms),
            "empty_ms": empty_ms, "knobs_ms": knobs,
            "plain_ms": time_ms(lambda lg, uu: SM.fused_sample(
                lg, u=uu, impl="torch", **SAMPLED), sets, reps=3, trials=5),
            "bound_ms": bms, "bound_by": by,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops / FP32_OPS_PER_S * 1e3,
            "plan": plan._asdict(), "max_active_clusters": clusters,
            "ptxas": ptxas_of("fused_sample_kernel", ("__nv_bfloat16",
                                                      str(plan.values)))}
        emit("sample_times", dict(per_shape[f"b{b}"], **SAMPLED))
    serve = per_shape["b8"]
    return {"name": "fused_sample", "route": "cuda",
            "source": "apex_tpu_torch/csrc/fused_sample.cu",
            "replaces": "apex_tpu/ops/pallas/sampling.py:156",
            "max_abs_err": err, "ms": serve["ms"],
            "parent_ms": serve["parent_ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes temperature + "
                            "top-k + top-p + a draw on given noise",
            "kernel_note": "each row over a cluster of the plan's CTAs, "
                           "radix-select thresholds; parent_ms: the parent "
                           "commit's kernel in turns (--parent)",
            "timed_shape": {"rows": 8, "vocab": V, "dtype": "bf16",
                            **SAMPLED},
            "plan": serve["plan"], "per_shape": per_shape}


def bound(nbytes, ops, ops_per_s):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def flash_case(torch, dev, b, s, h, h_kv, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, (h + 2 * h_kv) * d), generator=g,
                      device=dev).bfloat16()
    do = torch.randn((b, s, h * d), generator=g, device=dev).bfloat16()
    return qkv, do


def rule_check(name, got, plain, truth, shape, tag="flash_check"):
    """The kernels' bf16 rule (see FLASH_SLACK); returns the kernel's max
    abs error against the fp32 truth."""
    err = (got.float() - truth.float()).abs().max().item()
    err_plain = (plain.float() - truth.float()).abs().max().item()
    tol = 2 * err_plain + FLASH_SLACK
    emit(tag, {"output": name, "shape": shape, "max_abs_err": err,
                         "plain_bf16_err": err_plain, "tol": tol})
    check(err <= tol, f"{name} kernel vs plain: max abs err {err} > {tol} "
          f"at {shape}")
    return err


# the flash backward pair's faults each wrapper plants from its inputs on
# request (the keys from the last 64-row kv tile on masked off; the array
# or bucketed bias left out): the rules must refuse both at every call
BWD_FAULTS = ("drop_last_kv_tile", "drop_bias")
# each family call's pair on both variants, in turns, beside SDPA's
# backward: emitted as flash_bwd_ab at the end
BWD_AB = []


def rule_ok(got, plain, truth):
    """The flash rule without raising: (ok, err, tol)."""
    err = (got.float() - truth.float()).abs().max().item()
    err_plain = (plain.float() - truth.float()).abs().max().item()
    tol = 2 * err_plain + FLASH_SLACK
    return err <= tol, err, tol


def bwd_wrappers(layout):
    """The layout's dQ and dK/dV wrappers ("packed", "bhsd", "bshd")."""
    from apex_tpu_torch.ops import attention as A

    return {"packed": (A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda),
            "bhsd": (A.flash_bwd_flat_dq_cuda, A.flash_bwd_flat_dkv_cuda),
            "bshd": (A.flash_bwd_bshd_dq_cuda,
                     A.flash_bwd_bshd_dkv_cuda)}[layout]


def run_pair(layout, args, kw, variant=None, fault=None):
    """The backward pair through its wrappers, dQ first (it writes delta,
    which dK/dV reads): (dq, dk, dv, the table gradient or None)."""
    dq_fn, dkv_fn = bwd_wrappers(layout)
    dq, delta = dq_fn(*args, variant=variant, planted_fault=fault, **kw)
    out = dkv_fn(*args, delta=delta, variant=variant, planted_fault=fault,
                 **kw)
    return (dq, *out, None)[:4]


def pair_checks(torch, layout, args, kw, plain, truth, shape, tag):
    """One family call's pair beyond the dispatcher's wgmma check: the
    sm80 variant by the same rules; dq, dk and dv on wgmma bit-identical
    across two runs; each planted fault (the bias one where the call has
    a bias) refused on wgmma. ``plain``/``truth``: the plain backward's
    (dq, dk, dv, ...) in bf16 and fp32; the table gradient is held to
    T5_DTABLE_TOL of the plain version's."""
    table = plain[3] if kw.get("rel_bias") is not None else None

    def table_err(got):
        return ((got[3] - table).norm() / table.norm()).item()

    got = run_pair(layout, args, kw, "sm80")
    torch.cuda.synchronize()
    for name, g_, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
        check(torch.isfinite(g_.float()).all().item(),
              f"{tag} {name} sm80 output not finite at {shape}")
        rule_check(f"{tag} {name} sm80", g_, p_, t_, shape)
    if table is not None:
        rel = table_err(got)
        check(rel <= T5_DTABLE_TOL, f"{tag} dtable sm80 vs plain: rel norm "
              f"err {rel} at {shape}")
    first = run_pair(layout, args, kw)
    second = run_pair(layout, args, kw)
    same = all(bool(torch.equal(a, b)) for a, b in zip(first[:3],
                                                       second[:3]))
    check(same, f"{tag}: dq, dk or dv on wgmma differs between two runs at "
          f"{shape}")
    del got, first, second
    has_bias = kw.get("bias") is not None or table is not None
    planted = {}
    for fault in BWD_FAULTS[:2 if has_bias else 1]:
        bad = run_pair(layout, args, kw, fault=fault)
        torch.cuda.synchronize()
        over = [rule_ok(g_, p_, t_) for g_, p_, t_ in zip(bad[:3], plain,
                                                           truth)]
        ratio = max(e / t for _, e, t in over)
        refused = not all(ok for ok, _, _ in over)
        if table is not None:
            ratio = max(ratio, table_err(bad) / T5_DTABLE_TOL)
            refused = refused or table_err(bad) > T5_DTABLE_TOL
        planted[fault] = ratio
        check(refused, f"{tag}: the rules let the planted fault '{fault}' "
              f"through at {shape}")
        del bad
    emit("flash_pair_check", {"call": tag, "shape": shape,
                              "sm80_within_rules": True,
                              "wgmma_bit_identical": same,
                              "planted_fault_err_over_tol": planted})


def ab_times(torch, layout, args, kw, family, sdpa_bwd_ms):
    """The pair's device times on both variants in turns (wgmma, sm80,
    sm80, wgmma): each kernel's mean over its two turns, and the pair's.
    Logged with SDPA's backward time for flash_bwd_ab."""
    dq_fn, dkv_fn = bwd_wrappers(layout)

    def once(variant):
        dq_ms = time_ms(lambda: dq_fn(*args, variant=variant, **kw), [()])
        _, delta = dq_fn(*args, variant=variant, **kw)
        dkv_ms = time_ms(lambda: dkv_fn(*args, delta=delta, variant=variant,
                                        **kw), [()])
        return dq_ms, dkv_ms

    turns = [once(v) for v in ("wgmma", "sm80", "sm80", "wgmma")]
    out = {"turns_ms": turns}
    for v, (i, j) in (("wgmma", (0, 3)), ("sm80", (1, 2))):
        dq_ms = (turns[i][0] + turns[j][0]) / 2
        dkv_ms = (turns[i][1] + turns[j][1]) / 2
        out[v] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms, "pair_ms": dq_ms + dkv_ms}
    BWD_AB.append({"family": family, "wgmma_ms": out["wgmma"]["pair_ms"],
                   "sm80_ms": out["sm80"]["pair_ms"],
                   "sdpa_bwd_ms": sdpa_bwd_ms})
    return out


# each family call's forward on both variants, in turns, beside SDPA's
# forward, and each dbias call's kernel beside SDPA's backward with the
# mask's gradient: emitted as flash_fwd_ab and dbias_ab at the end
FWD_AB = []
DBIAS_AB = []
FWD_VARIANT_NOTE = ("ms: the wgmma/TMA forward (every path's); sm80_ms: "
                    "the first mma.sync forward, timed in turns with it in "
                    "this run")
DBIAS_VARIANT_NOTE = ("ms: the wgmma/TMA dbias kernel (every path's, on the "
                      "dQ kernel's delta); sm80_ms: the first mma.sync "
                      "kernel, timed in turns with it in this run")


def fwd_wrapper(layout):
    """The layout's forward wrapper ("packed", "bhsd", "bshd")."""
    from apex_tpu_torch.ops import attention as A

    return {"packed": A.flash_fwd_cuda, "bhsd": A.flash_fwd_flat_cuda,
            "bshd": A.flash_fwd_bshd_cuda}[layout]


def fwd_checks(torch, layout, args, kw, plain, truth, shape, tag):
    """One family call's forward beyond the dispatcher's wgmma check: the
    sm80 variant by the same rules; o and lse on wgmma bit-identical
    across two runs; each planted fault (the last 64-row kv tile dropped,
    and the bias left out where the call has one) refused on wgmma.
    ``plain``/``truth``: the plain forward's (o, lse) in bf16 and fp32."""
    fn = fwd_wrapper(layout)
    got = fn(*args, variant="sm80", **kw)
    torch.cuda.synchronize()
    for name, g_, p_, t_ in zip(("o", "lse"), got, plain, truth):
        check(torch.isfinite(g_.float()).all().item(),
              f"{tag} {name} sm80 output not finite at {shape}")
        rule_check(f"{tag} {name} sm80", g_, p_, t_, shape)
    first = fn(*args, **kw)
    second = fn(*args, **kw)
    same = all(bool(torch.equal(a, b)) for a, b in zip(first, second))
    check(same, f"{tag}: o or lse on wgmma differs between two runs at "
          f"{shape}")
    del got, first, second
    has_bias = kw.get("bias") is not None or kw.get("rel_bias") is not None
    planted = {}
    for fault in BWD_FAULTS[:2 if has_bias else 1]:
        bad = fn(*args, planted_fault=fault, **kw)
        torch.cuda.synchronize()
        over = [rule_ok(g_, p_, t_) for g_, p_, t_ in zip(bad, plain, truth)]
        planted[fault] = max(e / t for _, e, t in over)
        check(not all(ok for ok, _, _ in over), f"{tag}: the rules let the "
              f"planted forward fault '{fault}' through at {shape}")
        del bad
    emit("flash_fwd_check", {"call": tag, "shape": shape,
                             "sm80_within_rules": True,
                             "wgmma_bit_identical": same,
                             "planted_fault_err_over_tol": planted})


def fwd_ab_times(torch, layout, arg_sets, kw, family, sdpa_fwd_ms):
    """The forward's device times on both variants in turns (wgmma, sm80,
    sm80, wgmma), cycling through ``arg_sets``: each variant's mean over
    its two turns, logged with SDPA's forward time for flash_fwd_ab."""
    fn = fwd_wrapper(layout)
    turns = [time_ms(lambda *a: fn(*a, variant=v, **kw), arg_sets)
             for v in ("wgmma", "sm80", "sm80", "wgmma")]
    out = {"wgmma": (turns[0] + turns[3]) / 2,
           "sm80": (turns[1] + turns[2]) / 2, "turns_ms": turns}
    FWD_AB.append({"family": family, "wgmma_ms": out["wgmma"],
                   "sm80_ms": out["sm80"], "sdpa_fwd_ms": sdpa_fwd_ms})
    return out


def dbias_checks(torch, layout, args, kw, truth, shape, tag):
    """One dbias call beyond the dispatcher's wgmma check (on the dQ
    kernel's delta): the sm80 variant within DBIAS_TOL; wgmma bit-identical
    across two runs; both planted faults (the last group of sharing rows
    dropped, the bias left out of p) refused. ``args``: (q, k, v, o, lse,
    do, bias); ``truth``: the fp32 plain version's dbias."""
    from apex_tpu_torch.ops import attention as A

    dkw = dict(scale=kw["scale"], causal=kw["causal"],
               kv_lens=kw.get("kv_lens"), layout=layout)

    def rel(got):
        return ((got - truth).norm() / truth.norm()).item()

    err = rel(A.flash_bwd_dbias_cuda(*args, variant="sm80", **dkw))
    check(err <= DBIAS_TOL, f"{tag} dbias sm80 vs the fp32 plain version: "
          f"rel norm err {err} > {DBIAS_TOL} at {shape}")
    first = A.flash_bwd_dbias_cuda(*args, **dkw)
    second = A.flash_bwd_dbias_cuda(*args, **dkw)
    same = bool(torch.equal(first, second))
    check(same, f"{tag}: dbias on wgmma differs between two runs at {shape}")
    planted = {}
    for fault in A.DBIAS_FAULTS:
        planted[fault] = rel(A.flash_bwd_dbias_cuda(
            *args, planted_fault=fault, **dkw)) / DBIAS_TOL
        check(planted[fault] > 1, f"{tag}: the dbias rule let the planted "
              f"fault '{fault}' through at {shape}")
    emit("flash_dbias_check", {"call": tag, "shape": shape,
                               "sm80_rel_norm_err": err,
                               "wgmma_bit_identical": same,
                               "planted_fault_err_over_tol": planted})


def dbias_ab_times(torch, layout, args, kw, delta, family, sdpa_ms):
    """dbias's device times on both variants in turns (wgmma on the given
    delta, sm80, sm80, wgmma), logged with SDPA's backward with the mask's
    gradient for dbias_ab."""
    from apex_tpu_torch.ops import attention as A

    dkw = dict(scale=kw["scale"], causal=kw["causal"],
               kv_lens=kw.get("kv_lens"), layout=layout, delta=delta)
    turns = [time_ms(lambda: A.flash_bwd_dbias_cuda(*args, variant=v,
                                                    **dkw), [()])
             for v in ("wgmma", "sm80", "sm80", "wgmma")]
    out = {"wgmma": (turns[0] + turns[3]) / 2,
           "sm80": (turns[1] + turns[2]) / 2, "turns_ms": turns}
    DBIAS_AB.append({"family": family, "wgmma_ms": out["wgmma"],
                     "sm80_ms": out["sm80"], "sdpa_bwd_with_mask_grad_ms":
                     sdpa_ms})
    return out


def phase_flash_kernels(torch, dev):
    """The flash forward and the dK/dV and dQ kernels against the plain
    version at the train step's shape and at a ragged GQA shape (the pair
    on both variants, its planted faults, wgmma's determinism); times at
    the train step's shape, the pair on both variants in turns."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    d = 128
    kw = dict(scale=d ** -0.5, causal=True)
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    fwd_ab = {}
    for b, s, h, h_kv in ((TRAIN_BATCH, TRAIN_SEQ, 8, 8), (8, 1000, 8, 2)):
        shape = {"b": b, "s": s, "h": h, "h_kv": h_kv, "d": d}
        qkv, do = flash_case(torch, dev, b, s, h, h_kv, d, seed=s + h_kv)
        o, lse = A.flash_fwd_packed(qkv, h, h_kv, d, **kw)
        o_p, lse_p = A.flash_fwd_packed(qkv, h, h_kv, d, impl="torch", **kw)
        o_t, lse_t = A.flash_fwd_packed(qkv.float(), h, h_kv, d,
                                        impl="torch", **kw)
        torch.cuda.synchronize()
        errs["fwd"] = max(errs["fwd"], rule_check("o", o, o_p, o_t, shape),
                          rule_check("lse", lse, lse_p, lse_t, shape))
        fwd_checks(torch, "packed", (qkv, h, h_kv, d), kw, (o_p, lse_p),
                   (o_t, lse_t), shape, "packed")
        del o, lse, o_t, lse_t
        # the forward on both variants in turns beside SDPA on the sliced
        # q/k/v views of the same buffer (GQA: enable_gqa)
        q4, k4, v4 = (x.detach() for x in A._packed_views(qkv, h, h_kv, d))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=h_kv < h), [()])
        fwd_ab[(b, s, h_kv)] = fwd_ab_times(
            torch, "packed", [(qkv, h, h_kv, d)], kw,
            f"packed b {b} x {s}, {h}/{h_kv} heads (GPT)", lib)
        got = A.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d, **kw)
        plain = A.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d,
                                   impl="torch", **kw)
        truth = A.flash_bwd_packed(qkv.float(), o_p.float(), lse_p,
                                   do.float(), h, h_kv, d, impl="torch",
                                   **kw)
        torch.cuda.synchronize()
        for name, g, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
            check(torch.isfinite(g.float()).all().item(),
                  f"{name} kernel output not finite")
            e = rule_check(name, g, p_, t_, shape)
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], e)
        pair_checks(torch, "packed", (qkv, o_p, lse_p, do, h, h_kv, d), kw,
                    (*plain, None), (*truth, None), shape, "packed")
        del got, plain, truth, o_p, lse_p
        torch.cuda.empty_cache()

    # timing at the train step's shape (126 MB of qkv: cold in the L2)
    b, s, h, h_kv = TRAIN_BATCH, TRAIN_SEQ, 8, 8
    qkv, do = flash_case(torch, dev, b, s, h, h_kv, d, seed=5)
    o, lse = A.flash_fwd_cuda(qkv, h, h_kv, d, **kw)
    ms_fwd = fwd_ab[(b, s, h_kv)]["wgmma"]
    plain_fwd = time_ms(lambda: A.flash_fwd_packed(qkv, h, h_kv, d,
                                                   impl="torch", **kw),
                        [()], reps=2, trials=3)
    plain_bwd = time_ms(lambda: A.flash_bwd_packed(qkv, o, lse, do, h, h_kv,
                                                   d, impl="torch", **kw),
                        [()], reps=2, trials=3)
    # the library yardstick: SDPA (and its autograd backward) on the
    # sliced q/k/v views of the same buffer — timed here, used nowhere
    leaf = qkv.detach().requires_grad_()
    heads = lambda lo, n: leaf[..., lo * d:(lo + n) * d].view(  # noqa: E731
        b, s, n, d).transpose(1, 2)
    q4, k4, v4 = heads(0, h), heads(h, h_kv), heads(h + h_kv, h_kv)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), [()])
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(b, s, h, d).transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), [()], reps=5)
    del leaf, out4
    ab = ab_times(torch, "packed", (qkv, o, lse, do, h, h_kv, d), kw,
                  "packed (GPT train step)", lib_bwd)
    ms_dkv, ms_dq = ab["wgmma"]["dkv_ms"], ab["wgmma"]["dq_ms"]

    # bounds from this run's data: causal pairs per head s(s+1)/2; each
    # function's products per pair (QK^T 2d, PV 2d; backward: recomputed
    # QK^T, dP, dV, dK for dK/dV; QK^T, dP, dQ for dQ); bytes: each input
    # read once, each output written once. The function the two backward
    # kernels replace, flash_bwd_packed, needs QK^T, dP, dV, dK and dQ once
    # (10d per pair), its inputs read once and dq, dk, dv written once: its
    # bound is less than the sum of the two kernels' bounds
    pairs = b * h * s * (s + 1) / 2
    feat = (h + 2 * h_kv) * d
    io = b * s * d * 2  # one (b, s, d) bf16 window per head
    fwd = bound(b * s * feat * 2 + h * io + b * h * s * 4, 4 * d * pairs,
                BF16_OPS_PER_S)
    bwd_in = b * s * feat * 2 + 2 * h * io + b * h * s * 4
    dkv = bound(bwd_in + 2 * h_kv * io, 8 * d * pairs, BF16_OPS_PER_S)
    dq = bound(bwd_in + h * io, 6 * d * pairs, BF16_OPS_PER_S)
    bwd = bound(bwd_in + (h + 2 * h_kv) * io, 10 * d * pairs,
                BF16_OPS_PER_S)
    backward = {"function": "flash_bwd_packed (dq, dk and dv)",
                "ms": ms_dkv + ms_dq, "sm80_ms": ab["sm80"]["pair_ms"],
                "bound_ms": bwd[0], "bound_by": bwd[1]}
    timed = {"b": b, "s": s, "heads": h, "kv_heads": h_kv, "head_dim": d,
             "causal": True, "dtype": "bf16"}
    plain_note = ("one plain backward computes dq, dk and dv together; "
                  "its time is given for both backward kernels")
    lib_note = ("F.scaled_dot_product_attention's autograd backward "
                "computes dq, dk and dv in one call; its time is given for "
                "both backward kernels")
    src = "apex_tpu_torch/csrc/"
    return [
        {"name": "flash_fwd", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:506",
         "max_abs_err": errs["fwd"], "ms": ms_fwd,
         "sm80_ms": fwd_ab[(b, s, h_kv)]["sm80"], "plain_ms": plain_fwd,
         "bound_ms": fwd[0], "bound_by": fwd[1], "library_ms": lib_fwd,
         "variant_note": FWD_VARIANT_NOTE, "timed_shape": timed},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:710",
         "max_abs_err": errs["dkv"], "ms": ms_dkv,
         "sm80_ms": ab["sm80"]["dkv_ms"], "plain_ms": plain_bwd,
         "bound_ms": dkv[0], "bound_by": dkv[1], "library_ms": lib_bwd,
         "plain_note": plain_note, "library_note": lib_note,
         "variant_note": VARIANT_NOTE, "backward": backward,
         "timed_shape": timed},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:676",
         "max_abs_err": errs["dq"], "ms": ms_dq,
         "sm80_ms": ab["sm80"]["dq_ms"], "plain_ms": plain_bwd,
         "bound_ms": dq[0], "bound_by": dq[1], "library_ms": lib_bwd,
         "plain_note": plain_note, "library_note": lib_note,
         "variant_note": VARIANT_NOTE, "backward": backward,
         "timed_shape": timed},
    ]


def phase_xent_kernel(torch, dev):
    from apex_tpu_torch.ops import xentropy as X

    n, V = TRAIN_BATCH * TRAIN_SEQ, MODEL["vocab_size"]
    g = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn((n, V), generator=g, device=dev) * 2.0).bfloat16()
    labels = torch.randint(0, V, (n,), generator=g, device=dev)
    labels[::97] = -1
    labels[5::89] = V  # outside [0, V): target logit 0
    got = X.xent_stats(x, labels)
    want = X.xent_stats(x, labels, impl="torch")
    torch.cuda.synchronize()
    errs = {k: (a - w).abs().max().item() for k, a, w in
            zip(("max", "sumexp", "target", "rowsum"), got, want)}
    rel_sumexp = ((got[1] - want[1]).abs() / want[1]).max().item()
    rowsum_tol = 1e-5 * x.float().abs().sum(-1).max().item()
    emit("xent_check", {"rows": n, "vocab": V, "abs_err": errs,
                        "sumexp_rel_err": rel_sumexp,
                        "rowsum_tol": rowsum_tol})
    check(errs["max"] == 0 and errs["target"] == 0,
          "xent_stats kernel: max or target logit not exact")
    check(rel_sumexp <= 1e-5, f"xent_stats kernel: sum-exp rel err "
          f"{rel_sumexp} > 1e-5")
    check(errs["rowsum"] <= rowsum_tol, f"xent_stats kernel: row-sum err "
          f"{errs['rowsum']} > {rowsum_tol}")
    ms = time_ms(lambda: X.xent_stats_cuda(x, labels), [()])
    plain_ms = time_ms(lambda: X.xent_stats(x, labels, impl="torch"), [()],
                       reps=3, trials=5)
    # bytes: logits and labels read once, four fp32 stats written; ops:
    # per logit a max, a subtract, an exp and two adds (fp32)
    bms, by = bound(n * V * 2 + n * 8 + 4 * n * 4, 5 * n * V,
                    FP32_OPS_PER_S)
    return {"name": "xent_stats", "route": "cuda",
            "source": "apex_tpu_torch/csrc/xent_stats.cu",
            "replaces": "apex_tpu/ops/pallas/xentropy.py:86",
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes the row max, "
                            "sum-exp, target logit and row sum",
            "timed_shape": {"rows": n, "vocab": V, "dtype": "bf16",
                            "labels": "int64"}}


def model_flops_per_token(cfg, seq):
    """bench.py:108-117: 6 * (matmul params) + 12 * L * S * H per token."""
    H, L, V = cfg["hidden_size"], cfg["num_layers"], cfg["vocab_size"]
    return 6 * (12 * L * H * H + V * H) + 12 * L * seq * H


def named_leaves(tree, prefix=""):
    """(name, tensor) pairs in param_leaves' order."""
    if isinstance(tree, dict):
        return [nt for k in sorted(tree)
                for nt in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [nt for i, item in enumerate(tree)
                for nt in named_leaves(item, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def train_step(model, params, opt, tokens, targets):
    loss = model.loss_fn(params, tokens, targets)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def phase_train(torch, dev):
    """The main train path: warm-up, then TRAIN_STEPS timed steps with the
    counters zeroed just before and read just after."""
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, TRAIN, torch.bfloat16)
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    tokens, targets = gpt_batch(torch, dev)
    losses, wall, launches = timed_steps(
        torch, lambda: train_step(model, params, opt, tokens, targets),
        TRAIN_STEPS, "train path")
    L = TRAIN["num_layers"]
    check_launches(launches, {"flash_fwd": L, "flash_fwd_wgmma": L,
                              "flash_bwd_dkv": L,
                              "flash_bwd_dq": L, "flash_bwd_dkv_wgmma": L,
                              "flash_bwd_dq_wgmma": L, "xent_stats": 1,
                              "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1},
                   TRAIN_STEPS, "train path")
    tok = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS
    flops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
    info = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / TRAIN_STEPS, "tokens_per_s": tok / wall,
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "card": torch.cuda.get_device_name(0),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in launches.items() if v}}
    return (model, params, opt, tokens, targets), info, launches


def phase_train_plain(torch, model, params, tokens, targets, seeds=None,
                      tag="train_plain_path"):
    """One step's loss and gradients, kernel path vs plain path, on the
    same weights and batch (no optimizer step), with the dropout
    ``seeds`` (None: no dropout). The k window of each qkv bias is left
    out of its leaf's norm: its exact gradient is 0 (one constant added to
    every score of a row), so both paths hold only bf16 rounding noise
    there."""
    c = model.config
    h, d = c.num_heads, c.head_dim

    def loss_and_grads(impl):
        loss = model.loss_fn(params, tokens, targets, dropout_seeds=seeds,
                             impl=impl)
        loss.backward()
        out = {}
        for name, t in named_leaves(params):
            g = t.grad.float()
            if name.endswith("qkv.bias"):
                g = torch.cat([g[:h * d], g[(h + c.kv_heads) * d:]])
            out[name] = g
            t.grad = None
        return loss.item(), out

    loss_k, g_k = loss_and_grads("auto")
    loss_p, g_p = loss_and_grads("torch")
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30))
           .item() for n in g_p}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    info = {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_norm_err_max": worst[0][1],
            "grad_worst_leaf": worst[0][0], "grad_tol": TRAIN_GRAD_TOL,
            "median_leaf_err": statistics.median(rel.values()),
            "leaf_rel_norm_err": rel}
    emit(tag, info)
    check(info["loss_rel_diff"] <= TRAIN_LOSS_TOL,
          f"train loss kernel vs plain: rel diff {info['loss_rel_diff']}")
    check(worst[0][1] <= TRAIN_GRAD_TOL,
          f"train gradient {worst[0][0]} kernel vs plain: rel norm err "
          f"{worst[0][1]} > {TRAIN_GRAD_TOL}")
    return info


def kernel_category(name):
    """The train step's layers, by kernel name."""
    if any(k in name for k in ("matmul_bias_act", "matmul_wgmma",
                               "splitk_reduce")):
        return "matmul_bias_act kernel"
    if "flash_" in name:
        return "flash attention kernels"
    if "xent_stats" in name:
        return "xent_stats kernel"
    if "ln_fwd" in name or "ln_bwd" in name:
        return "layer-norm kernels"
    if "softmax_fwd" in name or "softmax_bwd" in name:
        return "softmax kernels"
    if "nvjet" in name or "gemm" in name.lower() or "cutlass" in name:
        return "GEMMs (cuBLAS)"
    if "multi_tensor_apply" in name:
        return "Adam (_foreach multi-tensor kernels)"
    return "other elementwise, reduction and copy kernels"


def phase_train_profile(torch, step, step_s):
    """Where the train step's time goes: 2 profiled steps, device time by
    kernel and by layer, launches per step, and the busy share of an
    unprofiled step (one stream, so kernels never overlap). Annotation
    ranges (the optimizer's ``record_function``) are not kernels and are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6 / 2
    layers = {}
    for t, n, name in kernels:
        cat = layers.setdefault(kernel_category(name),
                                {"device_ms_per_step": 0.0,
                                 "launches_per_step": 0.0})
        cat["device_ms_per_step"] += t / 2e3
        cat["launches_per_step"] += n / 2
    return {"device_busy_s_per_step": busy_s, "step_s": step_s,
            "device_busy_share": busy_s / step_s,
            "device_launches_per_step": sum(k[1] for k in kernels) / 2,
            "by_layer": dict(sorted(layers.items(), key=lambda kv:
                                    -kv[1]["device_ms_per_step"])),
            "top": [{"kernel": name[:90], "device_ms_per_step": t / 2e3,
                     "launches_per_step": n / 2}
                    for t, n, name in kernels[:12]]}


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

# --- the decode-engine slice ---------------------------------------------------

# the decode leg (bench.py:215-220): GPT-medium bf16 as MODEL, batch 16,
# prompt 512, 128 new tokens (the prefill samples the first, then 127
# decode steps), 3 passes each of the prefill and of the decode loop
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_PASSES = 16, 512, 128, 3
DECODE_SAMPLED = dict(temperature=0.8, top_k=50)  # DecodeEngine: no top_p
# the spec leg: batch 1, a 64-token block repeated 4 times, 64 new tokens
SPEC_BLOCK, SPEC_REPS, SPEC_NEW, SPEC_K = 64, 4, 64, 4


def phase_bshd_kernel(torch, dev):
    """The bshd flash forward against its plain version at the prefill's
    shape (views of one packed projection buffer, as the prefill passes
    them) and at a ragged GQA shape; bit-identity with the packed kernel
    on the same views; times at the prefill's shape."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    d = 128
    kw = dict(scale=d ** -0.5, causal=True)

    def views(qkv, h, h_kv):
        b, s, _ = qkv.shape
        return (qkv[..., :h * d].reshape(b, s, h, d),
                qkv[..., h * d:(h + h_kv) * d].reshape(b, s, h_kv, d),
                qkv[..., (h + h_kv) * d:].reshape(b, s, h_kv, d))

    err = 0.0
    for b, s, h, h_kv in ((DECODE_BATCH, DECODE_PROMPT, 8, 8),
                          (4, 300, 8, 2)):
        shape = {"b": b, "sq": s, "sk": s, "h": h, "h_kv": h_kv, "d": d}
        qkv, _ = flash_case(torch, dev, b, s, h, h_kv, d, seed=s + 7)
        q, k, v = views(qkv, h, h_kv)
        o, lse = A.flash_fwd_bshd(q, k, v, **kw)
        o_p, lse_p = A.flash_fwd_bshd(q, k, v, impl="torch", **kw)
        o_t, lse_t = A.flash_fwd_bshd(q.float(), k.float(), v.float(),
                                      impl="torch", **kw)
        o_pk, lse_pk = A.flash_fwd_cuda(qkv, h, h_kv, d, **kw)
        torch.cuda.synchronize()
        err = max(err, rule_check("bshd o", o, o_p, o_t, shape),
                  rule_check("bshd lse", lse, lse_p, lse_t, shape))
        check(torch.equal(o.reshape(o_pk.shape), o_pk)
              and torch.equal(lse, lse_pk),
              f"bshd kernel on packed views differs from the packed kernel "
              f"at {shape}")
        fwd_checks(torch, "bshd", (q, k, v), kw, (o_p, lse_p), (o_t, lse_t),
                   shape, "bshd prefill" if h_kv == h else "bshd gqa")
        if h_kv < h:  # the prefill's shape is timed below
            t = lambda x: x.transpose(1, 2)  # noqa: E731
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                t(q), t(k), t(v), is_causal=True, enable_gqa=True), [()])
            fwd_ab_times(torch, "bshd", [(q, k, v)], kw,
                         f"bshd b {b} x {s}, {h}/{h_kv} heads (ragged GQA)",
                         lib)
        del qkv, o, lse, o_p, lse_p, o_t, lse_t, o_pk, lse_pk

    b, s, h = DECODE_BATCH, DECODE_PROMPT, 8
    sets = [views(flash_case(torch, dev, b, s, h, h, d, seed=20 + i)[0],
                  h, h) for i in range(2)]  # 2 x 50 MB: cold in the L2
    plain_ms = time_ms(lambda q, k, v: A.flash_fwd_bshd(q, k, v,
                                                        impl="torch", **kw),
                       sets, reps=3, trials=5)
    library_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True), sets)
    ab = fwd_ab_times(torch, "bshd", sets, kw,
                      f"bshd b {b} x {s}, {h} heads (decode prefill)",
                      library_ms)
    ms = ab["wgmma"]
    pairs = b * h * s * (s + 1) / 2
    io = b * s * h * d * 2  # one (b, s, h, d) bf16 tensor
    bms, by = bound(3 * io + io + b * h * s * 4, 4 * d * pairs,
                    BF16_OPS_PER_S)
    return {"name": "flash_fwd_bshd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "apex_tpu/ops/pallas/attention.py:831",
            "max_abs_err": err, "ms": ms, "sm80_ms": ab["sm80"],
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "variant_note": FWD_VARIANT_NOTE,
            "library_note": "F.scaled_dot_product_attention forward, causal",
            "timed_shape": {"b": b, "sq": s, "sk": s, "heads": h,
                            "kv_heads": h, "head_dim": d, "causal": True,
                            "dtype": "bf16", "layout": "views of the "
                            "packed projection"}}


def phase_contig_decode_kernel(torch, dev):
    """The contiguous decode kernel against its plain version on the
    decode engine's cache (16 x 8 rows, max_s 1024, d 128) with ragged
    lengths including 0 and 1024, on a GQA cache, and at the spec leg's
    batch 1 (each an S the plan picks), bit-identical across two runs; its
    plan; times with every row at 640 live positions (the decode leg's
    last step) and at 513, each through ``decode_attention`` and the
    kernel entry alone, with the parent's kernel in turns under
    ``--parent``; and at 640 live at each split (``decode_split_sweep``)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import decode_attention as D

    b, h, d, max_s = DECODE_BATCH, 8, 128, 1024
    ragged = [0, 1, 127, 128, 129, 300, 512, 513, 600, 640, 700, 900,
              1000, 1023, 1024, 2]

    def case(bb, h_kv, lengths, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((bb, h, d), generator=g, device=dev).bfloat16()
        k = torch.randn((bb, h_kv, max_s, d), generator=g,
                        device=dev).bfloat16()
        v = torch.randn((bb, h_kv, max_s, d), generator=g,
                        device=dev).bfloat16()
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    err, plans = 0.0, {}
    for what, bb, h_kv, lengths in (("decode", b, 8, ragged),
                                    ("decode_gqa", b, 2, ragged),
                                    ("spec", 1, 8, [700])):
        q, k, v, lens = case(bb, h_kv, lengths, seed=h_kv + 40 + bb)
        got = D.decode_attention(q, k, v, lens)
        again = D.decode_attention(q, k, v, lens)
        want = D.decode_attention(q, k, v, lens, impl="torch")
        decode_repeat_check(torch, got, again, "contiguous decode kernel")
        e = (got.float() - want.float()).abs().max().item()
        check(torch.isfinite(got.float()).all().item(),
              "contiguous decode kernel output not finite")
        check(not got[lens == 0].any().item(),
              "contiguous decode kernel: length-0 row not zeros")
        plans[what] = decode_plan_info(
            torch, q.reshape(bb * h_kv, h // h_kv, d), max_s // 128, 128,
            False)
        emit("contig_decode_check", {"call": what, "h_kv": h_kv,
                                     "lengths": lengths,
                                     "splits": plans[what]["splits"],
                                     "max_abs_err": e, "tol": DECODE_TOL})
        check(e <= DECODE_TOL, f"contiguous decode kernel vs plain: max abs "
              f"err {e} > {DECODE_TOL} ({what})")
        err = max(err, e)
    emit("decode_plan", {"kernel": "decode_attn", "plans": plans})

    scale = d ** -0.5
    kern = lambda q, k, v, n: D.decode_attention(q, k, v, n)  # noqa: E731
    per_shape = {}
    for L in (DECODE_PROMPT + DECODE_NEW, DECODE_PROMPT + 1):
        sets = [case(b, 8, [L] * b, seed=50 + i) for i in range(2)]
        entry_sets = [(q.reshape(b * 8, 1, d), k.reshape(b * 8, max_s, d),
                       v.reshape(b * 8, max_s, d), n) for q, k, v, n in sets]
        entry = lambda q, k, v, n: D.decode_attn_cuda(  # noqa: E731
            q, k, v, n, scale=scale)
        ms, parent_ms = parent_turns(torch, kern, sets)
        entry_ms, parent_entry_ms = parent_turns(torch, entry, entry_sets)
        rows = b * h
        bms, by = bound(2 * rows * L * d * 2 + 2 * b * h * d * 2 + b * 4,
                        4 * rows * L * d, BF16_OPS_PER_S)
        per_shape[f"live_{L}"] = {"ms": ms, "parent_ms": parent_ms,
                                  "entry_ms": entry_ms,
                                  "parent_entry_ms": parent_entry_ms,
                                  "bound_ms": bms, "bound_by": by}
        emit("contig_decode_times", dict(per_shape[f"live_{L}"],
                                         live_rows=L))
        if L == DECODE_PROMPT + DECODE_NEW:
            last_sets, last_bound = sets, (bms, by)
    sweep = decode_split_sweep(
        torch, kern, last_sets,
        [case(b, 8, [0] * b, seed=60 + i) for i in range(2)],
        last_sets[0][0].reshape(b * 8, 1, d), max_s // 128, 128,
        f"live_{DECODE_PROMPT + DECODE_NEW}")

    plain = lambda q, k, v, n: D.decode_attention(  # noqa: E731
        q, k, v, n, impl="torch")

    def library(q, k, v, n):
        mask = (torch.arange(max_s, device=dev)[None, :]
                < n[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                              attn_mask=mask)

    L = DECODE_PROMPT + DECODE_NEW
    last = per_shape[f"live_{L}"]
    return {"name": "decode_attn", "route": "cuda",
            "source": "apex_tpu_torch/csrc/paged_decode_attn.cu",
            "replaces": "apex_tpu/ops/pallas/decode_attention.py:183",
            "max_abs_err": err, "ms": last["ms"],
            "parent_ms": last["parent_ms"],
            "plain_ms": time_ms(plain, last_sets, reps=5),
            "bound_ms": last_bound[0], "bound_by": last_bound[1],
            "library_ms": time_ms(library, last_sets, reps=5),
            "library_note": "F.scaled_dot_product_attention over the whole "
                            "cache with a length mask",
            "kernel_note": "the split body at the plan's S (decode_plan); "
                           "ms through decode_attention, per-batch lengths "
                           "read by the kernel; parent_ms: the parent "
                           "commit's kernel in turns (--parent)",
            "timed_shape": {"batch": b, "heads": h, "kv_heads": 8,
                            "head_dim": d, "max_s": max_s,
                            "live_rows": L, "dtype": "bf16"},
            "plan": plans["decode"], "split_sweep": sweep,
            "per_shape": per_shape}


# the verify kernels' shapes (batch, rows): the spec leg's chain (1, 5) and
# tree (1, 9), their batch-4 forms, and the drafters' longest chain (1, 33)
VERIFY_SHAPES = ((1, 5), (1, 9), (4, 5), (4, 9), (1, 33), (8, 5), (8, 9))
# the serve's sampled spec rounds: top-p after top-k (the survivors gathered
# into rank 0) and without top-k (the mass rounds), at the spec leg's
# batch-1 shapes and the serve's 8 slots (chain k 4: (8, 5); tree depth 4
# x branching 2: (8, 9), 144 CTAs at S 2, more than one wave)
TOP_P_SHAPES = ((1, 5), (1, 9), (8, 5), (8, 9))
TOP_P_KNOBS = {"top_p_k50": dict(temperature=0.8, top_k=50, top_p=0.9),
               "top_p_k0": dict(temperature=0.8, top_k=0, top_p=0.9)}


def verify_case(torch, dev, b, n1, V, seed, tree):
    """bf16 logits with a forced argmax tie in row 1 (indices 3 and 7),
    drafts that follow their parent row's argmax except for a wrong
    sibling and a random last token, and (tiny, 1] noise."""
    from apex_tpu_torch.ops import fused_verify as vf
    from apex_tpu_torch.spec.tree import draft_tree

    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((b, n1, V), generator=g, device=dev) * 4.0
    logits[:, 1, 7] = logits[:, 1].amax(-1) + 1.0
    logits[:, 1, 3] = logits[:, 1, 7]
    logits = logits.bfloat16()
    cand = vf.row_argmax(logits.float())
    if tree:
        topo = draft_tree(2, (n1 - 1) // 2)
        parents, anc = (torch.as_tensor(a, device=dev)
                        for a in topo.operands(b))
        tokens = cand.gather(-1, parents.long())
        tokens[:, 2] = (tokens[:, 2] + 1) % V
        tokens[:, -1] = torch.randint(0, V, (b,), generator=g, device=dev)
        extra = (tokens, parents, anc)
    else:
        drafted = cand[:, :-1].clone()
        drafted[:, -1] = torch.randint(0, V, (b,), generator=g, device=dev)
        extra = (drafted,)
    tiny = torch.finfo(torch.float32).tiny
    u_acc = torch.rand((b, n1), generator=g, device=dev).clamp_min(tiny)
    u_gum = torch.rand((b, n1, V), generator=g, device=dev).clamp_min(tiny)
    return logits, extra, u_acc, u_gum


def verify_fault_case(torch, dev, b, n1, V, tree):
    """A case both planted faults must change: row 0's largest logit, 30
    above the rest (beyond any Gumbel term at T 0.8), in the LAST rank's
    share at V - 5, and row 0's children (the chain's node 1, the tree's
    nodes 1 and 1 + depth) drafting tokens 11 and 12 with acceptance draws
    near 1. The sound kernel rejects them and emits
    V - 5 in both modes; without the last rank's share (drop_last_rank),
    or without row 0's slot (no_publish: candidate -1), it cannot."""
    logits, extra, u_acc, u_gum = verify_case(torch, dev, b, n1, V, 5, tree)
    logits[:, 0, V - 5] = logits[:, 0].amax(-1) + 30.0
    if tree:
        tokens = extra[0].clone()
        tokens[:, 1], tokens[:, 1 + (n1 - 1) // 2] = 11, 12
        extra = (tokens, *extra[1:])
    else:
        drafted = extra[0].clone()
        drafted[:, 0] = 11
        extra = (drafted,)
    u_acc = torch.full_like(u_acc, 0.999)
    return logits, extra, u_acc, u_gum


def verify_near_ties(torch, logits, extra, u_acc, u_gum, tree,
                     knobs=None):
    """Batch rows where a near-tie could flip a sampled verdict: an
    acceptance draw within NEAR_TIE of its probability, or a row's two
    best perturbed scores within NEAR_TIE (the sampler's rule); with
    top_p < 1 also a cumulative mass of the top-k survivors (best first,
    at the last of each group of equal scores) within TOP_P_EDGE of top_p
    times their total."""
    from apex_tpu_torch.ops import fused_verify as vf
    from apex_tpu_torch.ops import sampling as sm

    knobs = {**DECODE_SAMPLED, "top_p": 1.0, **(knobs or {})}
    s = sm.filtered_scaled(logits, temperature=knobs["temperature"],
                           top_k=knobs["top_k"], top_p=knobs["top_p"])
    edge = torch.zeros(logits.shape[0], dtype=torch.bool,
                       device=logits.device)
    if knobs["top_p"] < 1.0:
        sk = sm.filtered_scaled(logits, temperature=knobs["temperature"],
                                top_k=knobs["top_k"],
                                top_p=1.0).double().sort(
                                    dim=-1, descending=True).values
        cum = torch.exp(sk - sk[..., :1]).cumsum(-1)
        target = knobs["top_p"] * cum[..., -1:]
        ends = torch.ones_like(sk, dtype=torch.bool)
        ends[..., :-1] = sk[..., 1:] != sk[..., :-1]
        edge = (ends & ((cum - target).abs()
                        <= TOP_P_EDGE * target)).any(-1).any(-1)
    n1 = s.shape[-2]
    if tree:
        tokens, parents, _ = extra
        tokens = tokens.clone()
        tokens[:, 0] = vf.NO_DRAFT
        ua = u_acc
    else:
        tokens = torch.cat([torch.full_like(extra[0][:, :1], vf.NO_DRAFT),
                            extra[0]], dim=1)
        parents = (torch.arange(n1, device=s.device) - 1).clamp_min(0)
        parents = parents.expand_as(tokens)
        ua = torch.cat([u_acc[:, -1:], u_acc[:, :-1]], dim=1)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = vf._token_mass(e, tokens) / e.sum(-1)[..., None]
    ratio = p.gather(1, parents.long()[:, None, :])[:, 0]
    tie = ((ua - ratio).abs() <= NEAR_TIE * ratio) & (tokens >= 0)
    drop = torch.zeros_like(s, dtype=torch.bool)
    for c in range(1, n1):
        t = tokens[:, c]
        ok = t >= 0
        drop[ok, parents[ok, c].long(), t[ok].long()] = True
    x = (torch.where(drop, sm.FILTERED, s)
         - torch.log(-torch.log(u_gum))).double()
    top2 = x.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).abs() <= NEAR_TIE * top2[..., 0].abs()
    # a row whose every entry is filtered ties exactly at -1e30: both
    # sides take index 0, so that is no near-tie
    gap &= top2[..., 0] > sm.FILTERED / 2
    return tie.any(-1) | gap.any(-1) | edge


def verify_gather_ties(torch, logits):
    """The forced-tie variant: 40 logits above each row's largest, then
    300 equal ones 1 below it (the 50th value), so top-k's survivors
    overflow the 256 the kernel gathers and it takes the mass rounds."""
    top = logits.float().amax(-1, keepdim=True)
    steps = 0.25 * torch.arange(1, 41, device=logits.device)
    logits = logits.clone()
    logits[..., 1000:1040] = (top + steps).to(logits.dtype)
    logits[..., 2000:2300] = (top - 1.0).expand(
        *logits.shape[:2], 300).to(logits.dtype)
    return logits


def verify_nucleus_case(torch, dev, b, n1, V, tree):
    """A row whose draft lies inside top-k but outside the nucleus: row 0
    puts 0.95 of its mass on token 100 (T 0.8), its top 50 distinct, and
    its first child drafts token 200 (p 0.047 before top-p) with an
    acceptance draw of 1e-3. The sound kernel rejects it at every batch
    row and emits 100; with top-p skipped (``no_top_p``) it accepts."""
    from apex_tpu_torch.ops import fused_verify as vf

    logits, extra, u_acc, u_gum = verify_case(torch, dev, b, n1, V, 3, tree)
    logits[:, 0] = -30.0
    logits[:, 0, 300:348] = (-10.0 + 0.125 * torch.arange(
        48, device=dev)).to(logits.dtype)
    logits[:, 0, 100] = 8.0
    logits[:, 0, 200] = 5.6
    if tree:
        tokens = extra[0].clone()
        tokens[:, 1] = 200
        tokens[:, 1 + (n1 - 1) // 2] = 300
        extra = (tokens, *extra[1:])
    else:
        drafted = extra[0].clone()
        drafted[:, 0] = 200
        extra = (drafted,)
    return logits, extra, torch.full_like(u_acc, 1e-3), u_gum


def verify_kernel_args(torch, logits, extra, tree):
    """The ``*_cuda`` wrapper's operands from the op's: the chain's drafts
    padded with the bonus entry, the tree's column 0 pinned to NO_DRAFT."""
    from apex_tpu_torch.ops import fused_verify as vf

    if tree:
        tokens = extra[0].clone()
        tokens[:, 0] = vf.NO_DRAFT
        return (logits, tokens, *extra[1:])
    pad = torch.cat([extra[0], torch.full_like(extra[0][:, :1],
                                               vf.NO_DRAFT)], 1)
    return (logits, pad)


def phase_verify_kernels(torch, dev):
    """Both verify kernels against their plain versions, greedy and
    sampled (T 0.8, top_k 50), at every shape of VERIFY_SHAPES over 4
    seeds, and with top-p (TOP_P_KNOBS: top_p 0.9 after top_k 50 or alone)
    at every shape of TOP_P_SHAPES over 2 seeds, on plain logits and on
    forced ties that overflow the gathered survivors: no verdict mismatch
    outside near-ties, verdicts bit-identical across two runs; both
    planted faults (the last rank left out of the merges, row 0's slots
    never published) refused at every shape and mode, and ``no_top_p``
    (top-p skipped) at a row whose draft lies outside the nucleus, which
    the sound kernel rejects at every batch row; the plan's clusters held
    by the card, its shared memory the kernel's. Times at every shape and
    mode (the top-p modes at TOP_P_SHAPES): the kernel, the parent's in
    turns under ``--parent``, a copy that returns at once on the same
    clusters (``empty_ms``), the plain version, the bound; the plan and
    the instance's registers and spills."""
    from apex_tpu_torch.ops import fused_verify as vf
    from apex_tpu_torch.ops.matmul import _sm_count
    from apex_tpu_torch.tools import rowwise_ab

    V = MODEL["vocab_size"]
    sms = _sm_count(torch.cuda.current_device())
    rows = mismatches = ties_total = refused = faults = 0
    for seed in range(4):
        for b, n1 in VERIFY_SHAPES:
            for tree in (False, True):
                logits, extra, u_acc, u_gum = verify_case(
                    torch, dev, b, n1, V, 100 * seed + b + n1, tree)
                fn = vf.fused_verify_tree if tree else vf.fused_verify
                for sampled in (False, True):
                    kw = dict(DECODE_SAMPLED) if sampled else {}
                    if sampled:
                        kw.update(u_acc=u_acc, u_gum=u_gum)
                    got = fn(logits, *extra, **kw)
                    again = fn(logits, *extra, **kw)
                    check(all(torch.equal(x, y) for x, y in zip(got, again)),
                          f"verify not bit-reproducible at {(b, n1)}, "
                          f"tree {tree}, sampled {sampled}")
                    want = fn(logits, *extra, impl="torch", **kw)
                    bad = torch.zeros((b,), dtype=torch.bool, device=dev)
                    for x, y in zip(got, want):
                        bad |= x != y
                    if sampled:
                        ties = verify_near_ties(torch, logits, extra, u_acc,
                                                u_gum, tree)
                        ties_total += int(ties.sum())
                        bad &= ~ties
                    mismatches += int(bad.sum())
                    rows += b
    # the planted faults, at every shape and mode
    for b, n1 in VERIFY_SHAPES:
        for tree in (False, True):
            logits, extra, u_acc, u_gum = verify_fault_case(torch, dev, b,
                                                            n1, V, tree)
            args = verify_kernel_args(torch, logits, extra, tree)
            kern = vf.fused_verify_tree_cuda if tree else \
                vf.fused_verify_cuda
            fn = vf.fused_verify_tree if tree else vf.fused_verify
            for sampled in (False, True):
                kw = dict(DECODE_SAMPLED) if sampled else {}
                if sampled:
                    kw.update(u_acc=u_acc, u_gum=u_gum)
                want = fn(logits, *extra, impl="torch", **kw)
                check(bool((want[-1] == V - 5).all()), "the fault case's "
                      "plain verdict is not the last rank's token")
                noise = (u_acc, u_gum) if sampled else (None, None)
                knobs = (dict(DECODE_SAMPLED) if sampled
                         else dict(temperature=0.0, top_k=0))
                sound = kern(*args, *noise, **knobs)
                check(all(torch.equal(x, y) for x, y in zip(sound, want)),
                      f"verify fault case at {(b, n1)}, tree {tree}, "
                      f"sampled {sampled}: the sound kernel disagrees")
                for fault in ("drop_last_rank", "no_publish"):
                    got = kern(*args, *noise, **knobs, planted_fault=fault)
                    bad = torch.zeros((b,), dtype=torch.bool, device=dev)
                    for x, y in zip(got, want):
                        bad |= x != y
                    faults += 1
                    refused += int(bad.all())  # every batch row changed
    # top-p (the serve's sampled spec rounds): both knob sets, plain and
    # forced-tie logits, over 2 seeds; the three faults refused
    p_rows = p_mismatches = p_ties = p_all = 0
    for seed in range(2):
        for b, n1 in TOP_P_SHAPES:
            for tree in (False, True):
                for ties in (False, True):
                    logits, extra, u_acc, u_gum = verify_case(
                        torch, dev, b, n1, V, 300 + 100 * seed + b + n1,
                        tree)
                    if ties:
                        logits = verify_gather_ties(torch, logits)
                    fn = vf.fused_verify_tree if tree else vf.fused_verify
                    for mode, knobs in TOP_P_KNOBS.items():
                        kw = dict(knobs, u_acc=u_acc, u_gum=u_gum)
                        got = fn(logits, *extra, **kw)
                        again = fn(logits, *extra, **kw)
                        check(all(torch.equal(x, y)
                                  for x, y in zip(got, again)),
                              f"verify {mode} not bit-reproducible at "
                              f"{(b, n1)}, tree {tree}, ties {ties}")
                        want = fn(logits, *extra, impl="torch", **kw)
                        bad = torch.zeros((b,), dtype=torch.bool,
                                          device=dev)
                        for x, y in zip(got, want):
                            bad |= x != y
                        near = verify_near_ties(torch, logits, extra, u_acc,
                                                u_gum, tree, knobs)
                        p_ties += int(near.sum())
                        p_mismatches += int((bad & ~near).sum())
                        p_all += int(bad.sum())
                        p_rows += b
    p_faults = p_refused = 0
    for b, n1 in TOP_P_SHAPES:
        for tree in (False, True):
            kern = vf.fused_verify_tree_cuda if tree else \
                vf.fused_verify_cuda
            fn = vf.fused_verify_tree if tree else vf.fused_verify
            for knobs in TOP_P_KNOBS.values():
                logits, extra, u_acc, u_gum = verify_fault_case(
                    torch, dev, b, n1, V, tree)
                args = verify_kernel_args(torch, logits, extra, tree)
                want = fn(logits, *extra, impl="torch", u_acc=u_acc,
                          u_gum=u_gum, **knobs)
                sound = kern(*args, u_acc, u_gum, **knobs)
                check(all(torch.equal(x, y) for x, y in zip(sound, want))
                      and bool((want[-1] == V - 5).all()),
                      f"verify top-p fault case at {(b, n1)}, tree {tree}: "
                      f"the sound kernel disagrees")
                for fault in ("drop_last_rank", "no_publish"):
                    got = kern(*args, u_acc, u_gum, **knobs,
                               planted_fault=fault)
                    bad = torch.zeros((b,), dtype=torch.bool, device=dev)
                    for x, y in zip(got, want):
                        bad |= x != y
                    p_faults += 1
                    p_refused += int(bad.all())
                # a draft outside the nucleus: rejected at every batch row;
                # with top-p skipped, accepted at every batch row
                logits, extra, u_acc, u_gum = verify_nucleus_case(
                    torch, dev, b, n1, V, tree)
                args = verify_kernel_args(torch, logits, extra, tree)
                want = fn(logits, *extra, impl="torch", u_acc=u_acc,
                          u_gum=u_gum, **knobs)
                sound = kern(*args, u_acc, u_gum, **knobs)
                check(bool((sound[0] == 0).all() and (sound[-1] == 100).all()
                           and (want[0] == 0).all()),
                      f"verify at {(b, n1)}, tree {tree}, {knobs}: a draft "
                      f"outside the nucleus was accepted")
                got = kern(*args, u_acc, u_gum, **knobs,
                           planted_fault="no_top_p")
                p_faults += 1
                p_refused += int((got[0] >= 1).all())
    emit("verify_check", {"rows": rows, "near_ties_excluded": ties_total,
                          "mismatches": mismatches,
                          "planted_faults": faults,
                          "planted_faults_refused": refused,
                          "top_p": {"rows": p_rows,
                                    "near_ties_excluded": p_ties,
                                    "mismatches": p_mismatches,
                                    "mismatches_with_near_ties": p_all,
                                    "planted_faults": p_faults,
                                    "planted_faults_refused": p_refused}})
    check(mismatches == 0, f"verify kernels vs plain: {mismatches} verdict "
          f"mismatches outside near-ties")
    check(ties_total <= max(1, 0.01 * rows), f"{ties_total} near-tie rows "
          f"excluded of {rows}")
    check(refused == faults, f"verify: {faults - refused} of {faults} "
          f"planted faults not refused")
    check(p_mismatches == 0, f"verify kernels vs plain with top-p: "
          f"{p_mismatches} verdict mismatches outside near-ties")
    check(p_ties <= max(1, 0.01 * p_rows), f"top-p: {p_ties} near-tie rows "
          f"excluded of {p_rows}")
    check(p_refused == p_faults, f"verify top-p: {p_faults - p_refused} of "
          f"{p_faults} planted faults not refused")

    out = []
    for tree, name, site in ((False, "fused_verify", "verify.py:290"),
                             (True, "fused_verify_tree", "verify.py:356")):
        kern_cuda = vf.fused_verify_tree_cuda if tree else \
            vf.fused_verify_cuda
        fn = vf.fused_verify_tree if tree else vf.fused_verify
        per_shape = {}
        for b, n1 in VERIFY_SHAPES:
            logits, extra, u_acc, u_gum = verify_case(torch, dev, b, n1, V,
                                                      7, tree)
            args = verify_kernel_args(torch, logits, extra, tree)
            plan = vf._verify_plan(b, n1, V, sms)
            clusters, smem = vf.verify_occupancy(plan, torch.bfloat16, V,
                                                 tree)
            check(clusters > 0, f"the card holds no cluster of the verify "
                  f"plan {plan}")
            check(smem == plan.smem, f"verify: the kernel's shared memory "
                  f"{smem} B, the plan's {plan.smem} B")
            modes = {}
            mode_knobs = {"greedy": dict(temperature=0.0, top_k=0),
                          "sampled": dict(DECODE_SAMPLED)}
            top_p_clusters = None
            if (b, n1) in TOP_P_SHAPES:
                mode_knobs.update(TOP_P_KNOBS)
                top_p_clusters, smem = vf.verify_occupancy(
                    plan, torch.bfloat16, V, tree, top_p=True)
                check(top_p_clusters > 0, f"the card holds no cluster of "
                      f"the verify plan {plan} with top-p")
                check(smem == vf.VERIFY_TOP_P_SMEM, f"verify with top-p: "
                      f"the kernel's shared memory {smem} B, the plan's "
                      f"{vf.VERIFY_TOP_P_SMEM} B")
            for mode, knobs in mode_knobs.items():
                sampled = mode != "greedy"
                noise = (u_acc, u_gum) if sampled else (None, None)
                plain_kw = dict(knobs, u_acc=u_acc, u_gum=u_gum) \
                    if sampled else {}
                run = lambda: kern_cuda(*args, *noise, **knobs)  # noqa
                if mode in TOP_P_KNOBS:  # the parent's pair has no top-p
                    ms, parent_ms = time_ms(run, [()]), None
                else:
                    ms, parent_ms = parent_turns(torch, run, [()])
                with rowwise_ab.using(EMPTY):
                    empty_ms = time_ms(run, [()])
                plain_ms = time_ms(lambda: fn(logits, *extra, impl="torch",
                                              **plain_kw), [()], reps=3,
                                   trials=5)
                elems = b * n1 * V
                nbytes = elems * 2 + 4 * b * n1 * (2 if tree else 1) + 12 * b
                if tree:
                    nbytes += 4 * b * n1 * n1
                # greedy: one compare a logit; sampled, as the sampler: the
                # scale, its key and the largest key 3, four top-k rounds
                # 12, the Gumbel term 3, the draw 2, then each kept
                # entry's mass (exp, scale, sum) 3; top-p after top-k (the
                # sampler's count): each survivor's mass against every
                # other's, 2L^2 at L 50; without top-k, 4 mass rounds of
                # (exp, scale, convert, prefix compare, bin, add) a value
                ops = elems
                if sampled:
                    nbytes += elems * 4 + 4 * b * n1
                    kept = knobs["top_k"] or V
                    ops = elems * 20 + 3 * b * n1 * min(kept, 50)
                    if knobs.get("top_p", 1.0) < 1.0:
                        ops += (2 * 50 * 50 * b * n1 if knobs["top_k"]
                                else 24 * elems)
                bms, by = bound(nbytes, ops, FP32_OPS_PER_S)
                modes[mode] = {
                    "ms": ms, "parent_ms": parent_ms, "empty_ms": empty_ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "ops_bound_ms": ops / FP32_OPS_PER_S * 1e3,
                    "ptxas": ptxas_of("verify_kernel", (
                        "__nv_bfloat16", str(plan.values),
                        "true" if tree else "false",
                        "true" if mode in TOP_P_KNOBS else "false"))}
            info = {"batch": b, "rows": n1, "vocab": V, **modes,
                    "plan": plan._asdict(), "max_active_clusters": clusters,
                    "top_p_max_active_clusters": top_p_clusters}
            per_shape[f"{b}x{n1}"] = info
            emit("verify_times", dict(info, kernel=name, **DECODE_SAMPLED,
                                      top_p_modes=TOP_P_KNOBS))
        spec = per_shape[f"1x{2 * SPEC_K + 1 if tree else SPEC_K + 1}"]
        served = per_shape[f"8x{2 * SPEC_K + 1 if tree else SPEC_K + 1}"]
        g_ = spec["greedy"]
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/fused_verify.cu",
                    "replaces": "apex_tpu/ops/pallas/" + site,
                    "max_abs_err": 0, "ms": g_["ms"],
                    "parent_ms": g_["parent_ms"],
                    "plain_ms": g_["plain_ms"], "bound_ms": g_["bound_ms"],
                    "bound_by": g_["bound_by"], "library_ms": None,
                    "library_note": "no PyTorch call verifies drafts",
                    "kernel_note": "each verify row over a cluster of the "
                                   "plan's CTAs, the tree resolved by the "
                                   "last row to arrive; parent_ms: the "
                                   "parent commit's kernel in turns "
                                   "(--parent)",
                    "sampled": spec["sampled"], "plan": spec["plan"],
                    "top_p": {mode: served[mode] for mode in TOP_P_KNOBS},
                    "top_p_shape": {"batch": 8, "rows": served["rows"],
                                    "vocab": V, "dtype": "bf16"},
                    "timed_shape": {"batch": 1, "rows": spec["rows"],
                                    "vocab": V, "dtype": "bf16",
                                    "ms_is": "greedy", **DECODE_SAMPLED},
                    "per_shape": per_shape})
    return out


def decode_counters():
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import decode_attention as D
    from apex_tpu_torch.ops import fused_verify as vf
    from apex_tpu_torch.ops import layer_norm as LN

    return {"flash_fwd_bshd": A.flash_fwd_bshd_cuda,
            "decode_attn": D.decode_attn_cuda,
            "fused_verify": vf.fused_verify_cuda,
            "fused_verify_tree": vf.fused_verify_tree_cuda,
            "ln_fwd": LN.ln_fwd_cuda}


def decode_prompt(torch, dev):
    g = torch.Generator(device=dev).manual_seed(3)
    return torch.randint(0, MODEL["vocab_size"],
                         (DECODE_BATCH, DECODE_PROMPT), generator=g,
                         device=dev, dtype=torch.int32)


def decode_loop(eng, params, cache, tok):
    """DECODE_NEW - 1 greedy steps from the prefill's token; returns the
    (b, DECODE_NEW) tokens."""
    out = [tok]
    for t in range(DECODE_NEW - 1):
        cache, tok, _ = eng.decode_step(params, cache, tok,
                                        DECODE_PROMPT + t)
        out.append(tok)
    return out


def phase_decode(torch, model, params, dev):
    """The bench.py --decode leg on DecodeEngine: a warm-up, then with the
    decode kernels' counters zeroed just before and read just after, 3
    timed prefills and 3 timed loops of 127 greedy decode steps (each
    after an untimed prefill), all into one cache whose storage must not
    move."""
    from apex_tpu_torch.inference import DecodeEngine

    eng = DecodeEngine(model, device=dev)
    prompt = decode_prompt(torch, dev)
    cache = eng.init_cache(DECODE_BATCH)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, tok, _ = eng.prefill(params, prompt, cache=cache)  # warm-up
    eng.decode_step(params, cache, tok, DECODE_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = decode_counters()
    for fn in counters.values():
        fn.launches = 0
    counters["flash_fwd_bshd"].wgmma_launches = 0
    pre_times, dec_times, runs = [], [], []
    for _ in range(DECODE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, tok, _ = eng.prefill(params, prompt, cache=cache)
        torch.cuda.synchronize()
        pre_times.append(time.perf_counter() - t0)
    for _ in range(DECODE_PASSES):
        _, tok, _ = eng.prefill(params, prompt, cache=cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_loop(eng, params, cache, tok)
        torch.cuda.synchronize()
        dec_times.append(time.perf_counter() - t0)
        runs.append(torch.stack(out, dim=1))
    launches = {k: counters[k].launches
                for k in ("flash_fwd_bshd", "decode_attn", "ln_fwd")}
    launches["flash_fwd_bshd_wgmma"] = counters["flash_fwd_bshd"].wgmma_launches
    L = MODEL["num_layers"]
    prefills = 2 * DECODE_PASSES
    steps = DECODE_PASSES * (DECODE_NEW - 1)
    check(launches["ln_fwd"] == (2 * L + 1) * (prefills + steps),
          f"decode leg: {launches['ln_fwd']} ln_fwd launches for "
          f"{prefills} prefills + {steps} steps x {2 * L + 1} norms")
    check(launches["flash_fwd_bshd"] == L * prefills
          and launches["flash_fwd_bshd_wgmma"] == L * prefills,
          f"decode leg: {launches['flash_fwd_bshd']} flash_fwd_bshd "
          f"launches ({launches['flash_fwd_bshd_wgmma']} on wgmma) for "
          f"{prefills} prefills x {L} layers")
    check(launches["decode_attn"] == L * steps,
          f"decode leg: {launches['decode_attn']} decode_attn launches for "
          f"{steps} decode steps x {L} layers")
    check({k: v.data_ptr() for k, v in cache.items()} == ptrs,
          "the cache's storage moved: the writes were not in place")
    greedy = runs[0]
    check(all(torch.equal(r, greedy) for r in runs[1:]),
          "greedy decode not reproducible across passes")
    check(((greedy >= 0) & (greedy < MODEL["vocab_size"])).all().item(),
          "decode produced a token outside the vocabulary")
    tokens_per_s = DECODE_BATCH * (DECODE_NEW - 1) / min(dec_times)
    info = {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
            "new_tokens": DECODE_NEW, "decode_steps_per_pass": DECODE_NEW - 1,
            "passes": DECODE_PASSES,
            "prefill_ms": 1e3 * min(pre_times),
            "prefill_ms_passes": [1e3 * t for t in pre_times],
            "decode_tokens_per_s": tokens_per_s,
            "decode_step_ms": 1e3 * min(dec_times) / (DECODE_NEW - 1),
            "decode_pass_ms": [1e3 * t for t in dec_times],
            "decode_spread_pct": 100 * (max(dec_times) - min(dec_times))
            / min(dec_times),
            "cache_gb": eng.cache_bytes(DECODE_BATCH) / 1e9,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "launches_per_prefill": launches["flash_fwd_bshd"] / prefills,
            "launches_per_step": launches["decode_attn"] / steps}
    return eng, cache, greedy, info, launches


def phase_decode_outside(torch, model, params, dev, eng, cache, greedy,
                         loop_s):
    """Outside the counted window: a sampled generate (must differ from
    the greedy tokens), a plain-path generate (the share of identical
    tokens is printed: bf16 near-ties may flip one), and a profiled
    decode loop (device time by kernel, device-busy share)."""
    from apex_tpu_torch.inference import DecodeEngine
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = decode_prompt(torch, dev)
    sampled = DecodeEngine(model, device=dev, **DECODE_SAMPLED).generate(
        params, prompt, DECODE_NEW,
        generator=torch.Generator(device=dev).manual_seed(4))
    check(not torch.equal(sampled, greedy),
          "the sampled generate reproduced the greedy tokens")
    plain = DecodeEngine(model, device=dev, impl="torch").generate(
        params, prompt, DECODE_NEW)
    same = (plain == greedy).float().mean().item()
    rows_same = (plain == greedy).all(dim=1).float().mean().item()
    emit("decode_plain_path", {"share_of_tokens_identical": same,
                               "share_of_rows_identical": rows_same})

    _, tok, _ = eng.prefill(params, prompt, cache=cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_loop(eng, params, cache, tok)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
    steps = DECODE_NEW - 1
    busy_s = sum(k[0] for k in kernels) / 1e6
    return {"decode_steps": steps, "device_busy_s": busy_s,
            "decode_loop_wall_s": loop_s,
            "device_busy_share": busy_s / loop_s,
            "device_launches_per_step": sum(k[1] for k in kernels) / steps,
            "top": [{"kernel": name[:90], "device_ms_per_step":
                     t / 1e3 / steps, "launches_per_step": n / steps}
                    for t, n, name in kernels[:8]]}


def spec_prompt(torch, dev):
    rng = np.random.default_rng(6)
    block = rng.integers(0, MODEL["vocab_size"], SPEC_BLOCK)
    return torch.tensor(np.tile(block, SPEC_REPS)[None].astype(np.int32),
                        device=dev)


def phase_spec(torch, model, params, dev):
    """Speculative decoding at batch 1 on DecodeEngine: the chain with
    ModelDrafter (the target as its own drafter) and NGramDrafter, the
    tree with NGramTreeDrafter(4, 2), each greedy, then the n-gram chain
    once sampled. The verify counters are zeroed just before each run and
    read just after: one launch per round."""
    from apex_tpu_torch.inference import DecodeEngine
    from apex_tpu_torch.spec import (ModelDrafter, NGramDrafter,
                                     NGramTreeDrafter)

    prompt = spec_prompt(torch, dev)
    greedy = DecodeEngine(model, device=dev)
    baseline = greedy.generate(params, prompt, SPEC_NEW)  # also a warm-up
    counters = decode_counters()
    runs = [("chain_model", greedy, lambda: ModelDrafter(
                model, params, k=SPEC_K, device=dev), "fused_verify"),
            ("chain_ngram", greedy, lambda: NGramDrafter(SPEC_K),
             "fused_verify"),
            ("tree_ngram", greedy, lambda: NGramTreeDrafter(SPEC_K, 2),
             "fused_verify_tree"),
            ("chain_ngram_sampled",
             DecodeEngine(model, device=dev, **DECODE_SAMPLED),
             lambda: NGramDrafter(SPEC_K), "fused_verify")]
    launches = {"fused_verify": 0, "fused_verify_tree": 0}
    by_mode = {k: {"greedy": 0, "sampled": 0} for k in launches}
    info = {}
    for name, eng, make, kernel in runs:
        draft = make()
        gen = (torch.Generator(device=dev).manual_seed(8)
               if eng.temperature > 0 else None)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(params, prompt, SPEC_NEW, generator=gen,
                           draft=draft)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counters[kernel].launches
        other = [k for k in launches if k != kernel][0]
        st = eng.last_spec_stats
        check(n == st.rounds and counters[other].launches == 0,
              f"spec {name}: {n} {kernel} launches for {st.rounds} rounds")
        check(out.shape == (1, SPEC_NEW) and ((out >= 0) & (
            out < MODEL["vocab_size"])).all().item(),
              f"spec {name}: bad output")
        launches[kernel] += n
        by_mode[kernel]["sampled" if eng.temperature > 0 else "greedy"] += n
        info[name] = {
            "rounds": st.rounds, "drafted": st.drafted,
            "accepted": st.accepted, "nodes": st.nodes,
            "acceptance_rate": st.acceptance_rate,
            "tokens_per_round": SPEC_NEW / max(st.rounds, 1),
            "verify_launches": n, "wall_s": wall,
            "tokens_per_s": SPEC_NEW / wall,
            "share_identical_to_plain_greedy":
                (out == baseline).float().mean().item()}
    t0 = time.perf_counter()
    greedy.generate(params, prompt, SPEC_NEW)
    torch.cuda.synchronize()
    info["plain_greedy"] = {"tokens_per_s": SPEC_NEW
                            / (time.perf_counter() - t0)}
    info["verify_launches_by_mode"] = by_mode
    return info, launches


def verify_gap(kernels, by_mode):
    """The spec leg's launches x (time - bound) of each verify kernel, each
    mode at its own time and bound at the spec leg's shape."""
    out, total = {}, 0.0
    for k in kernels:
        if k["name"] not in by_mode:
            continue
        modes = {"greedy": {"ms": k["ms"], "bound_ms": k["bound_ms"]},
                 "sampled": k["sampled"]}
        for mode, n in by_mode[k["name"]].items():
            gap = n * (modes[mode]["ms"] - modes[mode]["bound_ms"])
            out[f"{k['name']}_{mode}"] = {"launches": n, "gap_ms": gap}
            total += gap
    return dict(out, total_gap_ms=total)



# --- speculative serving ------------------------------------------------------

# the spec_serve leg: the serve's GPT-medium, ENGINE and trace; the model
# drafter a 2-layer GPT at GPT-medium's widths and vocabulary, its own
# weights from SPEC_DRAFTER_SEED; drafted trees of depth SPEC_K x
# branching 2, chains of SPEC_K
SPEC_DRAFTER = dict(MODEL, num_layers=2)
SPEC_DRAFTER_SEED = 5
# pool sizes tried in turn for the preemption serve, down to the first at
# which a stream holding drafter blocks is preempted. Above 21 the drafter's
# headroom check keeps it out of a short pool, so the streams preempted
# there held none at 37, 33, 29 and 25 blocks (PERF.md §6)
SPEC_PREEMPT_BLOCKS = (21, 17)
# a greedy spec serve may leave the plain serve's tokens only at a near-tie:
# the plain path's top-2 logit gap at the first diverging position at most
# this share of the top-1 logit's magnitude (teacher-forced forward)
SPEC_TIE_SHARE = 2.0 ** -6


def spec_serve_counters():
    """The serve's kernels by name, their launches counted by mode where
    the verify pair ran with top-p."""
    from apex_tpu_torch.ops import decode_attention as D
    from apex_tpu_torch.ops import fused_verify as vf
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import sampling as SM

    return {"paged_decode_attn": (D.paged_decode_attn_cuda, "launches"),
            "fused_sample": (SM.fused_sample_cuda, "launches"),
            "ln_fwd": (LN.ln_fwd_cuda, "launches"),
            "fused_verify": (vf.fused_verify_cuda, "launches"),
            "fused_verify_tree": (vf.fused_verify_tree_cuda, "launches"),
            "fused_verify_top_p": (vf.fused_verify_cuda, "top_p_launches"),
            "fused_verify_tree_top_p": (vf.fused_verify_tree_cuda,
                                        "top_p_launches")}


def spec_serve_run(torch, model, params, dev, what, *, draft=None,
                   adaptive=None, reqs=None, num_blocks=None,
                   sampled=False, on_scheduler=None):
    """One serve of ``reqs`` (default the whole trace) on a fresh engine,
    with the launch counters zeroed just before and read just after, held
    to the leg's equalities: one fused_verify launch per chain round, one
    fused_verify_tree launch per tree round (sampled: each a top-p
    launch), 12 paged-decode launches per plain step and the drafter's
    layers per drafter step, 25 ln_fwd per model forward and the
    drafter's 2 x layers + 1 per drafter step, one sampling launch per
    plain step and prefill chunk when sampled (none greedy). At drain the
    pool's accounting is exact, no block lives beyond the prefix cache's
    residents and the drafter holds none. Returns (tokens by rid, info,
    launches)."""
    from apex_tpu_torch.serving.engine import ServingEngine

    kw = dict(ENGINE)
    if num_blocks is not None:
        kw["num_blocks"] = num_blocks
    if sampled:
        kw.update(SAMPLED)
    eng = ServingEngine(model, device=dev, **kw)
    sched = eng.make_scheduler()
    if on_scheduler is not None:
        on_scheduler(sched)
    reqs = build_trace() if reqs is None else reqs
    gen = (torch.Generator(device=dev).manual_seed(11) if sampled
           else None)
    counters = spec_serve_counters()
    steps0 = getattr(draft, "steps", 0)
    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    done = eng.serve(params, reqs, scheduler=sched, generator=gen,
                     draft=draft, adaptive=adaptive)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    d_steps = getattr(draft, "steps", 0) - steps0
    check(len(done) == len(reqs), f"spec serve {what} lost requests")
    for r in done:
        check(len(r.tokens) == r.max_new_tokens
              and all(0 <= t < MODEL["vocab_size"] for t in r.tokens),
              f"spec serve {what}: request {r.rid} bad tokens")
    alloc = sched.allocator
    alloc.check_accounting()
    check(alloc.num_live == alloc.num_resident, f"spec serve {what}: blocks "
          f"live beyond the prefix cache's residents after drain")
    if hasattr(draft, "pool_blocks"):
        check(draft.pool_blocks() == 0, f"spec serve {what}: drafter blocks "
              f"left in the pool")
    st = eng.last_stats
    L = MODEL["num_layers"]
    dL = draft.model.config.num_layers if d_steps else 0
    chain = st.spec_rounds - st.tree_rounds
    plain = st.decode_steps - st.spec_rounds
    forwards = st.prefill_chunks + st.decode_steps
    want = {"fused_verify": chain, "fused_verify_tree": st.tree_rounds,
            "fused_verify_top_p": chain if sampled else 0,
            "fused_verify_tree_top_p": st.tree_rounds if sampled else 0,
            "paged_decode_attn": L * plain + dL * d_steps,
            "ln_fwd": (2 * L + 1) * forwards + (2 * dL + 1) * d_steps,
            "fused_sample": st.prefill_chunks + plain if sampled else 0}
    for k, n in want.items():
        check(launches[k] == n, f"spec serve {what}: {launches[k]} {k} "
              f"launches, want {n} ({chain} chain and {st.tree_rounds} tree "
              f"rounds, {plain} plain steps, {st.prefill_chunks} chunks, "
              f"{d_steps} drafter steps)")
    n_tok = sum(len(r.tokens) for r in done)
    info = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "decode_steps": st.decode_steps,
            "plain_steps": plain, "prefill_chunks": st.prefill_chunks,
            "spec_rounds": st.spec_rounds, "tree_rounds": st.tree_rounds,
            "spec_drafted": st.spec_drafted,
            "spec_accepted": st.spec_accepted,
            "acceptance": st.spec_acceptance_rate,
            "efficiency": st.spec_efficiency,
            "tokens_per_slot_round": ((st.spec_accepted
                                       + st.spec_slot_rounds)
                                      / max(st.spec_slot_rounds, 1)),
            "spec_degraded": st.spec_degraded, "drafter_steps": d_steps,
            "draft_s": st.draft_s, "decode_s": st.decode_s,
            "prefill_s": st.prefill_s,
            "evictions": sum(r.evictions for r in done),
            "preemptions": sched.preemptions,
            "num_blocks": eng.num_blocks, "launches": launches}
    return {r.rid: list(r.tokens) for r in done}, info, launches


def spec_near_ties(torch, model, params, reqs, spec, plain, what):
    """The share of requests whose greedy spec tokens equal the plain
    serve's; at each diverging request the first diverging position and
    the plain path's top-2 logit gap there, from a teacher-forced forward
    of the prompt and the plain tokens before it. Fails unless every
    divergence is a near-tie (gap <= SPEC_TIE_SHARE x |top-1 logit|)."""
    out = []
    for r in reqs:
        a, b = spec[r.rid], plain[r.rid]
        if a == b:
            continue
        pos = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([r.prompt, np.asarray(b[:pos], np.int32)])
        with torch.no_grad():
            row = model.logits(params, torch.tensor(
                seq[None], device=params["lnf_w"].device))[0, -1].float()
        top = row.topk(2).values
        gap, top1 = float(top[0] - top[1]), float(top[0])
        out.append({"rid": r.rid, "position": pos, "plain_token": b[pos],
                    "spec_token": a[pos], "top1_logit": top1,
                    "top2_gap": gap,
                    "near_tie": gap <= SPEC_TIE_SHARE * abs(top1)})
    share = 1.0 - len(out) / len(reqs)
    for d in out:
        check(d["near_tie"], f"spec serve {what}: request {d['rid']} left "
              f"the plain tokens at position {d['position']}, where the "
              f"top-2 gap {d['top2_gap']} exceeds {SPEC_TIE_SHARE} x the "
              f"top-1 logit {d['top1_logit']}")
    return {"share_of_requests_identical": share, "divergences": out}


def phase_spec_serve(torch, model, params, dev):
    """Speculative serving on the serve's GPT-medium, ENGINE and trace:
    a) NGramDrafter(SPEC_K), chain; b) NGramTreeDrafter(SPEC_K, 2), tree;
    c) a PagedModelDrafter (SPEC_DRAFTER, depth SPEC_K x branching 2) in
    the serve's own pool; d) the target as its own PagedModelDrafter on 2
    requests (every draft accepted: the bonus and deepest-path commits
    run); e) a) and b) sampled at SAMPLED (the verify pair's top-p); f)
    c) with the pool lowered (SPEC_PREEMPT_BLOCKS) until a stream holding
    drafter blocks is preempted; g) b) with an AdaptiveSpecController
    (every dispatched tree shape one of its choices). Each serve's
    counters zeroed just before it and read just after
    (``spec_serve_run``); every greedy serve's tokens against the plain
    greedy serve at the same pool size and requests
    (``spec_near_ties``)."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.spec import (AdaptiveSpecController, NGramDrafter,
                                     NGramTreeDrafter, PagedModelDrafter)

    t_leg = time.perf_counter()
    dmodel = GPTModel(GPTConfig(**SPEC_DRAFTER, dtype=torch.bfloat16))
    dparams = dmodel.init(torch.Generator(device=dev).manual_seed(
        SPEC_DRAFTER_SEED), device=dev)
    trace = build_trace()
    totals = {}
    by_mode = {k: {"greedy": 0, "top_p": 0}
               for k in ("fused_verify", "fused_verify_tree")}
    info = {}

    def counted(name, toks_info_launches, sampled=False):
        toks, inf, launches = toks_info_launches
        for k in ("paged_decode_attn", "fused_sample", "ln_fwd",
                  "fused_verify", "fused_verify_tree"):
            totals[k] = totals.get(k, 0) + launches[k]
        for k in by_mode:
            by_mode[k]["top_p" if sampled else "greedy"] += launches[k]
        info[name] = inf
        return toks, inf

    plain, info["plain_greedy"], _ = spec_serve_run(
        torch, model, params, dev, "plain")
    paged = lambda: PagedModelDrafter(  # noqa: E731
        dmodel, dparams, depth=SPEC_K, branching=2, device=dev)
    for name, make in (("a_ngram_chain", lambda: NGramDrafter(SPEC_K)),
                       ("b_ngram_tree", lambda: NGramTreeDrafter(SPEC_K,
                                                                 2)),
                       ("c_paged_model", paged)):
        draft = make()
        toks, inf = counted(name, spec_serve_run(
            torch, model, params, dev, name, draft=draft))
        check(inf["spec_rounds"] > 0, f"spec serve {name}: no round ran")
        if name != "c_paged_model":  # the drafter's pool headroom decides
            check((inf["tree_rounds"] > 0) == (name == "b_ngram_tree"),
                  f"spec serve {name}: {inf['tree_rounds']} tree rounds")
        if name == "c_paged_model":
            check(draft.peak_blocks > 0, "the model drafter never held a "
                  "block of the pool")
            inf["drafter_peak_blocks"] = draft.peak_blocks
        inf["vs_plain"] = spec_near_ties(torch, model, params, trace, toks,
                                         plain, name)
    # d) the target drafting for itself, on 2 requests
    two = build_trace()[:2]
    plain2, _, _ = spec_serve_run(torch, model, params, dev, "plain_2",
                                  reqs=two)
    toks, inf = counted("d_self_draft", spec_serve_run(
        torch, model, params, dev, "d_self_draft",
        draft=PagedModelDrafter(model, params, depth=SPEC_K, branching=2,
                                device=dev), reqs=build_trace()[:2]))
    check(inf["acceptance"] >= 0.9, f"the self-drafted serve accepted "
          f"{inf['acceptance']} of its drafts")
    inf["vs_plain"] = spec_near_ties(torch, model, params, two, toks,
                                     plain2, "d_self_draft")
    # e) sampled, the verify pair's top-p
    for name, make in (("e_sampled_chain", lambda: NGramDrafter(SPEC_K)),
                       ("e_sampled_tree", lambda: NGramTreeDrafter(SPEC_K,
                                                                   2))):
        _, inf = counted(name, spec_serve_run(
            torch, model, params, dev, name, draft=make(), sampled=True),
            sampled=True)
        check(inf["spec_rounds"] > 0, f"spec serve {name}: no round ran")
    # f) the model drafter in a pool small enough to preempt its streams
    for nb in SPEC_PREEMPT_BLOCKS:
        held = []
        draft = paged()

        def watch(sched, draft=draft, held=held):
            preempt = sched._preempt

            def counting(i, now, *a, **k):
                st = draft._streams.get(sched._slots[i].request.rid)
                held.append(bool(st and st["n_blocks"]))
                return preempt(i, now, *a, **k)
            sched._preempt = counting

        plain_nb, _, _ = spec_serve_run(torch, model, params, dev,
                                        f"plain_{nb}", num_blocks=nb)
        toks, inf = counted("f_preempted", spec_serve_run(
            torch, model, params, dev, f"f_preempted_{nb}", draft=draft,
            num_blocks=nb, on_scheduler=watch))
        inf["preempted_holding_drafter_blocks"] = sum(held)
        inf["vs_plain"] = spec_near_ties(torch, model, params, trace, toks,
                                         plain_nb, f"f_preempted_{nb}")
        if sum(held):
            break
    check(inf["preempted_holding_drafter_blocks"] > 0, "no pool size of "
          f"{SPEC_PREEMPT_BLOCKS} preempted a stream holding drafter blocks")
    check(inf["evictions"] > 0 and inf["spec_degraded"] > 0,
          f"the preempted serve at {inf['num_blocks']} blocks: "
          f"{inf['evictions']} evictions, {inf['spec_degraded']} degraded")
    # g) the adaptive controller
    shapes = []
    ctl = AdaptiveSpecController()
    round_shape = ctl.round_shape

    def recording(streams):
        shape = round_shape(streams)
        shapes.append(shape)
        return shape
    ctl.round_shape = recording
    toks, inf = counted("g_adaptive", spec_serve_run(
        torch, model, params, dev, "g_adaptive",
        draft=NGramTreeDrafter(SPEC_K, 2), adaptive=ctl))
    check(shapes and set(shapes) <= set(ctl.choices), f"the adaptive serve "
          f"dispatched shapes {sorted(set(shapes))} outside its choices "
          f"{ctl.choices}")
    inf["shapes_dispatched"] = {str(k): shapes.count(k)
                                for k in sorted(set(shapes))}
    inf["adjustments"] = ctl.adjustments
    inf["vs_plain"] = spec_near_ties(torch, model, params, trace, toks,
                                     plain, "g_adaptive")
    info["verify_launches_by_mode"] = by_mode
    info["leg_s"] = time.perf_counter() - t_leg
    return info, totals


def serve_verify_gap(kernels, by_mode):
    """The spec_serve leg's launches x (time - bound) of each verify
    kernel: greedy launches at the kernel's greedy time at the serve's 8
    slots, top-p launches at its top_p_k50 time (SAMPLED's knobs)."""
    out, total = {}, 0.0
    for k in kernels:
        if k["name"] not in by_mode:
            continue
        per = k["per_shape"][f"8x{k['top_p_shape']['rows']}"]
        for mode, key in (("greedy", "greedy"), ("top_p", "top_p_k50")):
            n = by_mode[k["name"]][mode]
            gap = n * (per[key]["ms"] - per[key]["bound_ms"])
            out[f"{k['name']}_{mode}"] = {"launches": n, "gap_ms": gap}
            total += gap
    return dict(out, total_gap_ms=total)


# --- the T5 slice -------------------------------------------------------------

def t5_attn_case(torch, dev, kind, b, seed, padded):
    """One of the T5 step's three attention calls at batch ``b``, as the
    blocks pass it: q, k, v and do as (b, 12, s, 64) views of projection
    buffers, the stack's bucketed bias and, where ``padded`` (encoder self
    and cross calls only), the per-row kv lengths (seeded encoder pad
    lengths in [256, 512], expanded over the heads)."""
    from apex_tpu_torch.ops import attention as A

    h, d = T5["num_heads"], T5["hidden_size"] // T5["num_heads"]
    sq, sk = {"enc": (T5_ENC, T5_ENC), "dec": (T5_DEC, T5_DEC),
              "cross": (T5_DEC, T5_ENC)}[kind]
    g = torch.Generator(device=dev).manual_seed(seed)
    H = h * d
    rnd = lambda *sh: torch.randn(sh, generator=g,  # noqa: E731
                                  device=dev).bfloat16()
    heads = lambda t, s: t.view(b, s, h, d).transpose(1, 2)  # noqa: E731
    q = heads(rnd(b, sq, H), sq)
    k, v = (heads(t, sk) for t in rnd(b, sk, 2 * H).split(H, -1))
    do = heads(rnd(b, sq, H), sq)
    lens = None
    if padded:
        pad = torch.randint(T5_PAD_MIN, T5_ENC + 1, (b,), generator=g,
                            device=dev, dtype=torch.int32)
        lens = pad[:, None].expand(b, h).reshape(-1).contiguous()
    bias = None
    if kind != "cross":
        table = (torch.randn((T5["relative_num_buckets"], h), generator=g,
                             device=dev) * 0.1).bfloat16()
        bias = A.BucketedBias(table, bidirectional=kind == "enc",
                              max_distance=T5["relative_max_distance"])
    kw = dict(scale=d ** -0.5, causal=kind == "dec", kv_lens=lens,
              rel_bias=bias)
    return (q, k, v, do), kw, (sq, sk, h, d)


# the attention calls compared and timed: (name, call, padded). The timed
# train steps make the unpadded encoder and cross calls, the padded step
# the padded ones; the kernels line's times are the padded encoder call's.
T5_CALLS = (("enc", "enc", True), ("enc_unpadded", "enc", False),
            ("dec", "dec", False), ("cross", "cross", True),
            ("cross_unpadded", "cross", False))


def t5_kv_rows(kw, b, h, sk):
    """The key/value rows this run's data needs: each row's live keys."""
    if kw["kv_lens"] is None:
        return b * h * sk
    return float(kw["kv_lens"].clamp(max=sk).double().sum())


def t5_pairs(kw, b, h, sq, sk):
    """The score pairs this run's data needs: every row's live keys (its
    kv length), causal rows only up to the diagonal."""
    if kw["causal"]:
        return b * h * sq * (sq + 1) / 2
    if kw["kv_lens"] is not None:
        return sq * float(kw["kv_lens"].double().sum())
    return b * h * sq * sk


def t5_library(torch, F, q, k, v, do, kw, sq, sk):
    """One PyTorch call for the same function: SDPA with the
    materialised bias (and the padding and causal masks) as a float
    attn_mask, forward, and its autograd backward. Timed, used nowhere."""
    b, h = q.shape[:2]
    mask = torch.zeros((1, 1, sq, sk), dtype=torch.float32, device=q.device)
    if kw["rel_bias"] is not None:
        mask = mask + kw["rel_bias"].materialize(sq, sk)[None]
    if kw["causal"]:
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril(sk - sq)
        mask = mask.masked_fill(~tri, float("-inf"))
    if kw["kv_lens"] is not None:
        lens = kw["kv_lens"].view(b, h)[:, 0]
        pad = torch.arange(sk, device=q.device)[None, :] >= lens[:, None]
        mask = mask.masked_fill(pad[:, None, None, :], float("-inf"))
    mask = mask.to(q.dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    call = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *leaves, attn_mask=mask, scale=kw["scale"])
    fwd = time_ms(call, [()])
    out = call()
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True), [()],
                  reps=5)
    return fwd, bwd


def phase_t5_kernels(torch, dev):
    """The bh-flat flash forward, dK/dV (with the fused bucket-table
    gradient) and dQ kernels against their plain versions at the T5
    step's three attention shapes (all b·h = 128·12, d 64, bf16): encoder
    self 512 x 512 with bidirectional buckets, decoder self 114 x 114 with
    causal buckets, cross 114 x 512 with no bias; the encoder self and
    cross calls both with kv_lens in [256, 512] (the padded step's) and
    without (the timed steps'), see T5_CALLS. Each kernel timed at each
    call beside its plain version, SDPA with the materialised bias, and
    its bound (K and V read over the live rows only)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    per_shape, errs = {}, {"fwd": 0.0, "dkv": 0.0, "dq": 0.0, "dtable": 0.0}
    for i, (name_, kind, padded) in enumerate(T5_CALLS):
        (q, k, v, do), kw, (sq, sk, h, d) = t5_attn_case(
            torch, dev, kind, T5_BATCH, seed=40 + i, padded=padded)
        shape = {"call": name_, "bh": T5_BATCH * h, "sq": sq, "sk": sk,
                 "d": d, "causal": kw["causal"],
                 "kv_lens": kw["kv_lens"] is not None,
                 "rel_bias": kw["rel_bias"] is not None}
        up = lambda ts: [t.float() for t in ts]  # noqa: E731
        o, lse = A.flash_fwd(q, k, v, **kw)
        o_p, lse_p = A.flash_fwd(q, k, v, impl="torch", **kw)
        o_t, lse_t = A.flash_fwd(*up((q, k, v)), impl="torch", **kw)
        torch.cuda.synchronize()
        errs["fwd"] = max(errs["fwd"],
                          rule_check("flat o", o, o_p, o_t, shape),
                          rule_check("flat lse", lse, lse_p, lse_t, shape))
        fwd_checks(torch, "bhsd", (q, k, v), kw, (o_p, lse_p), (o_t, lse_t),
                   shape, f"t5 {name_}")
        del o, o_t, lse_t
        got = A.flash_bwd(q, k, v, o_p, lse_p, do, **kw)
        plain = A.flash_bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
        truth = A.flash_bwd(*up((q, k, v, o_p)), lse_p, do.float(),
                            impl="torch", **kw)
        torch.cuda.synchronize()
        for name, g_, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
            check(torch.isfinite(g_.float()).all().item(),
                  f"flat {name} kernel output not finite at {shape}")
            e = rule_check(f"flat {name}", g_, p_, t_, shape)
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], e)
        if kw["rel_bias"] is not None:
            rel = ((got[3] - plain[3]).norm() / plain[3].norm()).item()
            emit("flash_check", {"output": "flat dtable", "shape": shape,
                                 "rel_norm_err": rel, "tol": T5_DTABLE_TOL})
            check(rel <= T5_DTABLE_TOL, f"dtable kernel vs plain: rel norm "
                  f"err {rel} > {T5_DTABLE_TOL} at {shape}")
            errs["dtable"] = max(errs["dtable"],
                                 (got[3] - plain[3]).abs().max().item())
        else:
            check(got[3] is None, "a table gradient without a bias")
        pair_checks(torch, "bhsd", (q, k, v, o_p, lse_p, do), kw, plain,
                    truth, shape, f"t5 {name_}")
        del got, plain, truth
        torch.cuda.empty_cache()

        # times at this shape; the plain versions at a few repetitions
        o, lse = A.flash_fwd(q, k, v, **kw)
        no_table = {}
        if kw["rel_bias"] is not None:  # the same call without the bias
            nob = dict(kw, rel_bias=None)
            for var in ("wgmma", "sm80"):
                _, delta = A.flash_bwd_flat_dq_cuda(q, k, v, o, lse, do,
                                                    variant=var, **nob)
                no_table[var] = time_ms(
                    lambda: A.flash_bwd_flat_dkv_cuda(
                        q, k, v, o, lse, do, delta=delta, variant=var,
                        **nob), [()])
        plain_fwd = time_ms(lambda: A.flash_fwd(q, k, v, impl="torch", **kw),
                            [()], reps=2, trials=3)
        plain_bwd = time_ms(lambda: A.flash_bwd(q, k, v, o, lse, do,
                                                impl="torch", **kw),
                            [()], reps=2, trials=3)
        torch.cuda.empty_cache()
        lib_fwd, lib_bwd = t5_library(torch, F, q, k, v, do, kw, sq, sk)
        fab = fwd_ab_times(torch, "bhsd", [(q, k, v)], kw,
                           f"flat, T5 {name_}", lib_fwd)
        ms_fwd = fab["wgmma"]
        ab = ab_times(torch, "bhsd", (q, k, v, o, lse, do), kw,
                      f"flat, T5 {name_}", lib_bwd)
        ms_dkv, ms_dq = ab["wgmma"]["dkv_ms"], ab["wgmma"]["dq_ms"]

        b = T5_BATCH
        pairs = t5_pairs(kw, b, h, sq, sk)
        t_q = b * h * sq * d * 2  # one (b, h, sq, d) bf16 tensor
        t_k = b * h * sk * d * 2  # one (b, h, sk, d) bf16 output, written whole
        t_k_in = t5_kv_rows(kw, b, h, sk) * d * 2  # k or v: live rows read
        small = b * h * sq * 4 + (0 if kw["kv_lens"] is None else b * h * 4)
        fwd_b = bound(t_q + 2 * t_k_in + t_q + small, 4 * d * pairs,
                      BF16_OPS_PER_S)
        bwd_in = 3 * t_q + 2 * t_k_in + small  # q, o, do, k, v, lse (+lens)
        dkv_b = bound(bwd_in + 2 * t_k, 8 * d * pairs, BF16_OPS_PER_S)
        dq_b = bound(bwd_in + t_q, 6 * d * pairs, BF16_OPS_PER_S)
        fn_b = bound(bwd_in + t_q + 2 * t_k, 10 * d * pairs, BF16_OPS_PER_S)
        # the table gradient alone: dS needs QK^T and dP (4d per pair)
        dt_b = bound(bwd_in, 4 * d * pairs, BF16_OPS_PER_S)
        per_shape[name_] = {
            "shape": shape, "score_pairs": pairs,
            "fwd_ms": ms_fwd, "dkv_ms": ms_dkv, "dq_ms": ms_dq,
            "sm80_fwd_ms": fab["sm80"], "sm80_dkv_ms": ab["sm80"]["dkv_ms"],
            "sm80_dq_ms": ab["sm80"]["dq_ms"], "ab_turns_ms": ab["turns_ms"],
            "dkv_no_table_ms": no_table.get("wgmma"),
            "sm80_dkv_no_table_ms": no_table.get("sm80"),
            "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd,
            "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
            "fwd_bound": fwd_b, "dkv_bound": dkv_b, "dq_bound": dq_b,
            "bwd_function_bound": fn_b, "dtable_bound": dt_b}
        emit("t5_kernel_times", per_shape[name_])
        del q, k, v, do, o, lse, o_p, lse_p
        torch.cuda.empty_cache()

    enc = per_shape["enc"]
    timed = dict(enc["shape"], dtype="bf16",
                 layout="(b, h, s, d) views of the projection output")
    src = "apex_tpu_torch/csrc/"
    plain_note = ("one plain backward computes dq, dk, dv and the table "
                  "gradient together; its time is given for each")
    lib_note = ("F.scaled_dot_product_attention with the materialised bias "
                "and padding as a float attn_mask; its autograd backward "
                "computes dq, dk and dv in one call")
    per = {k_: {f: v_ for f, v_ in s_.items() if f != "shape"}
           for k_, s_ in per_shape.items()}
    return [
        {"name": "flash_fwd_flat", "route": "cuda",
         "source": src + "flash_attn_fwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:436",
         "max_abs_err": errs["fwd"], "ms": enc["fwd_ms"],
         "sm80_ms": enc["sm80_fwd_ms"],
         "plain_ms": enc["plain_fwd_ms"], "bound_ms": enc["fwd_bound"][0],
         "bound_by": enc["fwd_bound"][1], "library_ms": enc["sdpa_fwd_ms"],
         "variant_note": FWD_VARIANT_NOTE,
         "library_note": "F.scaled_dot_product_attention forward with the "
                         "materialised bias and padding as attn_mask",
         "timed_shape": timed, "per_shape": per},
        {"name": "flash_bwd_flat_dkv", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:1302",
         "max_abs_err": errs["dkv"], "ms": enc["dkv_ms"],
         "sm80_ms": enc["sm80_dkv_ms"],
         "plain_ms": enc["plain_bwd_ms"], "bound_ms": enc["dkv_bound"][0],
         "bound_by": enc["dkv_bound"][1], "library_ms": enc["sdpa_bwd_ms"],
         "plain_note": plain_note, "library_note": lib_note,
         "variant_note": VARIANT_NOTE,
         "backward": {"function": "flash_bwd (dq, dk, dv, dtable)",
                      "ms": enc["dkv_ms"] + enc["dq_ms"],
                      "sm80_ms": enc["sm80_dkv_ms"] + enc["sm80_dq_ms"],
                      "bound_ms": enc["bwd_function_bound"][0],
                      "bound_by": enc["bwd_function_bound"][1]},
         "timed_shape": timed},
        {"name": "flash_bwd_flat_dq", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:1277",
         "max_abs_err": errs["dq"], "ms": enc["dq_ms"],
         "sm80_ms": enc["sm80_dq_ms"],
         "plain_ms": enc["plain_bwd_ms"], "bound_ms": enc["dq_bound"][0],
         "bound_by": enc["dq_bound"][1], "library_ms": enc["sdpa_bwd_ms"],
         "plain_note": plain_note, "library_note": lib_note,
         "variant_note": VARIANT_NOTE, "timed_shape": timed},
        {"name": "flash_bwd_flat_dtable", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:1212",
         "max_abs_err": errs["dtable"], "ms": enc["dkv_ms"],
         "sm80_ms": enc["sm80_dkv_ms"],
         "marginal_ms": enc["dkv_ms"] - enc["dkv_no_table_ms"],
         "sm80_marginal_ms": enc["sm80_dkv_ms"] - enc["sm80_dkv_no_table_ms"],
         "plain_ms": enc["plain_bwd_ms"],
         "bound_ms": enc["dtable_bound"][0],
         "bound_by": enc["dtable_bound"][1], "library_ms": None,
         "note": "computed inside the dK/dV kernel (no launch of its own): "
                 "ms is that launch's time, marginal_ms its time less the "
                 "same call without the bias; launches count the dK/dV "
                 "launches that carry the table gradient",
         "plain_note": plain_note,
         "library_note": "no single PyTorch call returns the bucket-table "
                         "gradient",
         "timed_shape": timed},
    ]


def t5_flops_per_step(b, s_enc, s_dec):
    """Model FLOPs of one T5 train step (forward + backward, no remat
    recompute), bench.py:108-117's convention carried to the
    encoder-decoder: 6 x the matmul parameters each token passes through
    (encoder: qkv, out, MLP = 4H^2 + 2HF per layer; decoder: self qkv,
    out, cross q, out, MLP = 6H^2 + 2HF, plus the cross k/v projection
    2H^2 applied to every encoder token in every decoder layer; the tied
    head VH per decoder token) plus 12 x H x keys per query token per
    layer for attention (encoder s_enc; decoder s_dec self + s_enc
    cross), causal rows counted whole as bench.py does."""
    H, Fh, V = T5["hidden_size"], T5["ffn_hidden_size"], T5["vocab_size"]
    Le, Ld = T5["num_encoder_layers"], T5["num_decoder_layers"]
    te, td = b * s_enc, b * s_dec
    matmul = (te * Le * (4 * H * H + 2 * H * Fh)
              + td * Ld * (6 * H * H + 2 * H * Fh)
              + te * Ld * 2 * H * H + td * V * H)
    attn = 12 * H * (te * Le * s_enc + td * Ld * (s_dec + s_enc))
    return 6 * matmul + attn


def t5_ln_counts():
    """(ln_fwd, ln_bwd) per T5 step with per-block remat: 2 norms per
    encoder block and 3 per decoder block, run again by the recompute, and
    the two final norms once."""
    blocks = 2 * T5["num_encoder_layers"] + 3 * T5["num_decoder_layers"]
    return {"ln_fwd": 2 * blocks + 2, "ln_bwd": blocks + 2}


def t5_check_launches(launches, steps, what):
    """Per step, with per-block remat: each of the 36 attention calls runs
    its forward twice (the recompute), its dK/dV and dQ once, all on the
    wgmma variant; the 24 self-attention calls carry the bucket table; one
    xent_stats; the norms (t5_ln_counts); no other flash or softmax
    kernel."""
    L = T5["num_encoder_layers"] + 2 * T5["num_decoder_layers"]
    table = T5["num_encoder_layers"] + T5["num_decoder_layers"]
    check_launches(launches, {"flash_fwd_flat": 2 * L,
                              "flash_fwd_flat_wgmma": 2 * L,
                              "flash_bwd_flat_dkv": L, "flash_bwd_flat_dq": L,
                              "flash_bwd_flat_dkv_wgmma": L,
                              "flash_bwd_flat_dq_wgmma": L,
                              "flash_bwd_flat_dtable": table,
                              "xent_stats": 1, **t5_ln_counts()}, steps,
                   what)


def t5_batch(torch, dev, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    V = T5["vocab_size"]
    enc = torch.randint(0, V, (b, T5_ENC), generator=g, device=dev)
    dec = torch.randint(0, V, (b, T5_DEC), generator=g, device=dev)
    tgt = torch.randint(0, V, (b, T5_DEC), generator=g, device=dev)
    pad = torch.randint(T5_PAD_MIN, T5_ENC + 1, (b,), generator=g,
                        device=dev, dtype=torch.int32)
    return enc, dec, tgt, pad


def t5_step(model, params, opt, enc, dec, tgt, pad=None):
    loss = model.loss_fn(params, enc, dec, tgt, enc_pad_lens=pad)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def phase_t5_train(torch, dev):
    """The T5 slice's main path: EncoderDecoderModel.loss_fn, backward and
    one FusedAdam step at T5-base width, batch 128 x (512, 114): a
    warm-up, then T5_STEPS timed steps with the counters zeroed just
    before and read just after."""
    from apex_tpu_torch.models.t5 import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = t5_model(torch, dev, torch.bfloat16)
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    enc, dec, tgt, _ = t5_batch(torch, dev, T5_BATCH, seed=1)
    losses, wall, launches = timed_steps(
        torch, lambda: t5_step(model, params, opt, enc, dec, tgt), T5_STEPS,
        "T5 train path")
    t5_check_launches(launches, T5_STEPS, "T5 train path")
    tok = T5_BATCH * (T5_ENC + T5_DEC) * T5_STEPS
    flops = t5_flops_per_step(T5_BATCH, T5_ENC, T5_DEC) * T5_STEPS / wall
    info = {"batch": T5_BATCH, "enc_len": T5_ENC, "dec_len": T5_DEC,
            "steps": T5_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / T5_STEPS,
            "tokens_per_s": tok / wall, "tokens": "encoder + decoder",
            "model_flops_per_step": t5_flops_per_step(T5_BATCH, T5_ENC,
                                                      T5_DEC),
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "card": torch.cuda.get_device_name(0),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: v / T5_STEPS
                                  for k, v in launches.items() if v}}
    return (model, params, opt), info, launches


def phase_t5_padded(torch, state, dev):
    """One step of a padded batch (seeded encoder lengths in [256, 512]):
    finite loss, the same launches per step."""
    model, params, opt = state
    enc, dec, tgt, pad = t5_batch(torch, dev, T5_BATCH, seed=2)
    zero_counters()
    loss = float(t5_step(model, params, opt, enc, dec, tgt, pad))
    torch.cuda.synchronize()
    launches = read_counters()
    check(np.isfinite(loss), f"T5 padded step: loss {loss}")
    t5_check_launches(launches, 1, "T5 padded step")
    return {"loss": loss, "enc_pad_lens_min": int(pad.min()),
            "enc_pad_lens_max": int(pad.max()),
            "launches": {k: v for k, v in launches.items() if v}}


def t5_model(torch, dev, dtype, cfg=None):
    from apex_tpu_torch.models.t5 import (EncoderDecoderModel, T5Config,
                                          param_leaves)

    model = EncoderDecoderModel(T5Config(**(cfg or T5), dtype=dtype))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    for t in param_leaves(params):
        t.requires_grad_()
    return model, params


def phase_t5_plain(torch, model, params, enc, dec, tgt, pad, what,
                   bound_kernel_vs_plain, cfg=None):
    """One T5 step's loss and gradients at ``params`` on the given batch,
    kernel path vs plain path vs an fp32 truth (compare_paths). The
    kernel-vs-plain bound holds only where ``bound_kernel_vs_plain`` (the
    initial params). Not at the trained params: with the tied N(0, 1)
    embedding the logits are large and the softmax near one-hot, and
    after a few Adam steps some leaves' gradients (the cross-attention
    projections) shrink until bf16 rounding moves them tens of percent in
    BOTH paths, which the fp32 truth shows and a kernel-vs-plain bound
    cannot tell from a fault."""
    model32, params32 = t5_model(torch, enc.device, torch.float32, cfg)
    upcast_copy(torch, params32, params)

    def run(p, impl):
        m = model32 if p is params32 else model
        return m.loss_fn(p, enc, dec, tgt, enc_pad_lens=pad, impl=impl)

    info = compare_paths(torch, run, params, params32, what,
                         bound_kernel_vs_plain)
    info.update(batch=enc.shape[0], enc_pad_lens=pad is not None)
    return info


# --- the BERT slice and the array bias ----------------------------------------

# BERT-large (Devlin et al. 2019: 24 layers, hidden 1024, 16 heads of 64,
# FFN 4096) at pretraining phase 2's sequence 512, with the repo's
# BertConfig vocab of 30592 (BERT's 30522 padded to a multiple of 128);
# bf16, per-block remat, FusedAdam(lr=1e-4); batch 32 x 512
BERT = dict(vocab_size=30592, max_seq_len=512, hidden_size=1024,
            ffn_hidden_size=4096, num_layers=24, num_heads=16, remat=True,
            attention_impl="flash")
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 10
BERT_PAD_MIN = 64       # padded lengths uniform in [64, 512]: ~44% padding
BERT_MASK_RATE = 0.15   # BERT's masking rate over the valid positions
DBIAS_TOL = 1e-3        # dbias: relative norm error vs the fp32 plain version
T5_MAT_STEPS = 3        # timed steps of the T5 materialized-bias leg
T5_MAT_GRAD_TOL = 1e-2  # each leaf, materialized vs bucketed: rel norm


def packed_views(torch, dev, b, s, h, h_kv, d, seed):
    """q (b, s, h, d), k/v (b, s, h_kv, d) as views of one packed (b, s,
    (h + 2·h_kv)·d) projection buffer, as BERT's blocks pass them, and a
    (b, s, h, d) do."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((b, s, (h + 2 * h_kv) * d), generator=g,
                    device=dev).bfloat16()
    do = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    return (y[..., :h * d].view(b, s, h, d),
            y[..., h * d:(h + h_kv) * d].view(b, s, h_kv, d),
            y[..., (h + h_kv) * d:].view(b, s, h_kv, d), do)


def seeded_lens(torch, dev, b, lo, hi, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)


def family_check(torch, layout, q, k, v, do, kw, shape, errs, tag):
    """One flash family (``layout`` "bshd": the seq-major dispatchers,
    "bhsd": the bh-flat ones) against its plain version and the fp32
    truth: o and lse (also on the sm80 variant, its planted faults
    refused, wgmma's bit-identical; fwd_checks), then dq, dk and dv on the
    plain forward's o and lse by the flash rule (likewise; pair_checks);
    dbias, with an array bias, within DBIAS_TOL relative norm of the fp32
    plain version (likewise; dbias_checks). A row of kv length 0 must give
    zeros."""
    from apex_tpu_torch.ops import attention as A

    fwd, bwd = ((A.flash_fwd_bshd, A.flash_bwd_bshd) if layout == "bshd"
                else (A.flash_fwd, A.flash_bwd))
    up = lambda ts: [t.float() for t in ts]  # noqa: E731
    o, lse = fwd(q, k, v, **kw)
    o_p, lse_p = fwd(q, k, v, impl="torch", **kw)
    o_t, lse_t = fwd(*up((q, k, v)), impl="torch", **kw)
    torch.cuda.synchronize()
    errs["fwd"] = max(errs["fwd"], rule_check(f"{tag} o", o, o_p, o_t, shape),
                      rule_check(f"{tag} lse", lse, lse_p, lse_t, shape))
    fwd_checks(torch, layout, (q, k, v), kw, (o_p, lse_p), (o_t, lse_t),
               shape, tag)
    lens = kw.get("kv_lens")
    if lens is not None and bool((lens == 0).any()):
        dead = lens == 0  # (b,) on bshd, (b·h,) rows on bhsd
        od = o[dead] if layout == "bshd" else o.reshape(
            -1, *o.shape[-2:])[dead]
        check(not od.float().any() and not lse[dead].any(),
              f"{tag}: a row of kv length 0 is not zeros at {shape}")
    del o, lse, o_t, lse_t
    got = bwd(q, k, v, o_p, lse_p, do, **kw)
    plain = bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = bwd(*up((q, k, v, o_p)), lse_p, do.float(), impl="torch", **kw)
    torch.cuda.synchronize()
    for name, g_, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
        check(torch.isfinite(g_.float()).all().item(),
              f"{tag} {name} kernel output not finite at {shape}")
        e = rule_check(f"{tag} {name}", g_, p_, t_, shape)
        key = "dq" if name == "dq" else "dkv"
        errs[key] = max(errs[key], e)
    pair_checks(torch, layout, (q, k, v, o_p, lse_p, do), kw, plain, truth,
                shape, tag)
    if kw.get("bias") is not None:
        rel = ((got[3] - truth[3]).norm() / truth[3].norm()).item()
        emit("flash_check", {"output": f"{tag} dbias", "shape": shape,
                             "rel_norm_err": rel, "tol": DBIAS_TOL})
        check(rel <= DBIAS_TOL, f"dbias kernel vs the fp32 plain version: "
              f"rel norm err {rel} > {DBIAS_TOL} at {shape}")
        errs["dbias"] = max(errs["dbias"],
                            (got[3] - truth[3]).abs().max().item())
        dbias_checks(torch, layout, (q, k, v, o_p, lse_p, do, kw["bias"]),
                     kw, truth[3], shape, tag)
    del got, plain, truth, o_p, lse_p
    torch.cuda.empty_cache()


def sdpa_times(torch, F, q4, k4, v4, do4, scale, causal, lens, bias):
    """One PyTorch call for the same function on (b, h, s, d) views: SDPA
    with the padding as a key mask (boolean without a bias, else folded
    into a float mask with the bias and the causal mask), forward and its
    autograd backward; with a bias, also the backward that returns the
    float mask's gradient beside dq, dk and dv. Timed, used nowhere.
    Returns (fwd ms, backward ms, backward-with-the-mask's-gradient ms or
    None)."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    dev = q4.device
    mask = None
    if lens is not None:
        mask = (torch.arange(sk, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
    if bias is not None:
        fmask = bias.repeat(h // bias.shape[0], 1, 1)[None]
        if causal:
            tri = torch.ones((sq, sk), dtype=torch.bool,
                             device=dev).tril(sk - sq)
            fmask = fmask.masked_fill(~tri, float("-inf"))
        if mask is not None:
            fmask = fmask.masked_fill(~mask, float("-inf"))
        mask = fmask.to(q4.dtype)
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    is_causal = causal and bias is None

    def call(m):
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=m, scale=scale, is_causal=is_causal)

    fwd = time_ms(lambda: call(mask), [()])
    out = call(mask)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do4,
                                              retain_graph=True), [()],
                  reps=5)
    if bias is None:
        return fwd, bwd, None
    mask = mask.detach().requires_grad_()
    out = call(mask)
    dbias = time_ms(lambda: torch.autograd.grad(out, [*leaves, mask], do4,
                                                retain_graph=True), [()],
                    reps=5)
    del out, mask
    return fwd, bwd, dbias


def flash_bounds(b, h, h_kv, sq, sk, d, pairs, live_kv_rows, bias=None):
    """Bounds of the flash family at one call, from this run's data:
    ``pairs`` the score pairs the masks keep, ``live_kv_rows`` the kv rows
    they read (each kv head's rows up to its sequence's length). Bytes:
    each input read once (k and v over the live rows only), each output
    written once (dK and dV whole); operations per pair: 4d forward, 8d
    dK/dV, 6d dQ, 10d the function the backward pair replaces, 4d dbias
    (QK^T and dP). An array bias adds its read. dbias reads q, do, k, v,
    lse, delta and the bias (no o: delta is its operand, as in the
    reference) and writes dbias."""
    t_q = b * h * sq * d * 2
    t_kv_in = live_kv_rows * d * 2
    t_kv_out = b * h_kv * sk * d * 2
    small = b * h * sq * 4 + b * 4
    nb = 0 if bias is None else bias.numel() * 4
    bwd_in = 3 * t_q + 2 * t_kv_in + small + nb
    dbias_in = 2 * t_q + 2 * t_kv_in + small + b * h * sq * 4 + nb
    return {"fwd": bound(2 * t_q + 2 * t_kv_in + small + nb, 4 * d * pairs,
                         BF16_OPS_PER_S),
            "dkv": bound(bwd_in + 2 * t_kv_out, 8 * d * pairs,
                         BF16_OPS_PER_S),
            "dq": bound(bwd_in + t_q, 6 * d * pairs, BF16_OPS_PER_S),
            "function": bound(bwd_in + t_q + 2 * t_kv_out + nb,
                              10 * d * pairs, BF16_OPS_PER_S),
            "dbias": bound(dbias_in + nb, 4 * d * pairs, BF16_OPS_PER_S)}


def phase_bert_kernels(torch, dev):
    """The bshd forward with kv_lens, dQ and dK/dV kernels against their
    plain versions at BERT-large's shape (b 32, s 512, 16 heads of 64, on
    views of one packed projection; seeded lengths in [64, 512] with one
    full row and one of length 0) and at a GQA shape; times, SDPA with the
    key-padding mask, and bounds at BERT's shape."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0, "dbias": 0.0}
    H, h = BERT["hidden_size"], BERT["num_heads"]
    d = H // h
    b, s = BERT_BATCH, BERT_SEQ
    lens = seeded_lens(torch, dev, b, BERT_PAD_MIN, s, seed=61)
    lens[0], lens[1] = s, 0
    cases = ((b, s, h, h, d, False, lens, 62),
             (4, 300, 8, 2, 64, True, torch.tensor(
                 [300, 0, 77, 200], dtype=torch.int32, device=dev), 63))
    for (b_, s_, h_, hk, d_, causal, ln, seed) in cases:
        q, k, v, do = packed_views(torch, dev, b_, s_, h_, hk, d_, seed)
        shape = {"b": b_, "s": s_, "h": h_, "h_kv": hk, "d": d_,
                 "causal": causal, "kv_lens": ln.tolist()[:8]}
        kw = dict(scale=d_ ** -0.5, causal=causal, kv_lens=ln)
        family_check(torch, "bshd", q, k, v, do, kw, shape, errs, "bshd")
        del q, k, v, do

    q, k, v, do = packed_views(torch, dev, b, s, h, h, d, 64)
    kw = dict(scale=d ** -0.5, causal=False, kv_lens=lens)
    o, lse = A.flash_fwd_bshd_cuda(q, k, v, **kw)
    plain_fwd = time_ms(lambda: A.flash_fwd_bshd(q, k, v, impl="torch", **kw),
                        [()], reps=2, trials=3)
    plain_bwd = time_ms(lambda: A.flash_bwd_bshd(q, k, v, o, lse, do,
                                                 impl="torch", **kw),
                        [()], reps=2, trials=3)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    lib_fwd, lib_bwd, _ = sdpa_times(torch, F, t(q), t(k), t(v), t(do),
                                     kw["scale"], False, lens, None)
    fab = fwd_ab_times(torch, "bshd", [(q, k, v)], kw,
                       "bshd with kv_lens (BERT)", lib_fwd)
    ms_fwd = fab["wgmma"]
    ab = ab_times(torch, "bshd", (q, k, v, o, lse, do), kw,
                  "bshd with kv_lens (BERT)", lib_bwd)
    ms_dkv, ms_dq = ab["wgmma"]["dkv_ms"], ab["wgmma"]["dq_ms"]
    live = float(lens.sum())
    bd = flash_bounds(b, h, h, s, s, d, s * h * live, h * live)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    timed = {"b": b, "s": s, "heads": h, "kv_heads": h, "head_dim": d,
             "causal": False, "dtype": "bf16", "kv_lens": "per batch, "
             "seeded in [64, 512], one full row, one of length 0",
             "layout": "views of the packed projection"}
    src = "apex_tpu_torch/csrc/"
    plain_note = ("one plain backward computes dq, dk and dv together; its "
                  "time is given for both backward kernels")
    lib_note = ("F.scaled_dot_product_attention with the key-padding mask; "
                "its autograd backward computes dq, dk and dv in one call")
    backward = {"function": "flash_bwd_bshd (dq, dk and dv)",
                "ms": ms_dkv + ms_dq, "sm80_ms": ab["sm80"]["pair_ms"],
                "bound_ms": bd["function"][0],
                "bound_by": bd["function"][1]}
    fwd_bert = {"shape": timed, "max_abs_err": errs["fwd"], "ms": ms_fwd,
                "sm80_ms": fab["sm80"], "plain_ms": plain_fwd, "bound_ms": bd["fwd"][0],
                "bound_by": bd["fwd"][1], "library_ms": lib_fwd,
                "library_note": "F.scaled_dot_product_attention forward with "
                                "the key-padding mask"}
    return fwd_bert, [
        {"name": "flash_bwd_bshd_dkv", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:1486",
         "max_abs_err": errs["dkv"], "ms": ms_dkv,
         "sm80_ms": ab["sm80"]["dkv_ms"], "plain_ms": plain_bwd,
         "bound_ms": bd["dkv"][0], "bound_by": bd["dkv"][1],
         "library_ms": lib_bwd, "plain_note": plain_note,
         "library_note": lib_note, "variant_note": VARIANT_NOTE,
         "backward": backward, "timed_shape": timed},
        {"name": "flash_bwd_bshd_dq", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "apex_tpu/ops/pallas/attention.py:1455",
         "max_abs_err": errs["dq"], "ms": ms_dq,
         "sm80_ms": ab["sm80"]["dq_ms"], "plain_ms": plain_bwd,
         "bound_ms": bd["dq"][0], "bound_by": bd["dq"][1],
         "library_ms": lib_bwd, "plain_note": plain_note,
         "library_note": lib_note, "variant_note": VARIANT_NOTE,
         "backward": backward, "timed_shape": timed},
    ]


# the array-bias calls compared and timed: T5's encoder self-attention as
# the materialized leg's unpadded steps run it (no kv_lens; the kernels
# line's times) and padded, its decoder self-attention, and the bshd
# layout with one bias row shared by every head
BIAS_CALLS = (
    ("t5_enc", "bhsd", dict(b=T5_BATCH, h=12, sq=T5_ENC, sk=T5_ENC,
                            causal=False, lens=None, hb=12)),
    ("t5_enc_padded", "bhsd", dict(b=T5_BATCH, h=12, sq=T5_ENC, sk=T5_ENC,
                                   causal=False, lens=(T5_PAD_MIN, T5_ENC),
                                   hb=12)),
    ("t5_dec", "bhsd", dict(b=T5_BATCH, h=12, sq=T5_DEC, sk=T5_DEC,
                            causal=True, lens=None, hb=12)),
    ("bshd_hb1", "bshd", dict(b=BERT_BATCH, h=16, sq=BERT_SEQ, sk=BERT_SEQ,
                              causal=False, lens=(BERT_PAD_MIN, BERT_SEQ),
                              hb=1)),
)


def phase_bias_kernels(torch, dev):
    """The array bias: the flat forward, dK/dV and dQ kernels with it and
    the dbias kernel, against their plain versions and the fp32 truth at
    T5's encoder call (b 128, 12 heads of 64, 512 x 512, fp32 bias hb 12;
    without kv_lens, as the materialized leg runs it, and with lengths in
    [256, 512]) and decoder call (114 x 114 causal), and the bshd kernels
    with a bias of one row (b 32, 16 heads of 64, 512 x 512, lengths in
    [64, 512]); each timed beside its plain version, SDPA with the bias as
    a float mask (for dbias: its backward with the mask's gradient), and
    its bound."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0, "dbias": 0.0}
    per = {}
    for i, (name, layout, c) in enumerate(BIAS_CALLS):
        b, h, sq, sk, hb, d = c["b"], c["h"], c["sq"], c["sk"], c["hb"], 64
        g = torch.Generator(device=dev).manual_seed(70 + i)
        bias = torch.randn((hb, sq, sk), generator=g, device=dev) * 0.5
        lens_b = (None if c["lens"] is None else
                  seeded_lens(torch, dev, b, *c["lens"], seed=80 + i))
        if layout == "bshd":
            q, k, v, do = packed_views(torch, dev, b, sq, h, h, d, 90 + i)
            fwd, bwd, lens = A.flash_fwd_bshd, A.flash_bwd_bshd, lens_b
            q4, k4, v4, do4 = (x.transpose(1, 2) for x in (q, k, v, do))
            fwd_kernel = A.flash_fwd_bshd_cuda
        else:
            (q, k, v, do), _, _ = t5_attn_case(
                torch, dev, "dec" if c["causal"] else "enc", b, 90 + i,
                padded=False)
            fwd, bwd = A.flash_fwd, A.flash_bwd
            lens = (None if lens_b is None else
                    lens_b[:, None].expand(b, h).reshape(-1).contiguous())
            q4, k4, v4, do4 = q, k, v, do
            fwd_kernel = A.flash_fwd_flat_cuda
        kw = dict(scale=d ** -0.5, causal=c["causal"], kv_lens=lens,
                  bias=bias)
        shape = {"call": name, "layout": layout, "b": b, "h": h, "sq": sq,
                 "sk": sk, "d": d, "hb": hb, "causal": c["causal"],
                 "kv_lens": lens is not None}
        family_check(torch, layout, q, k, v, do, kw, shape, errs,
                     "bias " + layout)

        o, lse = fwd_kernel(q, k, v, **kw)
        plain_fwd = time_ms(lambda: fwd(q, k, v, impl="torch", **kw), [()],
                            reps=2, trials=3)
        plain_bwd = time_ms(lambda: bwd(q, k, v, o, lse, do, impl="torch",
                                        **kw), [()], reps=2, trials=3)
        torch.cuda.empty_cache()
        lib_fwd, lib_bwd, lib_db = sdpa_times(
            torch, F, q4, k4, v4, do4, kw["scale"], c["causal"], lens_b,
            bias)
        fab = fwd_ab_times(torch, layout, [(q, k, v)], kw,
                           f"{layout} with the array bias, {name}", lib_fwd)
        ms_fwd = fab["wgmma"]
        # dbias on the dQ kernel's delta, as the backward dispatch runs it
        _, delta = bwd_wrappers(layout)[0](q, k, v, o, lse, do, **kw)
        dab = dbias_ab_times(torch, layout, (q, k, v, o, lse, do, bias), kw,
                             delta, f"{layout}, {name}", lib_db)
        ms_db = dab["wgmma"]
        del delta
        ab = ab_times(torch, layout, (q, k, v, o, lse, do), kw,
                      f"{layout} with the array bias, {name}", lib_bwd)
        ms_dkv, ms_dq = ab["wgmma"]["dkv_ms"], ab["wgmma"]["dq_ms"]
        if c["causal"]:
            pairs, live = b * h * sq * (sq + 1) / 2, b * h * sk
        elif lens_b is None:
            pairs, live = b * h * sq * sk, b * h * sk
        else:
            live = h * float(lens_b.double().sum())
            pairs = sq * live
        bd = flash_bounds(b, h, h, sq, sk, d, pairs, live, bias)
        per[name] = {"shape": shape, "score_pairs": pairs, "fwd_ms": ms_fwd,
                     "dkv_ms": ms_dkv, "dq_ms": ms_dq, "dbias_ms": ms_db,
                     "sm80_fwd_ms": fab["sm80"], "sm80_dbias_ms": dab["sm80"],
                     "sm80_dkv_ms": ab["sm80"]["dkv_ms"],
                     "sm80_dq_ms": ab["sm80"]["dq_ms"],
                     "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd,
                     "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                     "sdpa_bwd_with_mask_grad_ms": lib_db, "bounds": bd}
        emit("bias_kernel_times", per[name])
        del q, k, v, do, q4, k4, v4, do4, o, lse, bias
        torch.cuda.empty_cache()

    enc = per["t5_enc"]
    timed = dict(enc["shape"], dtype="bf16 operands, fp32 bias",
                 operands="(b, h, s, d) views of the projection output")
    return per, {
        "name": "flash_bwd_dbias", "route": "cuda",
        "source": "apex_tpu_torch/csrc/flash_attn_dbias.cu",
        "replaces": "apex_tpu/ops/pallas/attention.py:1095",
        "max_abs_err": errs["dbias"], "ms": enc["dbias_ms"],
        "sm80_ms": enc["sm80_dbias_ms"], "variant_note": DBIAS_VARIANT_NOTE,
        "plain_ms": enc["plain_bwd_ms"],
        "bound_ms": enc["bounds"]["dbias"][0],
        "bound_by": enc["bounds"]["dbias"][1],
        "library_ms": enc["sdpa_bwd_with_mask_grad_ms"],
        "plain_note": "one plain backward computes dq, dk, dv and dbias "
                      "together; its time is given",
        "library_note": "the autograd backward of F.scaled_dot_product_"
                        "attention with the bias as a float attn_mask that "
                        "requires grad: dq, dk, dv and the mask's gradient "
                        "per (batch, head) row, not summed over the rows "
                        "that share a bias row",
        "timed_shape": timed,
        "per_shape": {k_: {f: v_ for f, v_ in s_.items() if f != "shape"}
                      for k_, s_ in per.items()},
        "flash_max_abs_err": {k_: errs[k_] for k_ in ("fwd", "dkv", "dq")}}


def bert_flops_per_step(lens):
    """Model FLOPs of one BERT train step (forward + backward, no remat
    recompute): 6 x the matmul parameters each token passes through (per
    layer qkv and out 4H^2, the MLP 2HF; the tied MLM head VH) x b·s,
    plus 12 x H x layers x the score pairs the lengths keep (every query
    row against its sequence's live keys)."""
    H, Fh, V = BERT["hidden_size"], BERT["ffn_hidden_size"], BERT["vocab_size"]
    L = BERT["num_layers"]
    tokens = BERT_BATCH * BERT_SEQ
    pairs = BERT_SEQ * float(lens.double().sum())
    return 6 * (L * (4 * H * H + 2 * H * Fh) + V * H) * tokens \
        + 12 * H * L * pairs


def bert_batch(torch, dev, seed):
    """A padded MLM batch: seeded tokens and targets, lengths uniform in
    [64, 512] (suffix padding), token types A then B split at a seeded
    point inside each sequence (padding type 0), and 15% of the valid
    positions in the loss mask. Returns (tokens, targets, loss_mask,
    token_types, pad_mask) and the lengths."""
    b, s, V = BERT_BATCH, BERT_SEQ, BERT["vocab_size"]
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, V, (b, s), generator=g, device=dev)
    targets = torch.randint(0, V, (b, s), generator=g, device=dev)
    lens = torch.randint(BERT_PAD_MIN, s + 1, (b,), generator=g, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    valid = pos < lens[:, None]
    split = 1 + (torch.rand((b, 1), generator=g, device=dev)
                 * (lens[:, None] - 1)).long()
    types = ((pos >= split) & valid).long()
    loss_mask = ((torch.rand((b, s), generator=g, device=dev)
                  < BERT_MASK_RATE) & valid).float()
    return (tokens, targets, loss_mask, types, ~valid), lens


def bert_model(torch, dev, dtype, cfg=None):
    from apex_tpu_torch.models.bert import BertConfig, BertModel, param_leaves

    model = BertModel(BertConfig(**(cfg or BERT), dtype=dtype))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    for t in param_leaves(params):
        t.requires_grad_()
    return model, params


def bert_ln_counts():
    """(ln_fwd, ln_bwd) per BERT step with per-block remat: the embedding
    norm once, 2 norms per block run again by the recompute."""
    L = BERT["num_layers"]
    return {"ln_fwd": 4 * L + 1, "ln_bwd": 2 * L + 1}


def bert_step(model, params, opt, batch):
    loss = model.mlm_loss(params, *batch)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def path_counters():
    """Every flash, xent_stats, layer-norm, softmax, matmul and dropout
    counter, by name (the flash kernels' also by variant: ``<name>_wgmma``,
    ``<name>_sm80``, and with dropout, ``<name>_dropout``; the dropout
    kernel's forward and backward launches, ``dropout_fwd`` and
    ``dropout_bwd``; the packed flash trio's, ``ln_fwd``'s, ``ln_bwd``'s and
    ``xent_stats``'s launches on their fp16 instances, ``<name>_f16``):
    the kernels a path must launch and those it must not."""
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import dropout as D
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import matmul as MM
    from apex_tpu_torch.ops import softmax as S
    from apex_tpu_torch.ops import xentropy as X

    flash = (("flash_fwd", A.flash_fwd_cuda),
             ("flash_fwd_bshd", A.flash_fwd_bshd_cuda),
             ("flash_fwd_flat", A.flash_fwd_flat_cuda),
             ("flash_bwd_dkv", A.flash_bwd_dkv_cuda),
             ("flash_bwd_dq", A.flash_bwd_dq_cuda),
             ("flash_bwd_bshd_dkv", A.flash_bwd_bshd_dkv_cuda),
             ("flash_bwd_bshd_dq", A.flash_bwd_bshd_dq_cuda),
             ("flash_bwd_flat_dkv", A.flash_bwd_flat_dkv_cuda),
             ("flash_bwd_flat_dq", A.flash_bwd_flat_dq_cuda))
    return {"flash_fwd": (A.flash_fwd_cuda, "launches"),
            **{f"{name}_dropout": (fn, "dropout_launches")
               for name, fn in flash},
            "dropout": (D.dropout_cuda, "launches"),
            "dropout_fwd": (D.dropout_cuda, "fwd_launches"),
            "dropout_bwd": (D.dropout_cuda, "bwd_launches"),
            "flash_bwd_dkv": (A.flash_bwd_dkv_cuda, "launches"),
            "flash_bwd_dq": (A.flash_bwd_dq_cuda, "launches"),
            **{f"{name}_{v}": (fn, f"{v}_launches")
               for name, fn in (("flash_fwd", A.flash_fwd_cuda),
                                ("flash_fwd_bshd", A.flash_fwd_bshd_cuda),
                                ("flash_fwd_flat", A.flash_fwd_flat_cuda),
                                ("flash_bwd_dbias", A.flash_bwd_dbias_cuda),
                                ("flash_bwd_dkv", A.flash_bwd_dkv_cuda),
                                ("flash_bwd_dq", A.flash_bwd_dq_cuda),
                                ("flash_bwd_bshd_dkv",
                                 A.flash_bwd_bshd_dkv_cuda),
                                ("flash_bwd_bshd_dq",
                                 A.flash_bwd_bshd_dq_cuda),
                                ("flash_bwd_flat_dkv",
                                 A.flash_bwd_flat_dkv_cuda),
                                ("flash_bwd_flat_dq",
                                 A.flash_bwd_flat_dq_cuda))
               for v in ("wgmma", "sm80")},
            "flash_fwd_bshd": (A.flash_fwd_bshd_cuda, "launches"),
            "flash_fwd_bshd_bias": (A.flash_fwd_bshd_cuda, "bias_launches"),
            "flash_bwd_bshd_dkv": (A.flash_bwd_bshd_dkv_cuda, "launches"),
            "flash_bwd_bshd_dq": (A.flash_bwd_bshd_dq_cuda, "launches"),
            "flash_fwd_flat": (A.flash_fwd_flat_cuda, "launches"),
            "flash_fwd_flat_bias": (A.flash_fwd_flat_cuda, "bias_launches"),
            "flash_bwd_flat_dkv": (A.flash_bwd_flat_dkv_cuda, "launches"),
            "flash_bwd_flat_dkv_bias": (A.flash_bwd_flat_dkv_cuda,
                                        "bias_launches"),
            "flash_bwd_flat_dtable": (A.flash_bwd_flat_dkv_cuda,
                                      "table_launches"),
            "flash_bwd_flat_dq": (A.flash_bwd_flat_dq_cuda, "launches"),
            "flash_bwd_flat_dq_bias": (A.flash_bwd_flat_dq_cuda,
                                       "bias_launches"),
            "flash_bwd_dbias": (A.flash_bwd_dbias_cuda, "launches"),
            "xent_stats": (X.xent_stats_cuda, "launches"),
            "ln_fwd": (LN.ln_fwd_cuda, "launches"),
            "ln_bwd": (LN.ln_bwd_cuda, "launches"),
            # the fp16 instances (amp's strict-fp16 step)
            **{f"{name}_f16": (fn, "f16_launches") for name, fn in (
                ("flash_fwd", A.flash_fwd_cuda),
                ("flash_bwd_dq", A.flash_bwd_dq_cuda),
                ("flash_bwd_dkv", A.flash_bwd_dkv_cuda),
                ("xent_stats", X.xent_stats_cuda),
                ("ln_fwd", LN.ln_fwd_cuda), ("ln_bwd", LN.ln_bwd_cuda))},
            "softmax_fwd": (S.softmax_fwd_cuda, "launches"),
            "softmax_bwd": (S.softmax_bwd_cuda, "launches"),
            "matmul_bias_act": (MM.matmul_bias_act_cuda, "launches"),
            "matmul_bias_act_wgmma": (MM.matmul_bias_act_cuda,
                                      "wgmma_launches"),
            "matmul_bias_act_sm80": (MM.matmul_bias_act_cuda,
                                     "sm80_launches"),
            "matmul_bias_act_fp32": (MM.matmul_bias_act_cuda,
                                     "fp32_launches"),
            "matmul_bias_act_split": (MM.matmul_bias_act_cuda,
                                      "split_launches")}


def zero_counters():
    for fn, attr in path_counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {k: getattr(fn, attr) for k, (fn, attr) in path_counters().items()}


def check_launches(launches, want, steps, what):
    """Every counter equals its per-step count in ``want`` (0 if absent)
    times ``steps``."""
    for k, n in launches.items():
        check(n == want.get(k, 0) * steps,
              f"{what}: {n} {k} launches in {steps} steps, want "
              f"{want.get(k, 0)} per step")


def phase_bert_train(torch, dev):
    """The BERT slice's main path: BertModel.mlm_loss, backward and one
    FusedAdam step at BERT-large, batch 32 x 512 padded: a warm-up, then
    BERT_STEPS timed steps with the counters zeroed just before and read
    just after. Per step: 48 bshd forwards (24 layers, run again by the
    remat), 24 bshd dQ, 24 bshd dK/dV (all on the wgmma variant), one
    xent_stats, nothing else."""
    from apex_tpu_torch.models.bert import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = bert_model(torch, dev, torch.bfloat16)
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    batch, lens = bert_batch(torch, dev, seed=1)
    losses, wall, launches = timed_steps(
        torch, lambda: bert_step(model, params, opt, batch), BERT_STEPS,
        "BERT train path")
    L = BERT["num_layers"]
    check_launches(launches, {"flash_fwd_bshd": 2 * L,
                              "flash_fwd_bshd_wgmma": 2 * L,
                              "flash_bwd_bshd_dq": L,
                              "flash_bwd_bshd_dkv": L,
                              "flash_bwd_bshd_dq_wgmma": L,
                              "flash_bwd_bshd_dkv_wgmma": L, "xent_stats": 1,
                              **bert_ln_counts()},
                   BERT_STEPS, "BERT train path")
    # the interior-mask check reads the pad mask on the host: one
    # synchronising read per step, timed on its own here and seen in the
    # profile's idle share
    pad_mask = batch[4]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        model.pad_lengths(pad_mask)
    torch.cuda.synchronize()
    check_ms = (time.perf_counter() - t1) / 20 * 1e3
    tok = BERT_BATCH * BERT_SEQ * BERT_STEPS
    valid = float(lens.double().sum()) * BERT_STEPS
    flops = bert_flops_per_step(lens) * BERT_STEPS / wall
    info = {"batch": BERT_BATCH, "seq": BERT_SEQ, "steps": BERT_STEPS,
            "padding_share": 1 - valid / tok, "losses": losses,
            "wall_s": wall, "step_ms": 1e3 * wall / BERT_STEPS,
            "tokens_per_s": tok / wall, "valid_tokens_per_s": valid / wall,
            "model_flops_per_step": bert_flops_per_step(lens),
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "card": torch.cuda.get_device_name(0),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pad_mask_check_ms": check_ms,
            "launches_per_step": {k: v / BERT_STEPS
                                  for k, v in launches.items() if v}}
    return (model, params, opt, batch), info, launches


def compare_paths(torch, run, params, params32, what, bound_kernel_vs_plain,
                  view=None):
    """One step's loss and gradients at ``params``: the kernel path against
    the plain path, and both against an fp32 plain-path truth at
    ``params32`` (the same params upcast). ``run(p, impl)`` returns the
    loss. Each leaf's kernel-path error from the truth must be at most
    twice the bf16 plain path's plus 1e-3 (the flash kernels' rule lifted
    to the step), the losses within TRAIN_LOSS_TOL; where
    ``bound_kernel_vs_plain``, each leaf's kernel-vs-plain error is also
    held to TRAIN_GRAD_TOL. ``view(name, grad)`` may narrow a leaf's
    gradient; leaves without a gradient are skipped."""

    def loss_and_grads(p, impl):
        loss = run(p, impl)
        loss.backward()
        out = {}
        for name, t in named_leaves(p):
            if t.grad is not None:
                g = t.grad.float()
                out[name] = g if view is None else view(name, g)
            t.grad = None
        return loss.item(), out

    def rel(a, b):
        return {n: ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30))
                .item() for n in b}

    loss_k, g_k = loss_and_grads(params, "auto")
    loss_p, g_p = loss_and_grads(params, "torch")
    loss_t, g_t = loss_and_grads(params32, "torch")
    kp, kt, pt = rel(g_k, g_p), rel(g_k, g_t), rel(g_p, g_t)
    worst = sorted(kp.items(), key=lambda kv: -kv[1])
    rule = {n: kt[n] - (2 * pt[n] + 1e-3) for n in kt}
    worst_rule = max(rule, key=rule.get)
    info = {"params": what,
            "loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_fp32_truth": loss_t,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_norm_err_max": worst[0][1],
            "grad_worst_leaf": worst[0][0],
            "grad_tol": TRAIN_GRAD_TOL if bound_kernel_vs_plain else None,
            "table_rel_norm_err": {n: kp[n] for n in kp if "rel_bias" in n},
            "median_leaf_err": statistics.median(kp.values()),
            "vs_fp32_truth": {
                "median_kernel": statistics.median(kt.values()),
                "median_plain": statistics.median(pt.values()),
                "worst_leaf_by_rule": worst_rule,
                "worst_kernel": kt[worst_rule], "worst_plain": pt[worst_rule],
                "top_kernel_vs_plain": {n: [e, kt[n], pt[n]]
                                        for n, e in worst[:5]}}}
    check(info["loss_rel_diff"] <= TRAIN_LOSS_TOL,
          f"loss at {what}, kernel vs plain: rel diff "
          f"{info['loss_rel_diff']}")
    if bound_kernel_vs_plain:
        check(worst[0][1] <= TRAIN_GRAD_TOL,
              f"gradient {worst[0][0]} at {what}, kernel vs plain: rel "
              f"norm err {worst[0][1]} > {TRAIN_GRAD_TOL}")
    check(rule[worst_rule] <= 0,
          f"gradient {worst_rule} at {what}: kernel path {kt[worst_rule]} "
          f"from the fp32 truth, more than twice the plain path's "
          f"{pt[worst_rule]} + 1e-3")
    return info


def phase_bert_plain(torch, dev, cfg=None):
    """One BERT step at the initial params on the timed steps' batch: the
    kernel path against the plain path and both against an fp32 truth
    (compare_paths). The k window of each qkv bias is left out of its
    leaf's norm: its exact gradient is 0 (one constant added to every
    score of a row), so both paths hold only bf16 rounding noise there."""
    model, params = bert_model(torch, dev, torch.bfloat16, cfg)
    model32, params32 = bert_model(torch, dev, torch.float32, cfg)
    upcast_copy(torch, params32, params)
    batch, _ = bert_batch(torch, dev, seed=1)
    H = BERT["hidden_size"]

    def run(p, impl):
        m = model32 if p is params32 else model
        return m.mlm_loss(p, *batch, impl=impl)

    def view(name, g):
        if name.endswith("qkv.bias"):
            return torch.cat([g[:H], g[2 * H:]])
        return g

    info = compare_paths(torch, run, params, params32, "initial (seed 0)",
                         True, view)
    info["batch"] = BERT_BATCH
    return info


def t5_mat_model(torch, dev):
    from apex_tpu_torch.models.t5 import EncoderDecoderModel, T5Config

    return EncoderDecoderModel(T5Config(
        **T5, dtype=torch.bfloat16, relative_bias_impl="materialized"))


def phase_t5_materialized(torch, dev):
    """The T5 materialized leg: the T5 slice's config and batch with
    relative_bias_impl="materialized". First one step's loss and
    gradients against the bucketed path at the same (initial) params and
    batch; then a warm-up and T5_MAT_STEPS timed steps with the counters
    zeroed just before and read just after. Per step: 72 flat forwards
    (48 with the array bias: the 24 self-attention calls, each run again
    by the remat), 36 dK/dV and 36 dQ (24 of each with the bias; all on
    the wgmma variant), 24 dbias launches, no table gradient, one
    xent_stats."""
    from apex_tpu_torch.models.t5 import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    bucketed, params = t5_model(torch, dev, torch.bfloat16)
    model = t5_mat_model(torch, dev)
    enc, dec, tgt, _ = t5_batch(torch, dev, T5_BATCH, seed=1)

    def loss_and_grads(m):
        loss = m.loss_fn(params, enc, dec, tgt)
        loss.backward()
        out = {}
        for name, t in named_leaves(params):
            out[name] = t.grad.float()
            t.grad = None
        return loss.item(), out

    loss_m, g_m = loss_and_grads(model)
    loss_b, g_b = loss_and_grads(bucketed)
    rel = {n: ((g_m[n] - g_b[n]).norm() / g_b[n].norm().clamp_min(1e-30))
           .item() for n in g_b}
    worst = max(rel, key=rel.get)
    vs = {"loss_materialized": loss_m, "loss_bucketed": loss_b,
          "loss_rel_diff": abs(loss_m - loss_b) / abs(loss_b),
          "loss_tol": TRAIN_LOSS_TOL, "grad_worst_leaf": worst,
          "grad_rel_norm_err_max": rel[worst], "grad_tol": T5_MAT_GRAD_TOL,
          "median_leaf_err": statistics.median(rel.values()),
          "table_grad_rel_distance": {n: rel[n] for n in rel
                                      if "rel_bias" in n}}
    emit("t5_materialized_vs_bucketed", vs)
    check(vs["loss_rel_diff"] <= TRAIN_LOSS_TOL,
          f"T5 materialized vs bucketed: loss rel diff {vs['loss_rel_diff']}")
    check(rel[worst] <= T5_MAT_GRAD_TOL,
          f"T5 materialized vs bucketed: gradient {worst} rel norm err "
          f"{rel[worst]} > {T5_MAT_GRAD_TOL}")
    del g_m, g_b, bucketed

    opt = FusedAdam(param_leaves(params), lr=1e-4)
    losses, wall, launches = timed_steps(
        torch, lambda: t5_step(model, params, opt, enc, dec, tgt),
        T5_MAT_STEPS, "T5 materialized leg")
    L = T5["num_encoder_layers"] + 2 * T5["num_decoder_layers"]
    selfs = T5["num_encoder_layers"] + T5["num_decoder_layers"]
    check_launches(launches, {
        "flash_fwd_flat": 2 * L, "flash_fwd_flat_bias": 2 * selfs,
        "flash_fwd_flat_wgmma": 2 * L, "flash_bwd_dbias_wgmma": selfs,
        "flash_bwd_flat_dkv": L, "flash_bwd_flat_dkv_bias": selfs,
        "flash_bwd_flat_dq": L, "flash_bwd_flat_dq_bias": selfs,
        "flash_bwd_flat_dkv_wgmma": L, "flash_bwd_flat_dq_wgmma": L,
        "flash_bwd_dbias": selfs, "xent_stats": 1, **t5_ln_counts()},
        T5_MAT_STEPS, "T5 materialized leg")
    tok = T5_BATCH * (T5_ENC + T5_DEC) * T5_MAT_STEPS
    flops = t5_flops_per_step(T5_BATCH, T5_ENC, T5_DEC) * T5_MAT_STEPS / wall
    info = {"batch": T5_BATCH, "enc_len": T5_ENC, "dec_len": T5_DEC,
            "steps": T5_MAT_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / T5_MAT_STEPS, "tokens_per_s": tok / wall,
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_bucketed": vs,
            "launches_per_step": {k: v / T5_MAT_STEPS
                                  for k, v in launches.items() if v}}
    return info, launches


# --- the norm and softmax kernels and the softmax routes ----------------------

# the reference's default attention route on the train legs' configs
GPT_SOFTMAX = dict(TRAIN, attention_impl="softmax")
BERT_SOFTMAX = dict(BERT, attention_impl="softmax")
LN_EPS = 1e-5
SOFTMAX_LEG_STEPS = 5   # timed steps of the GPT and T5 softmax legs
# the main paths' layer-norm calls (rows, hidden): GPT's and BERT's train
# steps, T5's encoder and decoder (batch 128 x (512, 114)), a decode step
LN_CALLS = {"gpt": (TRAIN_BATCH * TRAIN_SEQ, 1024),
            "bert": (BERT_BATCH * BERT_SEQ, 1024),
            "t5_enc": (T5_BATCH * T5_ENC, 768),
            "t5_dec": (T5_BATCH * T5_DEC, 768),
            "decode": (DECODE_BATCH, 1024)}
# every main path's ln_fwd call (rows, hidden): the serve's decode step and
# prefill chunk, the decode leg's step and prefill, and the train legs'
LN_FWD_CALLS = {"serve": (ENGINE["num_slots"], 1024),
                "decode": (DECODE_BATCH, 1024),
                "prefill_chunk": (ENGINE["prefill_chunk"], 1024),
                "decode_prefill": (DECODE_BATCH * DECODE_PROMPT, 1024),
                "bert": (BERT_BATCH * BERT_SEQ, 1024),
                "gpt": (TRAIN_BATCH * TRAIN_SEQ, 1024),
                "t5_dec": (T5_BATCH * T5_DEC, 768),
                "t5_enc": (T5_BATCH * T5_ENC, 768)}
# the main paths' softmax calls: (b, h, sq, sk) and the mask each takes
SOFTMAX_CALLS = {"gpt_causal": ((TRAIN_BATCH, 8, TRAIN_SEQ, TRAIN_SEQ),
                                "causal"),
                 "bert_key": ((BERT_BATCH, 16, BERT_SEQ, BERT_SEQ), "key"),
                 "t5_dec_self": ((T5_BATCH, 12, T5_DEC, T5_DEC), "tril"),
                 "t5_cross": ((T5_BATCH, 12, T5_DEC, T5_ENC), "key"),
                 "t5_enc_self": ((T5_BATCH, 12, T5_ENC, T5_ENC), None)}


def ln_case(torch, dev, rows, hidden, affine, seed, copies=1):
    """``copies`` (x, dy) pairs in bf16 and bf16 (gamma, beta) per
    ``affine`` ("wb", "w" or "")."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sets = [((torch.randn((rows, hidden), generator=g, device=dev) * 2
              + 0.5).bfloat16(),
             torch.randn((rows, hidden), generator=g, device=dev).bfloat16())
            for _ in range(copies)]
    w = (1 + 0.3 * torch.randn((hidden,), generator=g, device=dev))
    b = 0.2 * torch.randn((hidden,), generator=g, device=dev)
    return (sets, w.bfloat16() if "w" in affine else None,
            b.bfloat16() if "b" in affine else None)


def ln_check(torch, dev, rows, hidden, rms, affine, seed, what):
    """ln_fwd and ln_bwd against their plain versions on one call: y and
    dx by the bf16 rule against the fp32 truth, mean and rstd within 1e-5
    of the truth's largest entry, dgamma/dbeta within one bf16 ulp (2^-7)
    of the largest; y, mean, rstd, dx, dgamma and dbeta bit-identical
    across two runs. Returns the y and dx errors."""
    from apex_tpu_torch.ops import layer_norm as LN

    sets, w, b = ln_case(torch, dev, rows, hidden, affine, seed)
    x, dy = sets[0]
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    shape = {"rows": rows, "hidden": hidden, "rms": rms, "affine": affine,
             "call": what}
    y, mean, rstd = LN.ln_fwd_cuda(x, w, b, LN_EPS, rms)
    fwd_again = LN.ln_fwd_cuda(x, w, b, LN_EPS, rms)
    dx, dw, db = LN.ln_bwd_cuda(dy, x, mean, rstd, w, rms)
    again = LN.ln_bwd_cuda(dy, x, mean, rstd, w, rms)
    yp, mp, rp = LN._torch_fwd(x, w, b, LN_EPS, rms)
    dxp, _, _ = LN._torch_bwd(dy, x, mp, rp, w, rms)
    yt, mt, rt = LN._torch_fwd(x.float(), f32(w), f32(b), LN_EPS, rms)
    dxt, dwt, dbt = LN._torch_bwd(dy.float(), x.float(), mt, rt, f32(w),
                                  rms)
    torch.cuda.synchronize()
    errs = {"y": rule_check("ln y", y, yp, yt, shape, "ln_check"),
            "dx": rule_check("ln dx", dx, dxp, dxt, shape, "ln_check")}
    for name, got, want, rel in (("mean", mean, mt, 1e-5),
                                 ("rstd", rstd, rt, 1e-5),
                                 ("dgamma", dw, dwt, 2.0 ** -7),
                                 ("dbeta", db, dbt, 2.0 ** -7)):
        if got is None:
            continue
        err = (got.float() - want).abs().max().item()
        tol = rel * want.abs().max().item()
        emit("ln_check", {"output": name, "shape": shape,
                          "max_abs_err": err, "tol": tol})
        check(err <= tol, f"ln {name}: max abs err {err} > {tol} at {shape}")
    check(all(torch.equal(a, c) for a, c in zip((dx, dw, db), again)
              if a is not None),
          f"ln_bwd not bit-reproducible at {shape}")
    check(all(torch.equal(a, c) for a, c in zip((y, mean, rstd), fwd_again)),
          f"ln_fwd not bit-reproducible at {shape}")
    return errs


def parent_turns(torch, fn, arg_sets, reps=20, trials=11, parent_fn=None):
    """``fn``'s device time (time_ms) on this tree's kernels and, with
    ``--parent``, on the parent's, in turns (parent, this, this, parent):
    (ms, parent_ms), each the mean of its two turns; parent_ms is None
    without ``--parent``. The parent's turns run ``fn`` on the parent's
    library, or ``parent_fn(library, *args)`` where the parent's entry
    points take other arguments."""
    from apex_tpu_torch.tools import rowwise_ab

    if PARENT is None:
        return time_ms(fn, arg_sets, reps, trials), None

    def parent():
        if parent_fn is not None:
            return time_ms(lambda *a: parent_fn(PARENT[0], *a), arg_sets,
                           reps, trials)
        with rowwise_ab.using(PARENT[0]):
            return time_ms(fn, arg_sets, reps, trials)

    p1 = parent()
    a = time_ms(fn, arg_sets, reps, trials)
    b = time_ms(fn, arg_sets, reps, trials)
    p2 = parent()
    return (a + b) / 2, (p1 + p2) / 2


def ptxas_of(name, args):
    """Registers and spills of kernel ``name`` instantiated with template
    ``args`` (a tuple of C++ spellings), from this run's build log: the
    demangled name where c++filt was found, else the mangled one."""
    mangled = {"__nv_bfloat16": "13__nv_bfloat16", "float": "f",
               "true": "Lb1E", "false": "Lb0E"}
    demangled = f"{name}<{', '.join(args)}>"
    parts = []
    for a in args:
        m = mangled.get(a, f"Li{a}E")
        parts.append(m)
    mangled_key = f"{name}I{''.join(parts)}E"
    for kernel, info in PTXAS.items():
        if demangled in kernel or mangled_key in kernel:
            return dict(info, kernel=demangled)
    return None


def phase_ln_kernels(torch, dev):
    """ln_fwd and ln_bwd at every main path's norm shape (LayerNorm with
    gamma and beta, as the models run it), plus RMSNorm, the affine-free
    and gamma-only forms and a tail hidden of 1000; times, the bound and
    the library's F.layer_norm: the forward at GPT's train step (20480 x
    1024, bf16), the backward at every train path's call (``per_shape``:
    GPT, BERT, T5's encoder and decoder), with the parent's kernel in turns
    under ``--parent`` and the row kernel's launch shape, registers and
    spills."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as LN

    errs = {"y": 0.0, "dx": 0.0}
    cases = [(rows, hidden, False, "wb", what)
             for what, (rows, hidden) in LN_CALLS.items()]
    cases += [(20480, 1024, True, "w", "rms"), (4096, 1024, False, "",
                                                 "no affine"),
              (4096, 1024, True, "", "rms, no affine"),
              (4096, 1024, False, "w", "gamma only"),
              (3000, 1000, False, "wb", "tail hidden")]
    for i, (rows, hidden, rms, affine, what) in enumerate(cases):
        e = ln_check(torch, dev, rows, hidden, rms, affine, 40 + i, what)
        errs = {k: max(errs[k], e[k]) for k in errs}
    torch.cuda.empty_cache()

    def lib_graphs(sets, w, b, hidden):
        graphs = []
        for x, dy in sets:
            leaves = [t.detach().requires_grad_() for t in (x, w, b)]
            graphs.append((F.layer_norm(leaves[0], (hidden,), leaves[1],
                                        leaves[2], LN_EPS), leaves, dy))
        return graphs

    per_shape = {}
    for what in ("gpt", "bert", "t5_enc", "t5_dec"):
        rows, hidden = LN_CALLS[what]
        # 3 copies of x and dy (42 MB each at GPT's call) cycle through the
        # 50 MB L2
        sets, w, b = ln_case(torch, dev, rows, hidden, "wb", 7, copies=3)
        stats = [LN.ln_fwd_cuda(x, w, b, LN_EPS, False) for x, _ in sets]
        bwd_sets = [(dy, x, m, r) for (x, dy), (_, m, r)
                    in zip(sets, stats)]
        ms, parent_ms = parent_turns(
            torch, lambda dy, x, m, r: LN.ln_bwd_cuda(dy, x, m, r, w, False),
            bwd_sets)
        plain = time_ms(lambda dy, x, m, r: LN._torch_bwd(dy, x, m, r, w,
                                                          False),
                        bwd_sets, reps=6, trials=5)
        graphs = lib_graphs(sets, w, b, hidden)
        lib = time_ms(lambda out, leaves, dy: torch.autograd.grad(
            out, leaves, dy, retain_graph=True), graphs)
        # bytes: dy and x read once, dx written once, the stats, gamma
        # read and dgamma/dbeta written; ~12 fp32 operations an element
        n = rows * hidden
        bwd = bound(6 * n + 8 * rows + 2 * hidden + 2 * 2 * hidden, 12 * n,
                    FP32_OPS_PER_S)
        c, wr, threads = LN.bwd_launch_shape(hidden, torch.bfloat16)
        per_shape[what] = {
            "rows": rows, "hidden": hidden, "ms": ms, "parent_ms": parent_ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bwd[0],
            "bound_by": bwd[1],
            "launch": {"chunks_a_thread": c, "warps_a_row": wr,
                       "threads_a_cta": threads,
                       "ctas": -(-rows // LN.bwd_rows_per_cta(rows))},
            "ptxas": ptxas_of("ln_bwd_kernel", ("__nv_bfloat16", str(c),
                                                str(wr), "true"))}
        emit("ln_bwd_times", dict(per_shape[what], call=what))
        del graphs, stats, sets, bwd_sets
        torch.cuda.empty_cache()
    fwd_shape = ln_fwd_times(torch, dev)
    fwd = fwd_shape["gpt"]
    gpt = per_shape["gpt"]
    rows, hidden = LN_CALLS["gpt"]
    timed = {"rows": rows, "hidden": hidden, "dtype": "bf16",
             "affine": "gamma and beta (bf16)"}
    src = "apex_tpu_torch/csrc/layer_norm.cu"
    return [
        {"name": "ln_fwd", "route": "cuda", "source": src,
         "replaces": "apex_tpu/ops/pallas/layer_norm.py:102",
         "max_abs_err": errs["y"], "ms": fwd["ms"],
         "parent_ms": fwd["parent_ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"], "library_note": "F.layer_norm",
         "kernel_note": "a row over the plan's warps (ln_fwd_times' plan); "
                        "parent_ms: the parent commit's kernel in turns "
                        "(--parent)",
         "timed_shape": timed, "per_shape": fwd_shape},
        {"name": "ln_bwd", "route": "cuda", "source": src,
         "replaces": "apex_tpu/ops/pallas/layer_norm.py:186",
         "max_abs_err": errs["dx"], "ms": gpt["ms"],
         "parent_ms": gpt["parent_ms"], "plain_ms": gpt["plain_ms"],
         "bound_ms": gpt["bound_ms"], "bound_by": gpt["bound_by"],
         "library_ms": gpt["library_ms"],
         "library_note": "F.layer_norm's autograd backward (dx, dgamma, "
                         "dbeta)",
         "kernel_note": "two launches a call: the row kernel and the "
                        "fixed-order dgamma/dbeta reduction; parent_ms: "
                        "the parent commit's kernel in turns (--parent)",
         "timed_shape": timed, "per_shape": per_shape}]


def ln_fwd_times(torch, dev):
    """ln_fwd (LayerNorm, bf16 x, gamma and beta) at every main path's call
    (LN_FWD_CALLS) and at one row (the fixed cost of a call), with the
    parent's kernel in turns under ``--parent``, F.layer_norm, the plain
    version and the bound beside each, the plan, registers and spills:
    one ``ln_fwd_times`` line a call; ``empty_ms``: the same launch of a
    copy of the kernel that returns at once (``rowwise_ab.empty_library``);
    ``copy_ms``: the card's copy of x into another tensor (the same bytes
    moved, no arithmetic).
    Copies of x cycle through more than the 50 MB L2 at the train calls."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops.matmul import _sm_count
    from apex_tpu_torch.tools import rowwise_ab

    out = {}
    for what, (rows, hidden) in [("one_row", (1, 1024)),
                                 *LN_FWD_CALLS.items()]:
        copies = min(12, max(3, -(-150_000_000 // (2 * rows * hidden))))
        sets, w, b = ln_case(torch, dev, rows, hidden, "wb", 9,
                             copies=copies)
        fwd_sets = [(x,) for x, _ in sets]
        del sets
        kern = lambda x: LN.ln_fwd_cuda(x, w, b, LN_EPS, False)  # noqa
        ms, parent_ms = parent_turns(torch, kern, fwd_sets)
        with rowwise_ab.using(EMPTY):
            empty_ms = time_ms(kern, fwd_sets)
        copy_ms = time_ms(lambda x, y: y.copy_(x),
                          [(x, torch.empty_like(x)) for x, in fwd_sets])
        n = rows * hidden
        bms, by = bound(4 * n + 2 * 2 * hidden + 8 * rows, 8 * n,
                        FP32_OPS_PER_S)
        plan = LN._fwd_plan(rows, hidden, torch.bfloat16,
                            _sm_count(torch.cuda.current_device()))
        out[what] = {
            "rows": rows, "hidden": hidden, "ms": ms, "parent_ms": parent_ms,
            "empty_ms": empty_ms, "copy_ms": copy_ms,
            "plain_ms": time_ms(lambda x: LN._torch_fwd(x, w, b, LN_EPS,
                                                        False),
                                fwd_sets, reps=6, trials=5),
            "library_ms": time_ms(lambda x: F.layer_norm(
                x, (hidden,), w, b, LN_EPS), fwd_sets),
            "bound_ms": bms, "bound_by": by, "plan": plan._asdict(),
            "ptxas": ptxas_of("ln_fwd_kernel", ("__nv_bfloat16",
                                                str(plan.chunks), "2"))}
        emit("ln_fwd_times", dict(out[what], call=what))
        del fwd_sets
        torch.cuda.empty_cache()
    return out


def softmax_case(torch, dev, shape, mask_kind, seed):
    """bf16 scores and upstream gradient at ``shape`` (b, h, sq, sk), and
    the call's mask (True = masked): "causal" (built in the kernel: None),
    "key" (b, 1, 1, sk) key padding with lengths in [sk/4, sk] and one
    length 0 (fully masked rows), "tril" (1, 1, sq, sk), or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 4).bfloat16()
    dy = torch.randn(shape, generator=g, device=dev).bfloat16()
    b, _, sq, sk = shape
    mask = None
    if mask_kind == "key":
        lens = torch.randint(sk // 4, sk + 1, (b,), generator=g, device=dev)
        lens[1] = 0
        mask = (torch.arange(sk, device=dev)[None, :]
                >= lens[:, None])[:, None, None, :]
    elif mask_kind == "tril":
        mask = ~torch.ones((sq, sk), dtype=torch.bool,
                           device=dev).tril()[None, None]
    return x, dy, mask


def softmax_rule(got, plain, truth):
    """SOFTMAX_SLACK's rule; returns (ok, the errors and limits)."""
    t = truth.float()
    d_k, d_p = got.float() - t, plain.float() - t
    norm = t.norm().item() + 1e-30
    r = {"max_abs_err": d_k.abs().max().item(),
         "plain_bf16_err": d_p.abs().max().item(),
         "rel_norm_err": d_k.norm().item() / norm,
         "plain_rel_norm_err": d_p.norm().item() / norm}
    r["tol"] = (2 * r["plain_bf16_err"]
                + SOFTMAX_SLACK * t.abs().max().item())
    r["rel_norm_tol"] = 2 * r["plain_rel_norm_err"] + SOFTMAX_SLACK
    ok = r["max_abs_err"] <= r["tol"] and r["rel_norm_err"] <= r[
        "rel_norm_tol"]
    return ok, r


def softmax_check(torch, dev, shape, mask_kind, scale, seed, what):
    """softmax_fwd and softmax_bwd against their plain versions on one
    call, the backward told the forward's mask as the autograd core tells
    it: y and dx by SOFTMAX_SLACK's rule against the fp32 truth, with the
    planted faults refused (y: every entry 10% off; dx: 10% off, without
    - sum(dy * y), and where the call has them, the guard ignored (the
    fully masked rows' dx zeroed) and the masked entries' dy * y counted
    (on dy with NaN there)); fully masked rows uniform; dx the same bits
    across two runs and with NaN in dy at the masked entries of every row
    with a live entry (rows of at most 2048, which the warp kernel takes;
    a longer row is read whole); under ``--parent``, y the same bits as
    the parent's kernel's. Returns the y and dx errors."""
    from apex_tpu_torch.ops import softmax as S
    from apex_tpu_torch.tools import rowwise_ab

    x, dy, mask = softmax_case(torch, dev, shape, mask_kind, seed)
    causal = mask_kind == "causal"
    sk = shape[-1]
    info = {"shape": list(shape), "mask": mask_kind, "call": what}
    y = S.softmax_fwd_cuda(x, mask, scale, causal)
    yp = S._torch_fwd(x, mask, scale, causal)
    yt = S._torch_fwd(x.float(), mask, scale, causal)
    if PARENT is not None:
        with rowwise_ab.using(PARENT[0]):
            y_parent = S.softmax_fwd_cuda(x, mask, scale, causal)
        check(torch.equal(y, y_parent), f"softmax_fwd: y is not the "
              f"parent's, bit for bit, at {info}")
        del y_parent
    torch.cuda.synchronize()
    dead = (~torch.ones(shape[-2:], dtype=torch.bool, device=dev).tril()
            if causal else mask)
    dead = None if dead is None else torch.broadcast_to(dead, shape)
    full = None if dead is None else dead.all(-1)
    if full is not None and bool(full.any()):
        err = (y[full].float() - 1.0 / sk).abs().max().item()
        check(err <= 2 ** -9, f"softmax: fully masked rows not uniform "
              f"({err}) at {info}")
    del x
    kw = dict(causal=causal, mask=mask)
    dx = S.softmax_bwd_cuda(dy, yp, scale, **kw)
    again = S.softmax_bwd_cuda(dy, yp, scale, **kw)
    dxp = S._torch_bwd(dy, yp, scale)
    dxt = S._torch_bwd(dy.float(), yp.float(), scale)
    dx_faults = {"10% off": (dx.float() * 1.1).to(dx.dtype),
                 "no - sum(dy * y)": (scale * yp.float()
                                      * dy.float()).to(dx.dtype)}
    if full is not None and bool(full.any()):
        dx_faults["guard ignored"] = dx.masked_fill(full[..., None], 0)
    if dead is not None and sk <= 2048:
        dy_bad = dy.masked_fill(dead & ~full[..., None], float("nan"))
        poisoned = S.softmax_bwd_cuda(dy_bad, yp, scale, **kw)
        torch.cuda.synchronize()
        check(torch.equal(poisoned, dx), f"softmax_bwd: NaN in dy at "
              f"masked entries changed dx at {info}")
        dx_faults["masked dy * y counted"] = S._torch_bwd(dy_bad, yp, scale)
        del dy_bad, poisoned
    torch.cuda.synchronize()
    check(torch.equal(dx, again), f"softmax_bwd not bit-reproducible at "
          f"{info}")
    errs = {}
    for name, got, plain, truth, faults in (
            ("y", y, yp, yt, {"10% off": (y.float() * 1.1).to(y.dtype)}),
            ("dx", dx, dxp, dxt, dx_faults)):
        ok, r = softmax_rule(got, plain, truth)
        r["planted"] = {}
        for fault, bad in faults.items():
            refused, fr = softmax_rule(bad, plain, truth)
            refused = not refused
            r["planted"][fault] = {k: fr[k] for k in ("max_abs_err",
                                                      "rel_norm_err")}
            check(refused, f"softmax {name}: the rule let the planted "
                  f"fault '{fault}' through at {info}: {fr}")
        emit("softmax_check", {"output": name, "shape": info, **r})
        check(ok, f"softmax {name} kernel vs plain: {r} at {info}")
        errs[name] = r["max_abs_err"]
    return errs


def phase_softmax_kernels(torch, dev):
    """softmax_fwd and softmax_bwd at every main path's softmax call (GPT
    causal, BERT's key mask, T5's decoder triangle, cross and encoder
    calls), a tail sk of 114, fully masked rows, and a row too long for
    one warp (sk 4096); the forward's and the backward's times (the
    backward told the call's mask), bounds and library calls at every
    main-path call, with each parent kernel in turns under ``--parent``
    and each warp kernel's instance's registers and spills, and at the T5
    legs' unmasked cross call."""
    from apex_tpu_torch.ops import softmax as S

    errs = {"y": 0.0, "dx": 0.0}
    calls = dict(SOFTMAX_CALLS, long_row=((2, 4, 64, 4096), "key"))
    for i, (what, (shape, kind)) in enumerate(calls.items()):
        e = softmax_check(torch, dev, shape, kind, 0.125, 60 + i, what)
        errs = {k: max(errs[k], e[k]) for k in errs}
        torch.cuda.empty_cache()

    def times(shape, kind, with_bwd):
        x, dy, mask = softmax_case(torch, dev, shape, kind, 9)
        causal = kind == "causal"
        b, h, sq, sk = shape
        scale = 0.125
        fill = (~torch.ones((sq, sk), dtype=torch.bool, device=dev).tril()
                if causal else mask)
        out = {}
        out["fwd"], out["parent_fwd"] = parent_turns(
            torch, lambda: S.softmax_fwd_cuda(x, mask, scale, causal), [()])
        out["plain_fwd"] = time_ms(lambda: S._torch_fwd(
            x, mask, scale, causal), [()], reps=2, trials=3)
        out["lib_fwd"] = time_ms(lambda: torch.softmax(
            (x.mul(scale) if fill is None
             else x.mul(scale).masked_fill(fill, S.MASK_FILL)), -1), [()])
        if with_bwd:
            y = S.softmax_fwd_cuda(x, mask, scale, causal)
            out["bwd"], out["parent_bwd"] = parent_turns(
                torch, lambda: S.softmax_bwd_cuda(
                    dy, y, scale, causal=causal, mask=mask), [()])
            out["plain_bwd"] = time_ms(lambda: S._torch_bwd(dy, y, scale),
                                       [()], reps=2, trials=3)
            out["lib_bwd"] = time_ms(lambda: torch._softmax_backward_data(
                dy, y, -1, y.dtype), [()])
            del y
        # the entries the function must read: a masked score's y is 0
        # (its dx too) and a fully masked row's y is 1/sk whatever x
        # holds, so the forward reads x at the live entries only, the
        # backward dy and y at the live entries and the fully masked rows;
        # every output is written whole, and the mask read as stored by
        # both
        n, es = x.numel(), x.element_size()
        rows = n // sk
        mask_bytes, full = 0, 0
        if causal:
            live = b * h * sum(min(q + 1, sk) for q in range(sq))
        elif mask is None:
            live = n
        else:
            live = int((~mask).sum()) * (n // mask.numel())
            full = int(mask.all(-1).sum()) * (rows * sk // mask.numel())
            mask_bytes = mask.numel()
        live_bwd = live + full * sk
        out["live"] = {"fwd": live, "bwd": live_bwd, "entries": n}
        # ~5 fp32 operations a live entry
        out["bound_fwd"] = bound(es * (live + n) + mask_bytes, 5 * live,
                                 FP32_OPS_PER_S)
        out["bound_bwd"] = bound(es * (2 * live_bwd + n) + mask_bytes,
                                 5 * live_bwd, FP32_OPS_PER_S)
        # the warp kernels' instances, for the ptxas report, as
        # softmax.cu picks them: the forward's by_width (elements a lane,
        # rows a warp, mode); the backward's bwd_width (rows of at most 16
        # chunks four a warp), its depth (1 without a mask, else 2) and
        # whole 16-byte chunks or not (the tensors 16-byte aligned)
        chunks = -(-sk // 8)
        elems = next((e for e in (8, 16, 32, 64)
                      if -(-chunks // 32) * 8 <= e), None)
        mode = 1 if causal else 0 if mask is None else 2
        out["ptxas"] = (None if elems is None else ptxas_of(
            "softmax_fwd_kernel", ("__nv_bfloat16", str(elems),
                                   "2" if chunks <= 16 else "1",
                                   str(mode))))
        b_elems, b_rows = ((8 if chunks <= 8 else 16, 4) if chunks <= 16
                           else (elems, 1))
        out["ptxas_bwd"] = (None if b_elems is None else ptxas_of(
            "softmax_bwd_kernel", ("__nv_bfloat16", str(b_elems),
                                   str(b_rows), str(mode),
                                   "1" if mode == 0 else "2",
                                   "true" if sk * es % 16 == 0
                                   else "false")))
        del x, dy
        torch.cuda.empty_cache()
        return out

    # the backward at every call too, and at the T5 legs' cross call as
    # their timed (unpadded) steps call it, with no mask: the learned
    # leg's and the relative leg's only softmax call
    bwd_calls = dict(SOFTMAX_CALLS,
                     t5_cross_unmasked=((T5_BATCH, 12, T5_DEC, T5_ENC), None))
    calls = {what: times(shape, kind, True)
             for what, (shape, kind) in bwd_calls.items()}
    for what, c in calls.items():
        emit("softmax_fwd_times", {"call": what, **{
            k: c[k] for k in ("fwd", "parent_fwd", "plain_fwd", "lib_fwd",
                              "bound_fwd", "live", "ptxas")}})
        emit("softmax_bwd_times", {
            "call": what, "shape": list(bwd_calls[what][0]),
            "mask": bwd_calls[what][1], "ms": c["bwd"],
            "parent_ms": c["parent_bwd"],
            "plain_ms": c["plain_bwd"], "library_ms": c["lib_bwd"],
            "bound_ms": c["bound_bwd"][0], "bound_by": c["bound_bwd"][1],
            "bound_share": c["bound_bwd"][0] / c["bwd"],
            "entries_read": c["live"]["bwd"],
            "entries": c["live"]["entries"], "ptxas": c["ptxas_bwd"]})
    gpt = calls["gpt_causal"]
    src = "apex_tpu_torch/csrc/softmax.cu"
    note = ("torch.softmax after x.mul(scale).masked_fill(mask, -10000): "
            "three calls (two without a mask)")
    per_fwd = {what: {"shape": list(bwd_calls[what][0]),
                      "mask": bwd_calls[what][1],
                      "ms": c["fwd"], "parent_ms": c["parent_fwd"],
                      "plain_ms": c["plain_fwd"], "library_ms": c["lib_fwd"],
                      "bound_ms": c["bound_fwd"][0],
                      "bound_by": c["bound_fwd"][1],
                      "entries_read": c["live"]["fwd"],
                      "entries": c["live"]["entries"], "ptxas": c["ptxas"]}
               for what, c in calls.items()}
    per_bwd = {what: {"ms": c["bwd"], "parent_ms": c["parent_bwd"],
                      "plain_ms": c["plain_bwd"],
                      "library_ms": c["lib_bwd"],
                      "bound_ms": c["bound_bwd"][0],
                      "bound_by": c["bound_bwd"][1],
                      "entries_read": c["live"]["bwd"],
                      "entries": c["live"]["entries"],
                      "ptxas": c["ptxas_bwd"]}
               for what, c in calls.items()}
    timed = {"b": TRAIN_BATCH, "heads": 8, "sq": TRAIN_SEQ, "sk": TRAIN_SEQ,
             "mask": "causal", "dtype": "bf16",
             "entries": gpt["live"]["entries"]}
    bound_note = ("bytes: the inputs read at the live entries only (fwd "
                  "%d, bwd %d of the timed call's entries), every output "
                  "written whole" % (gpt["live"]["fwd"], gpt["live"]["bwd"]))
    return [
        {"name": "softmax_fwd", "route": "cuda", "source": src,
         "replaces": "apex_tpu/ops/pallas/softmax.py:83",
         "max_abs_err": errs["y"], "ms": gpt["fwd"],
         "parent_ms": gpt["parent_fwd"],
         "plain_ms": gpt["plain_fwd"], "bound_ms": gpt["bound_fwd"][0],
         "bound_by": gpt["bound_fwd"][1], "library_ms": gpt["lib_fwd"],
         "library_note": note, "timed_shape": timed,
         "kernel_note": "parent_ms: the parent commit's kernel in turns "
                        "(--parent)",
         "bound_note": bound_note, "per_shape": per_fwd},
        {"name": "softmax_bwd", "route": "cuda", "source": src,
         "replaces": "apex_tpu/ops/pallas/softmax.py:108",
         "max_abs_err": errs["dx"], "ms": gpt["bwd"],
         "parent_ms": gpt["parent_bwd"],
         "plain_ms": gpt["plain_bwd"], "bound_ms": gpt["bound_bwd"][0],
         "bound_by": gpt["bound_bwd"][1], "library_ms": gpt["lib_bwd"],
         "library_note": "torch._softmax_backward_data (no scale)",
         "kernel_note": "told the forward's mask: masked chunks not read "
                        "where the row's guard is 0; parent_ms: the "
                        "parent commit's kernel in turns (--parent)",
         "timed_shape": timed, "bound_note": bound_note,
         "per_shape": per_bwd}]


def softmax_bwd_gap(per_call, paths):
    """softmax_bwd's launches x (time - bound) at each main-path call, the
    launches from the softmax legs: GPT's at its causal call, BERT's at
    its key mask, the T5 learned leg's a third each at its encoder self,
    decoder triangle and (unpadded, unmasked) cross calls, the relative
    leg's at its cross call; with ``--parent`` the same at the parent's
    times."""
    def n(path):
        return paths.get(path, {}).get("softmax_bwd", 0)

    t5 = n("t5_softmax_train_learned") / 3
    launches = {"gpt_causal": n("gpt_softmax_train"),
                "bert_key": n("bert_softmax_train"),
                "t5_dec_self": t5, "t5_enc_self": t5,
                "t5_cross_unmasked": t5 + n("t5_softmax_train_relative")}
    out, total, parent_total = {}, 0.0, 0.0
    for call, k in launches.items():
        c = per_call[call]
        out[call] = {"launches": k, "gap_ms": k * (c["ms"] - c["bound_ms"])}
        total += out[call]["gap_ms"]
        if c["parent_ms"] is not None:
            out[call]["parent_gap_ms"] = k * (c["parent_ms"] - c["bound_ms"])
            parent_total += out[call]["parent_gap_ms"]
    return dict(out, total_gap_ms=total,
                parent_total_gap_ms=parent_total if PARENT else None)


def timed_steps(torch, step, steps, what):
    """A warm-up step, then ``steps`` timed ones with every counter zeroed
    just before and read just after; every loss finite and the last below
    the first. Returns (losses, wall s, launches)."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"{what}: losses not finite: {losses}")
    check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")
    return losses, wall, launches


def upcast_copy(torch, params32, params):
    from apex_tpu_torch.models.gpt import param_leaves

    with torch.no_grad():
        for a, c in zip(param_leaves(params32), param_leaves(params)):
            a.copy_(c.float())


def gpt_batch(torch, dev):
    """The train slice's seeded tokens and targets, (20, 1024) each."""
    g = torch.Generator(device=dev).manual_seed(1)
    V = MODEL["vocab_size"]
    return tuple(torch.randint(0, V, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                               device=dev) for _ in range(2))


def gpt_model(torch, dev, cfg, dtype):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, param_leaves

    model = GPTModel(GPTConfig(**cfg, dtype=dtype))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    for t in param_leaves(params):
        t.requires_grad_()
    return model, params


def phase_gpt_softmax(torch, dev):
    """GPT-medium's train step on the reference's default route: the
    train slice's config and batch with attention_impl="softmax". One
    step at the initial params against the plain path and an fp32 truth,
    then a warm-up and SOFTMAX_LEG_STEPS timed steps with 12/12 causal
    softmax, 25/25 norm and one xent_stats launch per step and no flash
    launch; 2 profiled steps."""
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, GPT_SOFTMAX, torch.bfloat16)
    tokens, targets = gpt_batch(torch, dev)
    model32, params32 = gpt_model(torch, dev, GPT_SOFTMAX, torch.float32)
    upcast_copy(torch, params32, params)
    H = MODEL["hidden_size"]

    def run(p, impl):
        m = model32 if p is params32 else model
        return m.loss_fn(p, tokens, targets, impl=impl)

    def view(name, gr):  # the qkv bias's k window: exact gradient 0
        return torch.cat([gr[:H], gr[2 * H:]]) if name.endswith(
            "qkv.bias") else gr

    vs = compare_paths(torch, run, params, params32, "initial (seed 0)",
                       True, view)
    del model32, params32
    torch.cuda.empty_cache()
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    losses, wall, launches = timed_steps(
        torch, lambda: train_step(model, params, opt, tokens, targets),
        SOFTMAX_LEG_STEPS, "GPT softmax leg")
    L = MODEL["num_layers"]
    check_launches(launches, {"softmax_fwd": L, "softmax_bwd": L,
                              "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1,
                              "xent_stats": 1}, SOFTMAX_LEG_STEPS,
                   "GPT softmax leg")
    tok = TRAIN_BATCH * TRAIN_SEQ * SOFTMAX_LEG_STEPS
    flops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
    info = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": SOFTMAX_LEG_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / SOFTMAX_LEG_STEPS,
            "tokens_per_s": tok / wall, "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / SOFTMAX_LEG_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(
        torch, lambda: train_step(model, params, opt, tokens, targets),
        info["step_ms"] / 1e3)
    return info, launches


def interior_batch(torch, batch):
    """The padded batch with holes punched inside every sequence: 8
    seeded positions before each row's last valid token (True = masked,
    out of the loss mask too), so no row's mask is a suffix."""
    tokens, targets, loss_mask, types, pad = batch
    g = torch.Generator(device=pad.device).manual_seed(12)
    holes = torch.randint(1, BERT_PAD_MIN - 1, (BERT_BATCH, 8), generator=g,
                          device=pad.device)
    pad = pad.clone()
    pad.scatter_(1, holes, True)
    return (tokens, targets, loss_mask * (~pad).float(), types, pad)


def phase_bert_softmax(torch, dev):
    """BERT-large's padded MLM step on the reference's default route
    (attention_impl="softmax"), as the BERT leg: one step at the initial
    params against the plain path and an fp32 truth; a warm-up and
    BERT_STEPS timed steps with 48/24 softmax (key mask), 97/49 norm and
    one xent_stats launch per step and no flash launch; one step on a
    batch whose masks have interior holes (which the flash route
    refuses): finite loss, the same launches."""
    from apex_tpu_torch.models.bert import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    vs = phase_bert_plain(torch, dev, BERT_SOFTMAX)
    torch.cuda.empty_cache()
    model, params = bert_model(torch, dev, torch.bfloat16, BERT_SOFTMAX)
    batch, lens = bert_batch(torch, dev, seed=1)
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    losses, wall, launches = timed_steps(
        torch, lambda: bert_step(model, params, opt, batch), BERT_STEPS,
        "BERT softmax leg")
    L = BERT["num_layers"]
    want = {"softmax_fwd": 2 * L, "softmax_bwd": L, "xent_stats": 1,
            **bert_ln_counts()}
    check_launches(launches, want, BERT_STEPS, "BERT softmax leg")
    tok = BERT_BATCH * BERT_SEQ * BERT_STEPS
    valid = float(lens.double().sum()) * BERT_STEPS
    flops = bert_flops_per_step(lens) * BERT_STEPS / wall
    info = {"batch": BERT_BATCH, "seq": BERT_SEQ, "steps": BERT_STEPS,
            "padding_share": 1 - valid / tok, "losses": losses,
            "wall_s": wall, "step_ms": 1e3 * wall / BERT_STEPS,
            "tokens_per_s": tok / wall, "valid_tokens_per_s": valid / wall,
            "model_flops_per_step": bert_flops_per_step(lens),
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / BERT_STEPS
                                  for k, v in launches.items() if v}}
    holed = interior_batch(torch, batch)
    check(bool((holed[4][:, :-1] & ~holed[4][:, 1:]).any(-1).all()),
          "the interior batch has a row without a hole")
    zero_counters()
    loss = float(bert_step(model, params, opt, holed))
    torch.cuda.synchronize()
    check(np.isfinite(loss), f"BERT softmax interior-mask step: {loss}")
    check_launches(read_counters(), want, 1, "BERT interior-mask step")
    info["interior_mask_step_loss"] = loss
    info["profile"] = phase_train_profile(
        torch, lambda: bert_step(model, params, opt, batch),
        info["step_ms"] / 1e3)
    return info, launches


def phase_t5_softmax(torch, dev, position_encoding):
    """T5's train step on the reference's default route
    (attention_impl="softmax"): one step at the initial params on a padded
    batch against the plain path and an fp32 truth, then a warm-up and
    SOFTMAX_LEG_STEPS timed steps at 128 x (512, 114). Per step: the
    norms (t5_ln_counts), one xent_stats and, through the fused softmax,
    learned: all 36 attention calls (72/36 with the remat), relative: the
    12 cross-attention calls (24/12; the biased self-attention calls take
    the fp32 composition); no flash launch; 2 profiled steps."""
    from apex_tpu_torch.models.t5 import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = dict(T5, attention_impl="softmax",
               position_encoding=position_encoding)
    model, params = t5_model(torch, dev, torch.bfloat16, cfg)
    vs = phase_t5_plain(torch, model, params,
                        *t5_batch(torch, dev, T5_BATCH, seed=3),
                        "initial (seed 0)", True, cfg)
    torch.cuda.empty_cache()
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    enc, dec, tgt, _ = t5_batch(torch, dev, T5_BATCH, seed=1)
    losses, wall, launches = timed_steps(
        torch, lambda: t5_step(model, params, opt, enc, dec, tgt),
        SOFTMAX_LEG_STEPS, f"T5 softmax leg ({position_encoding})")
    calls = (T5["num_decoder_layers"] if position_encoding == "relative"
             else T5["num_encoder_layers"] + 2 * T5["num_decoder_layers"])
    check_launches(launches, {"softmax_fwd": 2 * calls,
                              "softmax_bwd": calls, "xent_stats": 1,
                              **t5_ln_counts()}, SOFTMAX_LEG_STEPS,
                   f"T5 softmax leg ({position_encoding})")
    tok = T5_BATCH * (T5_ENC + T5_DEC) * SOFTMAX_LEG_STEPS
    flops = (t5_flops_per_step(T5_BATCH, T5_ENC, T5_DEC) * SOFTMAX_LEG_STEPS
             / wall)
    info = {"position_encoding": position_encoding, "batch": T5_BATCH,
            "enc_len": T5_ENC, "dec_len": T5_DEC,
            "steps": SOFTMAX_LEG_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / SOFTMAX_LEG_STEPS,
            "tokens_per_s": tok / wall, "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / SOFTMAX_LEG_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(
        torch, lambda: t5_step(model, params, opt, enc, dec, tgt),
        info["step_ms"] / 1e3)
    return info, launches


# --- the fused-dense and MLP slice: matmul_bias_act ---------------------------

# the block leg: the repo baseline's LayerNorm + dense-GELU-dense block
# (BASELINE.json line 10) at GPT-medium's widths (bench.py:2517-2524:
# hidden 1024, FFN 4096, bf16) over the train batch of 20 x 1024 tokens
BLOCK_HIDDEN, BLOCK_FFN = 1024, 4096
BLOCK_ROWS = TRAIN_BATCH * TRAIN_SEQ
BLOCK_STEPS = 10
# the MLP leg: DLRM's top MLP (Naumov et al. 2019; the MLPerf DLRM
# configuration's 479-wide interaction padded to 480), the sizes apex's
# own MLP test uses; relu, bf16, a batch of 32768 samples
MLP_SIZES = (480, 1024, 1024, 512, 256, 1)
MLP_BATCH, MLP_STEPS = 32768, 10
# the matmul kernel's bf16 rule (the scaled form, as the softmax rule's
# first half): max abs error vs the fp32 plain version <= 2x the bf16
# plain version's + MATMUL_SLACK x the truth's largest entry; wgrad
# outputs, summed over 20480-32768 rows, sit far from unit scale. Each
# call also plants two faults in the kernel's output (the last 32-deep K
# block's contribution dropped; the bias left out) and fails unless the
# rule refuses both. fp32 operands: within MATMUL_FP32_TOL of the plain
# version's largest entry (exact FFMA, sums in another order)
MATMUL_SLACK = 1e-3
MATMUL_FP32_TOL = 1e-5


def mm_operands(torch, dev, M, K, N, layout, dtype, seed, bias):
    """x (M, K) and w (K, N) as the path hands them to the kernel:
    "fwd" x contiguous and w = weight.t() (weight (N, K)); "dgrad" x = dy
    and w = weight (K, N), both contiguous; "wgrad" x = dy.t() (dy (K, M))
    and w = the layer input (K, N). x is scaled by 1/sqrt(K), so the
    pre-activations sit near unit scale (a saturated sigmoid would hide a
    fault); the bias is 0.5 N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dtype)

    xs = K ** -0.5
    if layout == "fwd":
        x, w = rnd(M, K, scale=xs), rnd(N, K).t()
    elif layout == "dgrad":
        x, w = rnd(M, K, scale=xs), rnd(K, N)
    else:
        x, w = rnd(K, M, scale=xs).t(), rnd(K, N)
    return x, w, rnd(N, scale=0.5) if bias else None


def mm_rule(got, plain, truth):
    """MATMUL_SLACK's rule; returns (ok, the errors and the limit)."""
    t = truth.float()
    r = {"max_abs_err": (got.float() - t).abs().max().item(),
         "plain_bf16_err": (plain.float() - t).abs().max().item(),
         "truth_max": t.abs().max().item()}
    r["tol"] = 2 * r["plain_bf16_err"] + MATMUL_SLACK * r["truth_max"]
    return r["max_abs_err"] <= r["tol"], r


def mm_check(torch, x, w, b, act, what):
    """The kernel against its plain version on one call, by the rule, with
    the two planted faults refused. Returns the rule's numbers."""
    from apex_tpu_torch.ops import matmul as MM

    y = MM.matmul_bias_act_cuda(x, w, b, act)
    plain = MM._torch_matmul_bias_act(x, w, b, act)
    info = {"call": what, "M": x.shape[0], "K": x.shape[1],
            "N": w.shape[1], "bias": b is not None, "activation": act,
            "dtype": str(x.dtype).replace("torch.", "")}
    if x.dtype == torch.float32:
        err = (y - plain).abs().max().item()
        tol = MATMUL_FP32_TOL * plain.abs().max().item()
        emit("matmul_check", {**info, "max_abs_err": err, "tol": tol})
        check(err <= tol, f"matmul_bias_act fp32 vs plain: {err} > {tol} "
              f"at {info}")
        return {"max_abs_err": err, "tol": tol}
    truth = MM._torch_matmul_bias_act(
        x.float(), w.float(), None if b is None else b.float(), act)
    torch.cuda.synchronize()
    ok, r = mm_rule(y, plain, truth)
    kk = (x.shape[1] - 1) // 32 * 32
    faults = {"last K block dropped": MM.matmul_bias_act_cuda(
        x[:, :kk], w[:kk], b, act)}
    if b is not None:
        faults["bias left out"] = MM.matmul_bias_act_cuda(x, w, None, act)
    r["planted"] = {}
    for fault, bad in faults.items():
        refused, fr = mm_rule(bad, plain, truth)
        refused = not refused
        r["planted"][fault] = fr["max_abs_err"]
        check(refused, f"matmul_bias_act: the rule let the planted fault "
              f"'{fault}' through at {info}: {fr}")
    # the mma.sync body, the variant for operands no tensor map takes
    y80 = MM._launch(x, w, b, act, variant="sm80")
    ok80, r80 = mm_rule(y80, plain, truth)
    r["sm80_max_abs_err"] = r80["max_abs_err"]
    emit("matmul_check", {**info, **r})
    check(ok, f"matmul_bias_act kernel vs plain: {r} at {info}")
    check(ok80, f"matmul_bias_act sm80 variant vs plain: {r80} at {info}")
    return r


def mm_calls():
    """The calls the two legs make, (M, K, N, layout, bias, activation),
    by name: the block leg's forward, dgrad and wgrad products, and each
    MLP layer's on both routes (the no-grad forward with relu in the
    epilogue, the grad route's forward without it, dX and dW)."""
    R, H, F = BLOCK_ROWS, BLOCK_HIDDEN, BLOCK_FFN
    calls = {"block_fwd_up": (R, H, F, "fwd", True, "none"),
             "block_fwd_down": (R, F, H, "fwd", True, "none"),
             "block_dgrad_dh": (R, H, F, "dgrad", False, "none"),
             "block_dgrad_dx": (R, F, H, "dgrad", False, "none"),
             "block_wgrad_dw2": (H, R, F, "wgrad", False, "none"),
             "block_wgrad_dw1": (F, R, H, "wgrad", False, "none")}
    B = MLP_BATCH
    for i, (din, dout) in enumerate(zip(MLP_SIZES[:-1], MLP_SIZES[1:])):
        calls[f"mlp{i}_fwd_relu"] = (B, din, dout, "fwd", True, "relu")
        calls[f"mlp{i}_fwd"] = (B, din, dout, "fwd", True, "none")
        calls[f"mlp{i}_dgrad"] = (B, dout, din, "dgrad", False, "none")
        calls[f"mlp{i}_wgrad"] = (dout, B, din, "wgrad", False, "none")
    return calls


def mm_bound(M, K, N, bias):
    """Each operand read once and the bf16 output written once, against
    2MNK operations at the dense bf16 peak."""
    nbytes = 2 * (M * K + K * N + M * N + (N if bias else 0))
    return bound(nbytes, 2 * M * N * K, BF16_OPS_PER_S)


def phase_matmul_kernel(torch, dev):
    """matmul_bias_act against its plain version: every epilogue of the
    forward layout (four activations, with and without the bias) at the
    block's up-projection, every call of both legs (K = 480 and N = 1
    among them), and the fp32 instantiation at a small shape; both bf16
    variants by the rule at every call, and the wgmma variant's with its
    planted faults; each leg call planned onto the wgmma variant, its
    split-K result bit-identical across two runs; each call's time, the
    sm80 variant's in turns with it (wgmma, sm80, sm80, wgmma), beside the
    bound, the plain version's, torch.addmm with the eager activation and,
    where it covers the activation, torch._addmm_activation (timed only,
    used nowhere in the port)."""
    from apex_tpu_torch.ops import matmul as MM

    sms = MM._sm_count(torch.cuda.current_device())
    calls = mm_calls()
    errs, worst = 0.0, 0.0
    seed = 70
    M, K, N, layout, _, _ = calls["block_fwd_up"]
    for act in MM.ACTIVATIONS:
        for bias in (True, False):
            seed += 1
            x, w, b = mm_operands(torch, dev, M, K, N, layout,
                                  torch.bfloat16, seed, bias)
            r = mm_check(torch, x, w, b, act, f"block_fwd_up {act} "
                         f"{'bias' if bias else 'no bias'}")
            errs, worst = max(errs, r["max_abs_err"]), max(
                worst, r["max_abs_err"] / r["tol"])
            del x, w, b
    split_calls = {}
    for what, (M, K, N, layout, bias, act) in calls.items():
        seed += 1
        x, w, b = mm_operands(torch, dev, M, K, N, layout, torch.bfloat16,
                              seed, bias)
        plan = MM._plan(x, w, b, act, sms)
        check(plan.variant == "wgmma", f"matmul_bias_act: {what} planned "
              f"onto the {plan.variant} variant")
        r = mm_check(torch, x, w, b, act, what)
        errs, worst = max(errs, r["max_abs_err"]), max(
            worst, r["max_abs_err"] / r["tol"])
        if plan.split > 1:
            y1 = MM.matmul_bias_act_cuda(x, w, b, act)
            y2 = MM.matmul_bias_act_cuda(x, w, b, act)
            same = bool(torch.equal(y1, y2))
            split_calls[what] = {"split": plan.split,
                                 "workspace_mb": 4 * M * N * plan.split / 1e6,
                                 "bit_identical": same}
            check(same, f"matmul_bias_act: split-K {what} (S {plan.split}) "
                  f"differs between two runs")
    emit("matmul_split_k", split_calls)
    torch.cuda.empty_cache()
    fp32 = {}
    for layout, act in (("fwd", "gelu"), ("dgrad", "none"),
                        ("wgrad", "none")):
        x, w, b = mm_operands(torch, dev, 300, 200, 130, layout,
                              torch.float32, 5, layout == "fwd")
        fp32[layout] = mm_check(torch, x, w, b, act, f"fp32 {layout}")

    per_call = {}
    for what, (M, K, N, layout, bias, act) in calls.items():
        x, w, b = mm_operands(torch, dev, M, K, N, layout, torch.bfloat16,
                              3, bias)
        plan = MM._plan(x, w, b, act, sms)
        new = lambda: MM.matmul_bias_act_cuda(x, w, b, act)  # noqa: E731
        old = lambda: MM._launch(x, w, b, act,  # noqa: E731
                                 variant="sm80")
        turns = [time_ms(f, [()]) for f in (new, old, old, new)]
        t = {"ms": (turns[0] + turns[3]) / 2,
             "sm80_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
             "variant": plan.variant, "split": plan.split,
             "plain_ms": time_ms(lambda: MM._torch_matmul_bias_act(
                 x, w, b, act), [()], reps=2, trials=3)}
        if b is None:
            lib = lambda: torch.mm(x, w)  # noqa: E731
        else:
            lib = lambda: MM._apply_act(torch.addmm(b, x, w),  # noqa: E731
                                        act)
        t["library_ms"] = time_ms(lib, [()])
        if b is not None and act in ("relu", "gelu"):
            t["library_fused_ms"] = time_ms(
                lambda: torch._addmm_activation(b, x, w,
                                                use_gelu=act == "gelu"),
                [()])
        bd = mm_bound(M, K, N, bias)
        t.update({"bound_ms": bd[0], "bound_by": bd[1], "M": M, "K": K,
                  "N": N, "layout": layout, "bias": bias,
                  "activation": act,
                  "tflops": 2 * M * N * K / t["ms"] / 1e9})
        per_call[what] = t
        del x, w, b
    torch.cuda.empty_cache()
    head = per_call["block_fwd_up"]
    slower = {k: v for k, v in per_call.items() if v["ms"] > v["sm80_ms"]}
    emit("matmul_ab", {"calls": len(per_call),
                       "wgmma_slower_than_sm80": slower})
    return {"name": "matmul_bias_act", "route": "cuda",
            "source": "apex_tpu_torch/csrc/matmul_bias_act.cu",
            "replaces": "apex_tpu/ops/pallas/matmul.py:100",
            "max_abs_err": errs, "max_err_over_tol": worst,
            "ms": head["ms"], "sm80_ms": head["sm80_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_note": "torch.addmm then the eager activation (torch.mm "
                            "without a bias); library_fused_ms: torch."
                            "_addmm_activation where it covers it",
            "timed_shape": {"call": "block_fwd_up", "M": head["M"],
                            "K": head["K"], "N": head["N"], "bias": True,
                            "activation": "none", "dtype": "bf16"},
            "variant_note": "ms: the wgmma variant (the path's); sm80_ms: "
                            "the mma.sync variant in turns with it",
            "split_k": split_calls, "per_call": per_call, "fp32": fp32}


def block_modules(torch, dev, dtype):
    """FusedLayerNorm(1024) and FusedDenseGeluDense(1024, 4096, 1024) with
    weights from seed 0."""
    from apex_tpu_torch.ops.fused_dense import FusedDenseGeluDense
    from apex_tpu_torch.ops.layer_norm import FusedLayerNorm

    g = torch.Generator(device=dev).manual_seed(0)
    return (FusedLayerNorm(BLOCK_HIDDEN, device=dev, dtype=dtype),
            FusedDenseGeluDense(BLOCK_HIDDEN, BLOCK_FFN, BLOCK_HIDDEN,
                                generator=g, device=dev, dtype=dtype))


def block_loss(ln, dgd, x, target):
    """The block (LayerNorm, dense-GELU-dense, residual) and an fp32 MSE."""
    out = x + dgd(ln(x))
    return (out.float() - target).pow(2).mean()


def module_params(*mods):
    return {f"m{i}": dict(m.named_parameters()) for i, m in enumerate(mods)}


def set_impl(mods, impl):
    for m in mods:
        m.impl = impl


def phase_block_leg(torch, dev):
    """The block leg: one step at the initial params against the plain
    path and an fp32 truth, a warm-up, then BLOCK_STEPS timed steps of
    forward, backward and one FusedAdam(lr=1e-4) step with the counters
    zeroed just before and read just after (6 matmul_bias_act, 1 ln_fwd,
    1 ln_bwd and nothing else per step); 2 profiled steps."""
    from apex_tpu_torch.optimizers import FusedAdam

    mods = block_modules(torch, dev, torch.bfloat16)
    mods32 = block_modules(torch, dev, torch.float32)
    params, params32 = module_params(*mods), module_params(*mods32)
    with torch.no_grad():
        for a, c in zip(named_leaves(params32), named_leaves(params)):
            a[1].copy_(c[1].float())
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (TRAIN_BATCH, TRAIN_SEQ, BLOCK_HIDDEN)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    target = torch.randn(shape, generator=g, device=dev)

    def run(p, impl):
        ms, xx = (mods32, x.float()) if p is params32 else (mods, x)
        set_impl(ms, impl)
        try:
            return block_loss(*ms, xx, target)
        finally:
            set_impl(ms, "auto")

    vs = compare_paths(torch, run, params, params32, "initial (seed 0)",
                       True)
    del mods32, params32
    torch.cuda.empty_cache()
    leaves = [t for _, t in named_leaves(params)]
    opt = FusedAdam(leaves, lr=1e-4)

    def step():
        loss = block_loss(*mods, x, target)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    losses, wall, launches = timed_steps(torch, step, BLOCK_STEPS,
                                         "block leg")
    check_launches(launches, {"matmul_bias_act": 6,
                              "matmul_bias_act_wgmma": 6, "ln_fwd": 1,
                              "ln_bwd": 1}, BLOCK_STEPS, "block leg")
    flops = 6 * 2 * BLOCK_ROWS * BLOCK_HIDDEN * BLOCK_FFN
    step_s = wall / BLOCK_STEPS
    info = {"tokens": BLOCK_ROWS, "hidden": BLOCK_HIDDEN, "ffn": BLOCK_FFN,
            "steps": BLOCK_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * step_s, "flops_per_step": flops,
            "tflops_per_s": flops / step_s / 1e12,
            "bound_ms": flops / BF16_OPS_PER_S * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / BLOCK_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(torch, step, step_s)
    return info, launches


def mlp_flops_per_step():
    """3 x the forward's 2 x batch x sum(din x dout): forward, dX, dW."""
    return 3 * 2 * MLP_BATCH * sum(a * b for a, b in zip(MLP_SIZES[:-1],
                                                          MLP_SIZES[1:]))


def phase_mlp_leg(torch, dev):
    """The MLP leg: a warm-up and MLP_STEPS timed train steps (MSE on
    seeded targets, FusedAdam(lr=1e-4)) with 15 matmul_bias_act launches
    and nothing else per step; one no-grad forward with 5 launches (relu in
    the epilogue); that forward and the same with activation="sigmoid"
    against the plain version and an fp32 truth by MATMUL_SLACK's rule;
    2 profiled steps."""
    from apex_tpu_torch.ops.mlp import MLP
    from apex_tpu_torch.optimizers import FusedAdam

    g = torch.Generator(device=dev).manual_seed(0)
    model = MLP(MLP_SIZES, activation="relu", generator=g, device=dev,
                dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((MLP_BATCH, MLP_SIZES[0]), generator=g,
                    device=dev).bfloat16()
    target = torch.rand((MLP_BATCH, 1), generator=g, device=dev)
    opt = FusedAdam(list(model.parameters()), lr=1e-4)

    def step():
        loss = (model(x).float() - target).pow(2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    losses, wall, launches = timed_steps(torch, step, MLP_STEPS, "MLP leg")
    n = len(MLP_SIZES) - 1
    # every launch on the wgmma variant; the n weight gradients split K
    check_launches(launches, {"matmul_bias_act": 3 * n,
                              "matmul_bias_act_wgmma": 3 * n,
                              "matmul_bias_act_split": n}, MLP_STEPS,
                   "MLP leg")
    flops = mlp_flops_per_step()
    step_s = wall / MLP_STEPS
    info = {"sizes": list(MLP_SIZES), "batch": MLP_BATCH,
            "steps": MLP_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * step_s, "flops_per_step": flops,
            "tflops_per_s": flops / step_s / 1e12,
            "bound_ms": flops / BF16_OPS_PER_S * 1e3,
            "samples_per_s": MLP_BATCH / step_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: v / MLP_STEPS
                                  for k, v in launches.items() if v}}
    model32 = MLP(MLP_SIZES, device=dev)
    with torch.no_grad():
        for a, c in zip(model32.parameters(), model.parameters()):
            a.copy_(c.float())
    fwd = {}
    for act in ("relu", "sigmoid"):
        model.activation = model32.activation = act
        with torch.no_grad():
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            y = model(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counters()
            check_launches(counts, {"matmul_bias_act": n,
                                    "matmul_bias_act_wgmma": n}, 1,
                           f"MLP no-grad forward ({act})")
            if act == "relu":
                fwd_launches = counts
            model.impl = "torch"
            plain = model(x)
            model.impl = "auto"
            truth = model32(x.float())
        ok, r = mm_rule(y, plain, truth)
        check(bool(torch.isfinite(y).all()) and y.shape == (MLP_BATCH, 1),
              f"MLP no-grad forward ({act}): bad output")
        check(ok, f"MLP no-grad forward ({act}) kernel vs plain: {r}")
        fwd[act] = {**r, "first_call_ms": ms}
    model.activation = "relu"
    info["no_grad_forward"] = fwd
    info["profile"] = phase_train_profile(torch, step, step_s)
    return info, launches, fwd_launches


# --- dropout: the flash kernels' masks, the elementwise kernel, the legs ------

# GPT-2's dropout (Radford et al. 2019, the public GPT-2 config:
# attn_pdrop = resid_pdrop = 0.1) on the train slice's configuration
DROP_RATE = 0.1
GPT_DROPOUT = dict(TRAIN, dropout=DROP_RATE)
DROPOUT_STEPS = 5        # timed steps of the gpt_dropout_train leg
REMAT_STEPS = 2          # steps of each policy of the gpt_remat_policies leg
ENCODE_ONLY_STEPS = 2    # steps of each policy of the T5 encode_only leg
# the elementwise kernel's kept share over the GPT activation must lie
# within this many binomial standard deviations of 1 - rate
KEEP_SIGMAS = 5.0
# the flash kernels' dropout faults (DROPOUT_FAULTS): the rule must refuse
# each on the GQA case, where a kv head's row differs from a q head's
FLASH_DROP_FAULTS = {"key_kv_head": ("fwd", "dq", "dkv"),
                     "swap_row_col": ("fwd", "dq", "dkv"),
                     "no_dkv_ds_mask": ("dkv",),
                     "l_from_dropped": ("fwd",)}
# each dropout kernel check's results, by case, for the kernels line
DROPOUT_CHECKS = {}


def drop_family(torch, name, fwd, bwd, ins, do, kw, seed, shape):
    """One flash family's dispatchers with dropout against their plain
    versions under the bf16 rule (rule_check), forward and backward, the
    same seed on both: o, and lse bit-identical to the dropout-free
    kernel call's; dq, dk, dv (and the bucket table's gradient, held to
    T5_DTABLE_TOL of the fp32 truth beside the plain version's error).
    ``fwd(ins, **kw)`` -> (o, lse); ``bwd(ins, o, lse, do, **kw)`` ->
    (dq, dk, dv[, table or bias gradient]). Returns the plain outputs
    (o, lse) and each output's max abs error."""
    dk = dict(kw, dropout_rate=DROP_RATE, dropout_seed=seed)
    up = [x.float() for x in ins]
    o, lse = fwd(ins, **dk)
    _, lse0 = fwd(ins, **kw)
    o_p, lse_p = fwd(ins, impl="torch", **dk)
    o_t, lse_t = fwd(up, impl="torch", **dk)
    torch.cuda.synchronize()
    tag = "dropout_check"
    errs = {"o": rule_check(f"{name} o", o, o_p, o_t, shape, tag),
            "lse": rule_check(f"{name} lse", lse, lse_p, lse_t, shape, tag)}
    same = torch.equal(lse, lse0)
    check(same, f"{name}: lse with dropout differs from the dropout-free "
          f"call's")
    del o, o_t, lse_t, lse0
    got = bwd(ins, o_p, lse_p, do, **dk)
    plain = bwd(ins, o_p, lse_p, do, impl="torch", **dk)
    truth = bwd(up, o_p.float(), lse_p, do.float(), impl="torch", **dk)
    torch.cuda.synchronize()
    for out, g, p_, t_ in zip(("dq", "dk", "dv"), got, plain, truth):
        check(torch.isfinite(g.float()).all().item(),
              f"{name} {out}: not finite")
        errs[out] = rule_check(f"{name} {out}", g, p_, t_, shape, tag)
    if len(got) > 3 and got[3] is not None:
        nrm = truth[3].norm().clamp_min(1e-30)
        e_k = ((got[3] - truth[3]).norm() / nrm).item()
        e_p = ((plain[3].float() - truth[3]).norm() / nrm).item()
        emit(tag, {"output": f"{name} dtable", "shape": shape,
                   "rel_norm_err": e_k, "plain_bf16_rel_norm_err": e_p})
        check(e_k <= 2 * e_p + T5_DTABLE_TOL,
              f"{name} table gradient: rel norm err {e_k}")
        errs["dtable_rel"] = e_k
    DROPOUT_CHECKS[name] = dict(errs, lse_bit_identical=same, seed=seed,
                                shape=shape)
    del got, plain, truth, up
    torch.cuda.empty_cache()
    return (o_p, lse_p), errs


def drop_faults(torch, qkv, do, h, h_kv, d, plain_fwd, seed):
    """Each planted dropout fault (FLASH_DROP_FAULTS) on the packed GQA
    case must fail the bf16 rule on an output it touches (or, for l from
    the dropped p, leave lse unequal to the dropout-free call's)."""
    from apex_tpu_torch.ops import attention as A

    kw = dict(scale=d ** -0.5, causal=True, dropout_rate=DROP_RATE,
              dropout_seed=seed)
    o_p, lse_p = plain_fwd
    o_t, _ = A.flash_fwd_packed(qkv.float(), h, h_kv, d, impl="torch", **kw)
    plain = A.flash_bwd_packed(qkv, o_p, lse_p, do, h, h_kv, d,
                               impl="torch", **kw)
    truth = A.flash_bwd_packed(qkv.float(), o_p.float(), lse_p, do.float(),
                               h, h_kv, d, impl="torch", **kw)
    _, lse0 = A.flash_fwd_cuda(qkv, h, h_kv, d, scale=kw["scale"],
                               causal=True)
    out = {}
    for fault, where in FLASH_DROP_FAULTS.items():
        f = lambda k: fault if k in where else None  # noqa: E731
        o, lse = A.flash_fwd_cuda(qkv, h, h_kv, d, planted_fault=f("fwd"),
                                  **kw)
        dq, delta = A.flash_bwd_dq_cuda(qkv, o_p, lse_p, do, h, h_kv, d,
                                        planted_fault=f("dq"), **kw)
        dk, dv = A.flash_bwd_dkv_cuda(qkv, o_p, lse_p, do, h, h_kv, d,
                                      delta=delta, planted_fault=f("dkv"),
                                      **kw)
        torch.cuda.synchronize()
        fails = [n for n, g, p_, t_ in (("o", o, o_p, o_t),
                                        ("dq", dq, plain[0], truth[0]),
                                        ("dk", dk, plain[1], truth[1]),
                                        ("dv", dv, plain[2], truth[2]))
                 if not rule_ok(g, p_, t_)[0]]
        if not torch.equal(lse, lse0):
            fails.append("lse")
        out[fault] = fails
        check(fails, f"planted dropout fault {fault!r} passed every rule")
    emit("dropout_faults", out)
    return out


def drop_times(torch, wrappers, ins, bwd_ins, kw, seed):
    """The wrappers' (forward, dQ, dK/dV) device times without dropout —
    beside the parent's kernels in turns under --parent (parent_turns) —
    and with dropout at DROP_RATE, on the same inputs."""
    fwd_w, dq_w, dkv_w = wrappers
    out = {}
    for rate in (0.0, DROP_RATE):
        k = dict(kw, dropout_rate=rate, dropout_seed=seed if rate else None)
        _, delta = dq_w(*bwd_ins, **k)
        calls = {"fwd": lambda k=k: fwd_w(*ins, **k),
                 "dq": lambda k=k: dq_w(*bwd_ins, **k),
                 "dkv": lambda k=k, dl=delta: dkv_w(*bwd_ins, delta=dl,
                                                    **k)}
        for name, fn in calls.items():
            if rate == 0.0:
                ms, parent = parent_turns(torch, fn, [()])
                out[name] = {"no_dropout_ms": ms, "parent_ms": parent}
            else:
                out[name]["dropout_ms"] = time_ms(fn, [()])
    for v in out.values():
        v["dropout_over_no_dropout"] = v["dropout_ms"] / v["no_dropout_ms"]
        if v["parent_ms"]:
            v["no_dropout_over_parent"] = v["no_dropout_ms"] / v["parent_ms"]
    return out


def phase_dropout_kernels(torch, dev):
    """Dropout in the flash kernels and the elementwise dropout kernel:
    each flash family at rate 0.1 against its plain version with the same
    seed (drop_family) — packed at GPT's call (20 x 1024, 8 x 128,
    causal), bshd at BERT's call with kv_lens (views of one packed
    projection, a full row and a length-0 row), bh-flat at T5's encoder
    call with the bucketed bias and kv_lens (the table gradient), a
    packed GQA 8/2 case — the planted faults refused on the GQA case;
    the elementwise kernel bit-identical to its plain version forward and
    backward in fp32 and bf16, its kept share over the GPT activation
    within KEEP_SIGMAS binomial deviations, its fp32-scale fault refused;
    times: each flash kernel with and without dropout at GPT's, BERT's
    and T5's calls (without, in turns with the parent's under --parent),
    the elementwise kernel beside its bound. Returns (the dropout kernel's
    kernels-line entry, the flash kernels' dropout times by family)."""
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import dropout as D

    packed = lambda h, h_kv, d: (  # noqa: E731
        lambda ins, **k: A.flash_fwd_packed(ins[0], h, h_kv, d, **k),
        lambda ins, o, lse, do, **k: A.flash_bwd_packed(
            ins[0], o, lse, do, h, h_kv, d, **k))
    times = {}
    for name, (b, s, h, h_kv) in (("gpt_packed", (TRAIN_BATCH, TRAIN_SEQ,
                                                  8, 8)),
                                  ("gqa_packed", (8, 1000, 8, 2))):
        d, seed = 128, -12345 if h_kv < h else 2 ** 31 - 1
        qkv, do = flash_case(torch, dev, b, s, h, h_kv, d, seed=s + h_kv)
        kw = dict(scale=d ** -0.5, causal=True)
        shape = {"b": b, "s": s, "h": h, "h_kv": h_kv, "d": d,
                 "rate": DROP_RATE}
        plain_fwd, _ = drop_family(torch, name, *packed(h, h_kv, d), (qkv,),
                                   do, kw, seed, shape)
        if h_kv < h:
            drop_faults(torch, qkv, do, h, h_kv, d, plain_fwd, seed)
        else:
            o, lse = plain_fwd
            times["gpt_packed"] = drop_times(
                torch, (A.flash_fwd_cuda, A.flash_bwd_dq_cuda,
                        A.flash_bwd_dkv_cuda), (qkv, h, h_kv, d),
                (qkv, o, lse, do, h, h_kv, d), kw, seed)
        del qkv, do, plain_fwd
        torch.cuda.empty_cache()

    # BERT's call: views of one packed projection, per-batch kv_lens
    b, s, h, d = BERT_BATCH, BERT_SEQ, BERT["num_heads"], 64
    q, k, v, do = packed_views(torch, dev, b, s, h, h, d, seed=31)
    lens = seeded_lens(torch, dev, b, BERT_PAD_MIN, s, seed=32)
    lens[0], lens[1] = s, 0
    kw = dict(scale=d ** -0.5, causal=False, kv_lens=lens)
    drop_family(torch, "bert_bshd",
                lambda ins, **k_: A.flash_fwd_bshd(*ins, **k_),
                lambda ins, o, lse, g, **k_: A.flash_bwd_bshd(*ins, o, lse, g,
                                                              **k_),
                (q, k, v), do, kw, 424242,
                {"b": b, "s": s, "h": h, "d": d, "kv_lens": "[64, 512]",
                 "rate": DROP_RATE})
    o, lse = A.flash_fwd_bshd(q, k, v, **kw)
    times["bert_bshd"] = drop_times(
        torch, (A.flash_fwd_bshd_cuda, A.flash_bwd_bshd_dq_cuda,
                A.flash_bwd_bshd_dkv_cuda), (q, k, v), (q, k, v, o, lse, do),
        kw, 424242)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    # T5's encoder call: bh-flat views, the bucketed bias, kv_lens
    ins, kw, (sq, sk, h, d) = t5_attn_case(torch, dev, "enc", T5_BATCH,
                                           seed=41, padded=True)
    q, k, v, do = ins
    drop_family(torch, "t5_enc_flat",
                lambda x, **k_: A.flash_fwd(*x, **k_),
                lambda x, o, lse, g, **k_: A.flash_bwd(*x, o, lse, g, **k_),
                (q, k, v), do, kw, -2 ** 31,
                {"b": T5_BATCH, "h": h, "sq": sq, "sk": sk, "d": d,
                 "bias": "bucketed", "kv_lens": "[256, 512]",
                 "rate": DROP_RATE})
    o, lse = A.flash_fwd(q, k, v, **kw)
    times["t5_enc_flat"] = drop_times(
        torch, (A.flash_fwd_flat_cuda, A.flash_bwd_flat_dq_cuda,
                A.flash_bwd_flat_dkv_cuda), (q, k, v), (q, k, v, o, lse, do),
        kw, -2 ** 31)
    del q, k, v, do, o, lse, ins
    torch.cuda.empty_cache()
    emit("flash_dropout_times", times)

    # the elementwise kernel
    n_rows, n = TRAIN_BATCH * TRAIN_SEQ, MODEL["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(51)
    x32 = torch.randn((n_rows, n), generator=g, device=dev)
    dy32 = torch.randn((n_rows, n), generator=g, device=dev)
    exact = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in ((n_rows, n), (7, 13), (3, 5, 96)):
            numel = int(np.prod(shape))
            x = x32.flatten()[:numel].view(shape).to(dt)
            dy = dy32.flatten()[:numel].view(shape).to(dt)
            for seed in (0, -7, 2 ** 31 - 1, -2 ** 31):
                same = (torch.equal(D.dropout_cuda(x, DROP_RATE, seed),
                                    D.dropout_plain(x, DROP_RATE, seed))
                        and torch.equal(
                            D.dropout_cuda(dy, DROP_RATE, seed,
                                           backward=True),
                            D.dropout_plain(dy, DROP_RATE, seed)))
                exact[f"{dt} {shape} seed {seed}"] = same
                check(same, f"dropout kernel differs from its plain version "
                      f"at {dt} {shape}, seed {seed}")
    xb = x32.bfloat16()
    fault = D.dropout_cuda(xb, DROP_RATE, 3, planted_fault="fp32_scale")
    refused = not torch.equal(fault, D.dropout_plain(xb, DROP_RATE, 3))
    check(refused, "the dropout kernel's fp32-scale fault matched the plain "
          "version")
    ones = torch.ones((n_rows, n), dtype=torch.bfloat16, device=dev)
    kept = (D.dropout_cuda(ones, DROP_RATE, 99) != 0).double().mean().item()
    numel = n_rows * n
    sigma = (DROP_RATE * (1 - DROP_RATE) / numel) ** 0.5
    check(abs(kept - (1 - DROP_RATE)) <= KEEP_SIGMAS * sigma,
          f"dropout kernel keeps {kept} of {numel}, more than "
          f"{KEEP_SIGMAS} sigma from {1 - DROP_RATE}")
    xs = [xb, (x32 * 0.5).bfloat16()]  # two copies: 84 MB, past the L2
    ms = time_ms(lambda a: D.dropout_cuda(a, DROP_RATE, 3), [(a,) for a in xs])
    plain_ms = time_ms(lambda a: D.dropout_plain(a, DROP_RATE, 3),
                       [(a,) for a in xs], reps=3, trials=5)
    # bytes: x read once, y written once; operations: one fp32 division an
    # element (the integer hash has no row in the peak table)
    bms, by = bound(2 * numel * 2, numel, FP32_OPS_PER_S)
    info = {"bit_identical": all(exact.values()), "cases": len(exact),
            "kept_share": kept, "kept_sigma": sigma,
            "fp32_scale_fault_refused": refused}
    emit("dropout_kernel_check", info)
    entry = {"name": "dropout", "route": "cuda",
             "source": "apex_tpu_torch/csrc/dropout.cu",
             "replaces": "apex_tpu/models/gpt.py:883 (_dropout; XLA in the "
                         "reference, no Pallas kernel)",
             "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bms, "bound_by": by, "library_ms": None,
             "library_note": "no PyTorch call computes this counter-hash "
                             "mask (F.dropout draws Philox bits)",
             "checks": info,
             "timed_shape": {"rows": n_rows, "cols": n, "dtype": "bf16",
                             "rate": DROP_RATE}}
    return entry, times


def gpt_dropout_counts(L, flash_per_step=None):
    """Per-step launches of a GPT flash-route step with dropout, no remat:
    the train path's, every flash launch with dropout, and the dropout
    kernel on the 2 residual dropouts a layer, forward and backward."""
    f = flash_per_step or L
    return {"flash_fwd": f, "flash_fwd_wgmma": f, "flash_fwd_dropout": f,
            "flash_bwd_dkv": L, "flash_bwd_dkv_wgmma": L,
            "flash_bwd_dkv_dropout": L, "flash_bwd_dq": L,
            "flash_bwd_dq_wgmma": L, "flash_bwd_dq_dropout": L,
            "xent_stats": 1, "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1,
            "dropout": 4 * L, "dropout_fwd": 2 * L, "dropout_bwd": 2 * L}


def gpt_drop_step(model, params, opt, tokens, targets, gen):
    """One train step with fresh seeds from ``gen``."""
    seeds = model.dropout_seeds(gen)
    loss = model.loss_fn(params, tokens, targets, dropout_seeds=seeds)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def phase_gpt_dropout_train(torch, dev, t_info):
    """GPT's train step at GPT-2's dropout 0.1 (the train slice's config
    with dropout=0.1, flash route, no remat): one step's loss and
    gradients, kernel path against plain path on the same seeds
    (phase_train_plain's bounds), then a warm-up and DROPOUT_STEPS timed
    steps with fresh seeds from a generator each step and the counters
    zeroed just before and read just after (gpt_dropout_counts); step
    ms, tokens/s and MFU beside the dropout-free leg's."""
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, GPT_DROPOUT, torch.bfloat16)
    tokens, targets = gpt_batch(torch, dev)
    seeds = model.dropout_seeds(torch.Generator().manual_seed(16))
    plain = phase_train_plain(torch, model, params, tokens, targets, seeds,
                              "gpt_dropout_plain_path")
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    gen = torch.Generator().manual_seed(17)
    losses, wall, launches = timed_steps(
        torch, lambda: gpt_drop_step(model, params, opt, tokens, targets,
                                     gen), DROPOUT_STEPS, "GPT dropout leg")
    L = TRAIN["num_layers"]
    check_launches(launches, gpt_dropout_counts(L), DROPOUT_STEPS,
                   "GPT dropout leg")
    tok = TRAIN_BATCH * TRAIN_SEQ * DROPOUT_STEPS
    flops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
    info = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "rate": DROP_RATE,
            "steps": DROPOUT_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * wall / DROPOUT_STEPS,
            "tokens_per_s": tok / wall, "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "dropout_free": {k: t_info[k] for k in ("step_ms",
                                                    "tokens_per_s", "mfu")},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": {k: plain[k] for k in (
                "loss_rel_diff", "grad_rel_norm_err_max", "grad_worst_leaf",
                "median_leaf_err")},
            "launches_per_step": {k: v / DROPOUT_STEPS
                                  for k, v in launches.items() if v}}
    return info, launches


def phase_gpt_remat_policies(torch, dev):
    """The dropout config with remat on, each of GPTModel's remat
    policies (full, save_attn, save_attn_mlp, mlp_only) beside remat off:
    at the initial params one step's loss and gradients on one set of
    seeds against remat off's (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL), then
    REMAT_STEPS steps with fresh seeds: step ms, peak memory and launches
    per step (dQ and dK/dV once a layer under every policy; the forward
    twice under a full-block recompute, once under mlp_only)."""
    from apex_tpu_torch.models.gpt import (REMAT_POLICIES, GPTConfig,
                                           GPTModel, param_leaves)
    from apex_tpu_torch.optimizers import FusedAdam

    model0, params = gpt_model(torch, dev, GPT_DROPOUT, torch.bfloat16)
    tokens, targets = gpt_batch(torch, dev)
    seeds = model0.dropout_seeds(torch.Generator().manual_seed(23))
    L = TRAIN["num_layers"]
    models = {"off": model0, **{p: GPTModel(GPTConfig(
        **dict(GPT_DROPOUT, remat=True, remat_policy=p),
        dtype=torch.bfloat16)) for p in REMAT_POLICIES}}

    def loss_and_grads(model):
        loss = model.loss_fn(params, tokens, targets, dropout_seeds=seeds)
        loss.backward()
        out = {}
        for name, t in named_leaves(params):
            out[name] = t.grad.float()
            t.grad = None
        return loss.item(), out

    loss0, g0 = loss_and_grads(model0)
    info = {"rate": DROP_RATE, "steps": REMAT_STEPS, "policies": {}}
    for policy in REMAT_POLICIES:  # at the initial params, before any step
        loss, g = loss_and_grads(models[policy])
        rel = {n: ((g[n] - g0[n]).norm() / g0[n].norm().clamp_min(
            1e-30)).item() for n in g0}
        worst = max(rel, key=rel.get)
        info["policies"][policy] = dict(
            loss_rel_diff=abs(loss - loss0) / abs(loss0),
            grad_rel_norm_err_max=rel[worst], grad_worst_leaf=worst)
        check(abs(loss - loss0) / abs(loss0) <= TRAIN_LOSS_TOL,
              f"remat {policy}: loss vs remat off {loss} / {loss0}")
        check(rel[worst] <= TRAIN_GRAD_TOL,
              f"remat {policy}: gradient {worst} vs remat off: rel norm "
              f"err {rel[worst]}")
        del g
    del g0
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    gen = torch.Generator().manual_seed(29)
    gpt_drop_step(model0, params, opt, tokens, targets, gen)  # opt state
    paths = {}
    for policy, model in models.items():
        entry = info["policies"].setdefault(policy, {})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        # the losses read after the steps: a read a step would stop the
        # host queueing ahead of the card
        losses = [gpt_drop_step(model, params, opt, tokens, targets, gen)
                  for _ in range(REMAT_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        launches = read_counters()
        check(all(np.isfinite(losses)), f"remat {policy}: losses {losses}")
        fwd = launches["flash_fwd"] / REMAT_STEPS
        check(launches["flash_bwd_dq"] == L * REMAT_STEPS
              and launches["flash_bwd_dkv"] == L * REMAT_STEPS
              and fwd == (L if policy in ("off", "mlp_only") else 2 * L)
              and launches["flash_fwd_dropout"] == launches["flash_fwd"]
              and launches["dropout_bwd"] == 2 * L * REMAT_STEPS,
              f"remat {policy}: launches {launches}")
        entry.update(losses=losses, step_ms=1e3 * wall / REMAT_STEPS,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                     launches_per_step={k: v / REMAT_STEPS
                                        for k, v in launches.items() if v})
        paths[f"gpt_remat_{policy}"] = launches
    return info, paths


def phase_gpt_softmax_dropout(torch, dev):
    """One dropout step on the GPT softmax leg's route (the train slice's
    config with attention_impl="softmax" and dropout 0.1): loss and
    gradients, kernel path against plain path on the same seeds
    (phase_train_plain's bounds), the kernel path's launches counted: a
    causal softmax forward and backward a layer, and the dropout kernel
    on the probabilities and the 2 residuals, forward and backward."""
    model, params = gpt_model(torch, dev, dict(GPT_SOFTMAX,
                                               dropout=DROP_RATE),
                              torch.bfloat16)
    tokens, targets = gpt_batch(torch, dev)
    seeds = model.dropout_seeds(torch.Generator().manual_seed(37))
    zero_counters()
    info = phase_train_plain(torch, model, params, tokens, targets, seeds,
                             "gpt_softmax_dropout_plain_path")
    torch.cuda.synchronize()
    launches = read_counters()
    L = TRAIN["num_layers"]
    check_launches(launches, {"softmax_fwd": L, "softmax_bwd": L,
                              "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1,
                              "xent_stats": 1, "dropout": 6 * L,
                              "dropout_fwd": 3 * L, "dropout_bwd": 3 * L},
                   1, "GPT softmax dropout step")
    return {k: info[k] for k in ("loss_kernel", "loss_plain",
                                 "loss_rel_diff", "grad_rel_norm_err_max",
                                 "grad_worst_leaf", "median_leaf_err")}, \
        launches


def phase_t5_encode_only(torch, dev):
    """T5's train step under remat_policy="encode_only" (the whole
    encoder one checkpoint, the decoder not rematted) beside "blocks", at
    T5's width and batch: at the initial params one step's loss and
    gradients against blocks' (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and each
    policy's peak memory over that step; then ENCODE_ONLY_STEPS train
    steps of each, counted: encode_only's flash forwards are the
    encoder's twice (the recompute) and the decoder's once."""
    from apex_tpu_torch.models.t5 import (EncoderDecoderModel, T5Config,
                                          param_leaves)
    from apex_tpu_torch.optimizers import FusedAdam

    model_b, params = t5_model(torch, dev, torch.bfloat16)
    model_e = EncoderDecoderModel(T5Config(**dict(
        T5, remat_policy="encode_only"), dtype=torch.bfloat16))
    enc, dec, tgt, _ = t5_batch(torch, dev, T5_BATCH, seed=1)
    out = {}
    grads = {}
    for policy, model in (("blocks", model_b), ("encode_only", model_e)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = model.loss_fn(params, enc, dec, tgt)
        loss.backward()
        torch.cuda.synchronize()
        out[policy] = {"loss": loss.item(),
                       "peak_memory_gb": torch.cuda.max_memory_allocated()
                       / 1e9,
                       "peak_over_params_gb":
                           (torch.cuda.max_memory_allocated() - base) / 1e9}
        grads[policy] = {n: t.grad.float() for n, t in named_leaves(params)}
        for t in param_leaves(params):
            t.grad = None
    rel = {n: ((grads["encode_only"][n] - grads["blocks"][n]).norm()
               / grads["blocks"][n].norm().clamp_min(1e-30)).item()
           for n in grads["blocks"]}
    worst = max(rel, key=rel.get)
    loss_rel = abs(out["encode_only"]["loss"] - out["blocks"]["loss"]) / abs(
        out["blocks"]["loss"])
    check(loss_rel <= TRAIN_LOSS_TOL, f"T5 encode_only loss vs blocks: "
          f"rel diff {loss_rel}")
    check(rel[worst] <= TRAIN_GRAD_TOL, f"T5 encode_only gradient {worst} "
          f"vs blocks: rel norm err {rel[worst]}")
    del grads
    opt = FusedAdam(param_leaves(params), lr=1e-4)
    Le, Ld = T5["num_encoder_layers"], T5["num_decoder_layers"]
    paths = {}
    for policy, model in (("blocks", model_b), ("encode_only", model_e)):
        t5_step(model, params, opt, enc, dec, tgt)  # warm-up
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        losses = [t5_step(model, params, opt, enc, dec, tgt)
                  for _ in range(ENCODE_ONLY_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        launches = read_counters()
        check(all(np.isfinite(losses)), f"T5 {policy}: losses {losses}")
        if policy == "encode_only":
            n = ENCODE_ONLY_STEPS
            want = {"flash_fwd_flat": 2 * Le + 2 * Ld,
                    "flash_bwd_flat_dkv": Le + 2 * Ld,
                    "flash_bwd_flat_dq": Le + 2 * Ld,
                    "flash_bwd_flat_dtable": Le + Ld, "xent_stats": 1}
            check(all(launches[k] == v * n for k, v in want.items()),
                  f"T5 encode_only: launches {launches}, want {want} a step")
            paths["t5_encode_only"] = launches
        out[policy].update(losses=losses,
                           step_ms=1e3 * wall / ENCODE_ONLY_STEPS,
                           launches_per_step={
                               k: v / ENCODE_ONLY_STEPS
                               for k, v in launches.items() if v})
    out.update(loss_rel_diff=loss_rel, grad_rel_norm_err_max=rel[worst],
               grad_worst_leaf=worst, batch=T5_BATCH,
               steps=ENCODE_ONLY_STEPS)
    return out, paths


# --- the amp slice: fp16 instances, the O2 and O1 fp16 legs, overflow -------

# the flagship's step (tools/fp16_and_cp_bench.py:26-87): GPT-medium, O2
# with half_dtype=float16, fp32 masters, the dynamic scaler, FusedAdam at
# lr 1e-4, batch 16 x 1024, flash, no remat; 2 warm-up and 20 timed steps
AMP_BATCH, AMP_WARMUP, AMP_STEPS, AMP_O1_STEPS = 16, 2, 20, 5
AMP_LR = 1e-4
# the overflow phase: the flagship's step from a loss scale of 2**24, at
# most this many steps, ending after 3 finite ones
AMP_OVERFLOW_STEPS, AMP_OVERFLOW_INIT = 12, 2.0 ** 24
# the fp16 rule: the truth is the plain version in fp32 on the same fp16
# inputs; the kernel's max abs error at most twice the fp16 plain
# version's + F16_SLACK x max(1, the truth's largest entry), and its error's
# norm relative to the truth's at most twice the plain version's +
# F16_SLACK. The slack is the bf16 rule's 1e-3 scaled by fp16's three more
# mantissa bits (2^-13); the norm clause is the softmax rule's. At +1e-3
# the forward with P rounded through bf16 came within 10% of passing (the
# fp16_faults line prints that fault's errors beside the limits)
F16_SLACK = 2.0 ** -13
# the overflow check: dO x 2^14 (clamped to +-6e4: the input stays finite,
# dS and the outputs' sums pass 65504); an output non-finite in the fp16
# plain version at 1 - 2^-6 of the scale must be non-finite in the
# kernel's, and the two all-finite flags agree at the scale
F16_DO_SCALE, F16_ROBUST = 2.0 ** 14, 1 - 2.0 ** -6
# the fp16 instances at GPT-medium's calls: the train leg's batch and the
# flagship's; the LN and xent calls at the flagship's 16384 tokens
F16_FLASH_CALLS = ((TRAIN_BATCH, TRAIN_SEQ), (AMP_BATCH, TRAIN_SEQ))
F16_ROWS = AMP_BATCH * TRAIN_SEQ


def f16_rule(got, plain, truth):
    """The fp16 rule without raising: (ok, details)."""
    t = truth.float()
    tn = t.norm().item() + 1e-30
    err = (got.float() - t).abs().max().item()
    err_p = (plain.float() - t).abs().max().item()
    rel = (got.float() - t).norm().item() / tn
    rel_p = (plain.float() - t).norm().item() / tn
    tol = 2 * err_p + F16_SLACK * max(1.0, t.abs().max().item())
    rel_tol = 2 * rel_p + F16_SLACK
    return err <= tol and rel <= rel_tol, {
        "max_abs_err": err, "plain_fp16_err": err_p, "tol": tol,
        "rel_norm_err": rel, "plain_rel_norm_err": rel_p,
        "rel_tol": rel_tol}


def f16_check(name, got, plain, truth, shape):
    ok, info = f16_rule(got, plain, truth)
    emit("fp16_check", dict(info, output=name, shape=shape))
    check(ok, f"fp16 {name} kernel vs plain at {shape}: {info}")
    return info["max_abs_err"]


def overflow_contained(torch, got, plain, robust):
    """(ok, details): every output non-finite in ``robust`` (the plain
    version at F16_ROBUST of the scale) is non-finite in ``got``, the
    all-finite flags of ``got`` and ``plain`` agree, and some output
    overflows."""
    from apex_tpu_torch.amp import all_finite

    lost = sum(int((~torch.isfinite(r) & torch.isfinite(g)).sum())
               for g, r in zip(got, robust))
    n_robust = sum(int((~torch.isfinite(r)).sum()) for r in robust)
    flags = (bool(all_finite(list(got))), bool(all_finite(list(plain))))
    return (lost == 0 and flags[0] == flags[1] and n_robust > 0), {
        "plain_nonfinite_robust": n_robust,
        "kernel_nonfinite": sum(int((~torch.isfinite(g)).sum())
                                for g in got),
        "robust_nonfinite_finite_in_kernel": lost,
        "all_finite_kernel_plain": flags}


def f16_turns(torch, fn16, fn_bf16, arg_sets=((),), reps=20, trials=11):
    """Device times of the fp16 and the bf16 instance at one call, in
    turns (fp16, bf16, bf16, fp16): (fp16 ms, bf16 ms)."""
    a1 = time_ms(fn16, list(arg_sets), reps, trials)
    b1 = time_ms(fn_bf16, list(arg_sets), reps, trials)
    b2 = time_ms(fn_bf16, list(arg_sets), reps, trials)
    a2 = time_ms(fn16, list(arg_sets), reps, trials)
    return (a1 + a2) / 2, (b1 + b2) / 2


def parent_ms(torch, fn):
    """The parent's time of ``fn`` in turns with this tree's (the
    parent's half of parent_turns), None without --parent."""
    return None if PARENT is None else parent_turns(torch, fn, [()])[1]


def f16_flash_outputs(A, qkv, do, h, d, kw, fault=None):
    o, lse = A.flash_fwd_cuda(qkv, h, h, d, planted_fault=fault, **kw)
    dq, delta = A.flash_bwd_dq_cuda(qkv, o, lse, do, h, h, d,
                                    planted_fault=fault, **kw)
    dk, dv = A.flash_bwd_dkv_cuda(qkv, o, lse, do, h, h, d, delta=delta,
                                  planted_fault=fault, **kw)
    return o, lse, dq, dk, dv


def f16_flash_plain(A, qkv, do, h, d, kw):
    o, lse = A.flash_fwd_packed(qkv, h, h, d, impl="torch", **kw)
    return (o, lse, *A.flash_bwd_packed(qkv, o, lse, do, h, h, d,
                                        impl="torch", **kw))


def f16_flash_overflow(torch, A, qkv, do32, h, d, kw, fault=None):
    """The backward at dO x F16_DO_SCALE: (ok, details)."""
    big = (do32.float() * F16_DO_SCALE).clamp(-6e4, 6e4).half()
    lower = (do32.float() * F16_DO_SCALE * F16_ROBUST).clamp(
        -6e4, 6e4).half()
    _, _, *got = f16_flash_outputs(A, qkv, big, h, d, kw, fault)
    po, plse = A.flash_fwd_packed(qkv, h, h, d, impl="torch", **kw)
    plain = A.flash_bwd_packed(qkv, po, plse, big, h, h, d, impl="torch",
                               **kw)
    robust = A.flash_bwd_packed(qkv, po, plse, lower, h, h, d,
                                impl="torch", **kw)
    return overflow_contained(torch, got, plain, robust)


def phase_fp16_flash(torch, dev):
    """The packed flash pair's fp16 instances at GPT-medium's calls (8
    heads of 128, causal; the train leg's 20 x 1024 and the flagship's
    16 x 1024): the fp16 rule against the fp32 truth, lse within 1e-5 of
    its largest entry, every output bit-identical across two runs, the
    overflow checks (the backward at a scaled dO; the forward with an inf
    in a q row and a k row), the planted faults refused at every call
    (bf16_p by the rule in o, dq, dk and dv; satfinite by the overflow
    check), then the times of the fp16 and the bf16 instance in turns,
    the bf16 one's beside the parent's under --parent."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    h, d = 8, 128
    kw = dict(scale=d ** -0.5, causal=True)
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    faults = {}
    for b, s in F16_FLASH_CALLS:
        shape = {"b": b, "s": s, "h": h, "d": d}
        qkv32, do32 = (t.float() for t in flash_case(torch, dev, b, s, h, h,
                                                     d, seed=s + b))
        qkv, do = qkv32.half(), do32.half()
        got = f16_flash_outputs(A, qkv, do, h, d, kw)
        again = f16_flash_outputs(A, qkv, do, h, d, kw)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"fp16 flash outputs differ across two runs at {shape}")
        plain = f16_flash_plain(A, qkv, do, h, d, kw)
        truth = f16_flash_plain(A, qkv.float(), do.float(), h, d, kw)
        del again
        for name, g, p_, t_ in zip(("o", "lse", "dq", "dk", "dv"), got,
                                   plain, truth):
            if name == "lse":
                e = (g - t_).abs().max().item()
                check(e <= 1e-5 * t_.abs().max().item(),
                      f"fp16 lse err {e} at {shape}")
                continue
            key = {"o": "fwd", "dq": "dq"}.get(name, "dkv")
            errs[key] = max(errs[key], f16_check(name, g, p_, t_, shape))
        refused = {}
        bad = f16_flash_outputs(A, qkv, do, h, d, kw, fault="bf16_p")
        rules = {n: f16_rule(bad[i], plain[i], truth[i])
                 for n, i in (("o", 0), ("dq", 2), ("dk", 3), ("dv", 4))}
        refused["bf16_p"] = {n: not r[0] for n, r in rules.items()}
        refused["bf16_p_errors"] = {n: r[1] for n, r in rules.items()}
        del bad, got, plain, truth
        ok, info = f16_flash_overflow(torch, A, qkv, do32, h, d, kw)
        emit("fp16_overflow", dict(info, shape=shape, kernel="flash bwd"))
        check(ok, f"fp16 flash backward overflow at {shape}: {info}")
        ok_sat, info_sat = f16_flash_overflow(torch, A, qkv, do32, h, d, kw,
                                              fault="satfinite")
        refused["satfinite"] = not ok_sat
        qi = qkv.clone()
        qi[0, s // 3, :d] = float("inf")            # a q row of head 0
        qi[0, s // 2, h * d:h * d + d] = float("inf")  # a k row of kv head 0
        o_i, _ = A.flash_fwd_cuda(qi, h, h, d, **kw)
        po_i, _ = A.flash_fwd_packed(qi, h, h, d, impl="torch", **kw)
        o_sat, _ = A.flash_fwd_cuda(qi, h, h, d, planted_fault="satfinite",
                                    **kw)
        same = torch.equal(~torch.isfinite(o_i), ~torch.isfinite(po_i))
        emit("fp16_overflow", {"shape": shape, "kernel": "flash fwd",
                               "inf_rows": ["q", "k"],
                               "plain_nonfinite": int(
                                   (~torch.isfinite(po_i)).sum()),
                               "same_nonfinite_outputs": same})
        check(same and (~torch.isfinite(po_i)).any(),
              f"fp16 flash forward with inf inputs at {shape}")
        refused["satfinite_fwd"] = not torch.equal(
            ~torch.isfinite(o_sat), ~torch.isfinite(po_i))
        emit("fp16_faults", {"shape": shape, "refused": refused,
                             "satfinite_overflow": info_sat})
        check(all(refused["bf16_p"].values()) and refused["satfinite"]
              and refused["satfinite_fwd"],
              f"an fp16 planted fault passed at {shape}: {refused}")
        faults[f"{b}x{s}"] = refused
        del qi, o_i, po_i, o_sat, qkv, do
        torch.cuda.empty_cache()

    # times at both calls: the fp16 instance and the bf16 one in turns;
    # under --parent the bf16 one beside the parent's in turns
    times = {}
    for b, s in F16_FLASH_CALLS:
        q16, do16 = (t.half() for t in flash_case(torch, dev, b, s, h, h, d,
                                                  seed=3))
        qb, dob = q16.bfloat16(), do16.bfloat16()
        o16, l16 = A.flash_fwd_cuda(q16, h, h, d, **kw)
        ob, lb = A.flash_fwd_cuda(qb, h, h, d, **kw)
        _, dl16 = A.flash_bwd_dq_cuda(q16, o16, l16, do16, h, h, d, **kw)
        _, dlb = A.flash_bwd_dq_cuda(qb, ob, lb, dob, h, h, d, **kw)
        fns = {
            "fwd": (lambda: A.flash_fwd_cuda(q16, h, h, d, **kw),
                    lambda: A.flash_fwd_cuda(qb, h, h, d, **kw)),
            "dq": (lambda: A.flash_bwd_dq_cuda(q16, o16, l16, do16, h, h, d,
                                               **kw),
                   lambda: A.flash_bwd_dq_cuda(qb, ob, lb, dob, h, h, d,
                                               **kw)),
            "dkv": (lambda: A.flash_bwd_dkv_cuda(q16, o16, l16, do16, h, h,
                                                 d, delta=dl16, **kw),
                    lambda: A.flash_bwd_dkv_cuda(qb, ob, lb, dob, h, h, d,
                                                 delta=dlb, **kw))}
        call = {}
        for op, (f16, fbf) in fns.items():
            ms16, msbf = f16_turns(torch, f16, fbf)
            parent = parent_ms(torch, fbf)
            call[op] = {"f16_ms": ms16, "bf16_ms": msbf,
                        "bf16_parent_ms": parent}
        q4, k4, v4 = (x.detach() for x in A._packed_views(q16, h, h, d))
        call["sdpa_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), [()])
        # SDPA's backward to the q, k and v views (as the bf16 phase's)
        leaf = q16.detach().requires_grad_()
        lq, lk, lv = A._packed_views(leaf, h, h, d)
        out4 = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        call["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            out4, (lq, lk, lv), do16.view(b, s, h, d).transpose(1, 2),
            retain_graph=True), [()], reps=5)
        if (b, s) == (AMP_BATCH, TRAIN_SEQ):
            call["plain_fwd_ms"] = time_ms(lambda: A.flash_fwd_packed(
                q16, h, h, d, impl="torch", **kw), [()], reps=2, trials=3)
            call["plain_bwd_ms"] = time_ms(lambda: A.flash_bwd_packed(
                q16, o16, l16, do16, h, h, d, impl="torch", **kw), [()],
                reps=2, trials=3)
        pairs = b * h * s * (s + 1) / 2
        call["bounds"] = flash_bounds(b, h, h, s, s, d, pairs, b * h * s)
        times[f"{b}x{s}"] = call
        del q16, do16, qb, dob, o16, l16, ob, lb, leaf, out4
        torch.cuda.empty_cache()
    emit("fp16_flash_times", {"calls": times, "note": (
        "f16_ms and bf16_ms: the two instances at one call in turns "
        "(f16, bf16, bf16, f16); bf16_parent_ms: the parent commit's "
        "bf16 kernel in turns with this tree's (--parent)")})
    for key, call in times.items():
        for op in ("fwd", "dq", "dkv"):
            par = call[op]["bf16_parent_ms"]
            if par is not None:
                check(call[op]["bf16_ms"] <= 1.01 * par,
                      f"bf16 flash {op} at {key}: {call[op]['bf16_ms']} ms "
                      f"against the parent's {par}")
    flag = times[f"{AMP_BATCH}x{TRAIN_SEQ}"]
    src = "apex_tpu_torch/csrc/"
    out = []
    for name, op, file, line, err in (
            ("flash_fwd_f16", "fwd", "flash_attn_fwd_f16.cu", 506, "fwd"),
            ("flash_bwd_dq_f16", "dq", "flash_attn_bwd_f16.cu", 676, "dq"),
            ("flash_bwd_dkv_f16", "dkv", "flash_attn_bwd_f16.cu", 710,
             "dkv")):
        bms, by = flag["bounds"][op]
        out.append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": f"apex_tpu/ops/pallas/attention.py:{line}",
            "max_abs_err": errs[err], "ms": flag[op]["f16_ms"],
            "bf16_ms": flag[op]["bf16_ms"],
            "plain_ms": flag["plain_fwd_ms" if op == "fwd"
                             else "plain_bwd_ms"],
            "bound_ms": bms, "bound_by": by,
            "library_ms": flag["sdpa_fwd_ms" if op == "fwd"
                               else "sdpa_bwd_ms"],
            "per_shape": {k: v[op] for k, v in times.items()},
            "faults_refused": faults,
            "timed_shape": {"b": AMP_BATCH, "s": TRAIN_SEQ, "heads": h,
                            "head_dim": d, "causal": True,
                            "dtype": "fp16"}})
    return out


def phase_fp16_rows(torch, dev):
    """ln_fwd, ln_bwd and xent_stats's fp16 instances at the flagship's
    16384 x 1024 norm call and 16384 x 32768 logits: the fp16 rule for y
    and dx, mean/rstd within 1e-5 of the largest, dgamma/dbeta (fp16)
    within 2^-10 of the largest and bit-identical across two runs; the
    statistics' max and target exact, sum-exp 1e-5 relative; the overflow
    checks (an inf in a row, a scaled dy, an inf logit); the times of the
    fp16 and bf16 instances in turns, the bf16 ones beside the parent's
    under --parent."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import xentropy as X

    rows, hidden = F16_ROWS, TRAIN["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(21)
    x32 = torch.randn((rows, hidden), generator=g, device=dev) * 2 + 0.5
    dy32 = torch.randn((rows, hidden), generator=g, device=dev)
    w32 = 1 + 0.3 * torch.randn((hidden,), generator=g, device=dev)
    b32 = 0.2 * torch.randn((hidden,), generator=g, device=dev)
    x, dy, w, b = (t.half() for t in (x32, dy32, w32, b32))
    shape = {"rows": rows, "hidden": hidden, "dtype": "fp16"}
    y, mean, rstd = LN.ln_fwd_cuda(x, w, b, LN_EPS, False)
    dx, dw, db = LN.ln_bwd_cuda(dy, x, mean, rstd, w, False)
    _, dw2, db2 = LN.ln_bwd_cuda(dy, x, mean, rstd, w, False)
    yp, mp, rp = LN._torch_fwd(x, w, b, LN_EPS, False)
    yt, mt, rt = LN._torch_fwd(x.float(), w.float(), b.float(), LN_EPS,
                               False)
    dxp, _, _ = LN._torch_bwd(dy, x, mp, rp, w, False)
    dxt, dwt, dbt = LN._torch_bwd(dy.float(), x.float(), mt, rt, w.float(),
                                  False)
    ln_errs = {"y": f16_check("ln y", y, yp, yt, shape),
               "dx": f16_check("ln dx", dx, dxp, dxt, shape)}
    for name, got, t in (("mean", mean, mt), ("rstd", rstd, rt)):
        e = (got - t).abs().max().item()
        check(e <= 1e-5 * t.abs().max().item(), f"fp16 ln {name} err {e}")
    for name, got, t, again in (("dgamma", dw, dwt, dw2),
                                ("dbeta", db, dbt, db2)):
        e = (got.float() - t).abs().max().item()
        check(got.dtype == torch.float16 and torch.equal(got, again)
              and e <= 2.0 ** -10 * t.abs().max().item(),
              f"fp16 ln {name}: err {e}, dtype {got.dtype}")
        ln_errs[name] = e
    xi = x.clone()
    xi[rows // 2, hidden // 3] = float("inf")
    yi, _, _ = LN.ln_fwd_cuda(xi, w, b, LN_EPS, False)
    ypi, _, _ = LN._torch_fwd(xi, w, b, LN_EPS, False)
    check(torch.equal(~torch.isfinite(yi), ~torch.isfinite(ypi)),
          "fp16 ln forward with an inf input")
    big = (dy32 * F16_DO_SCALE).clamp(-6e4, 6e4).half()
    lower = (dy32 * F16_DO_SCALE * F16_ROBUST).clamp(-6e4, 6e4).half()
    dxb, dwb, dbb = LN.ln_bwd_cuda(big, x, mean, rstd, w, False)
    pxb, pwb, pbb = LN._torch_bwd(big, x, mp, rp, w, False)
    rxb, rwb, rbb = LN._torch_bwd(lower, x, mp, rp, w, False)
    ok, info = overflow_contained(
        torch, (dxb, dwb, dbb), (pxb, pwb.half(), pbb.half()),
        (rxb, rwb.half(), rbb.half()))
    emit("fp16_overflow", dict(info, shape=shape, kernel="ln_bwd"))
    check(ok, f"fp16 ln backward overflow: {info}")
    del xi, yi, ypi, dxb, dwb, dbb, pxb, pwb, pbb, rxb, rwb, rbb

    xb, dyb, wb, bb = (t.bfloat16() for t in (x32, dy32, w32, b32))
    _, meanb, rstdb = LN.ln_fwd_cuda(xb, wb, bb, LN_EPS, False)
    ln_t = {}
    for op, f16, fbf in (
            ("fwd", lambda: LN.ln_fwd_cuda(x, w, b, LN_EPS, False),
             lambda: LN.ln_fwd_cuda(xb, wb, bb, LN_EPS, False)),
            ("bwd", lambda: LN.ln_bwd_cuda(dy, x, mean, rstd, w, False),
             lambda: LN.ln_bwd_cuda(dyb, xb, meanb, rstdb, wb, False))):
        ms16, msbf = f16_turns(torch, f16, fbf)
        parent = parent_ms(torch, fbf)
        ln_t[op] = {"f16_ms": ms16, "bf16_ms": msbf,
                    "bf16_parent_ms": parent}
        if parent is not None:
            check(msbf <= 1.01 * parent, f"bf16 ln_{op}: {msbf} ms against "
                  f"the parent's {parent}")
    plain_fwd = time_ms(lambda: LN._torch_fwd(x, w, b, LN_EPS, False), [()],
                        reps=5, trials=5)
    plain_bwd = time_ms(lambda: LN._torch_bwd(dy, x, mean, rstd, w, False),
                        [()], reps=5, trials=5)
    lib_fwd = time_ms(lambda: F.layer_norm(x, (hidden,), w, b, LN_EPS),
                      [()])
    xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, b))
    yl = F.layer_norm(xl, (hidden,), wl, bl, LN_EPS)
    lib_bwd = time_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                                  retain_graph=True), [()])
    io = rows * hidden * 2
    fwd_b = bound(io * 2 + 2 * hidden * 2 + rows * 8, 8 * rows * hidden,
                  FP32_OPS_PER_S)
    bwd_b = bound(io * 3 + 3 * hidden * 2 + rows * 8, 12 * rows * hidden,
                  FP32_OPS_PER_S)
    del xl, wl, bl, yl
    torch.cuda.empty_cache()

    n, V = F16_ROWS, TRAIN["vocab_size"]
    logits = (torch.randn((n, V), generator=g, device=dev) * 2.0).half()
    labels = torch.randint(0, V, (n,), generator=g, device=dev)
    labels[::97] = -1
    got = X.xent_stats_cuda(logits, labels)
    want = X.xent_stats(logits, labels, impl="torch")
    errs = {k: (a - c).abs().max().item() for k, a, c in
            zip(("max", "sumexp", "target", "rowsum"), got, want)}
    rel = ((got[1] - want[1]).abs() / want[1]).max().item()
    rowsum_tol = 1e-5 * logits.float().abs().sum(-1).max().item()
    emit("fp16_xent_check", {"rows": n, "vocab": V, "abs_err": errs,
                             "sumexp_rel_err": rel})
    check(errs["max"] == 0 and errs["target"] == 0 and rel <= 1e-5
          and errs["rowsum"] <= rowsum_tol, f"fp16 xent_stats: {errs}")
    li = logits.clone()
    li[3, 7] = float("inf")
    same = all(torch.equal(~torch.isfinite(a), ~torch.isfinite(c))
               for a, c in zip(X.xent_stats_cuda(li, labels),
                               X.xent_stats(li, labels, impl="torch")))
    check(same, "fp16 xent_stats with an inf logit")
    del li
    lb = logits.bfloat16()
    ms16, msbf = f16_turns(torch, lambda: X.xent_stats_cuda(logits, labels),
                           lambda: X.xent_stats_cuda(lb, labels))
    parent = parent_ms(torch, lambda: X.xent_stats_cuda(lb, labels))
    if parent is not None:
        check(msbf <= 1.01 * parent, f"bf16 xent_stats: {msbf} ms against "
              f"the parent's {parent}")
    x_plain = time_ms(lambda: X.xent_stats(logits, labels, impl="torch"),
                      [()], reps=3, trials=5)
    x_b = bound(n * V * 2 + n * 8 + 4 * n * 4, 5 * n * V, FP32_OPS_PER_S)
    emit("fp16_row_times", {"ln": ln_t, "xent": {
        "f16_ms": ms16, "bf16_ms": msbf, "bf16_parent_ms": parent}})
    src = "apex_tpu_torch/csrc/"
    ln_shape = {"rows": rows, "hidden": hidden, "dtype": "fp16",
                "params": "fp16"}
    del logits, lb
    torch.cuda.empty_cache()
    return [
        {"name": "ln_fwd_f16", "route": "cuda",
         "source": src + "layer_norm.cu",
         "replaces": "apex_tpu/ops/pallas/layer_norm.py:102",
         "max_abs_err": ln_errs["y"], "ms": ln_t["fwd"]["f16_ms"],
         "bf16_ms": ln_t["fwd"]["bf16_ms"], "plain_ms": plain_fwd,
         "bound_ms": fwd_b[0], "bound_by": fwd_b[1], "library_ms": lib_fwd,
         "timed_shape": ln_shape},
        {"name": "ln_bwd_f16", "route": "cuda",
         "source": src + "layer_norm.cu",
         "replaces": "apex_tpu/ops/pallas/layer_norm.py:186",
         "max_abs_err": max(ln_errs["dx"], ln_errs["dgamma"],
                            ln_errs["dbeta"]),
         "ms": ln_t["bwd"]["f16_ms"], "bf16_ms": ln_t["bwd"]["bf16_ms"],
         "plain_ms": plain_bwd, "bound_ms": bwd_b[0], "bound_by": bwd_b[1],
         "library_ms": lib_bwd, "timed_shape": ln_shape},
        {"name": "xent_stats_f16", "route": "cuda",
         "source": src + "xent_stats.cu",
         "replaces": "apex_tpu/ops/pallas/xentropy.py:86",
         "max_abs_err": max(errs.values()), "ms": ms16, "bf16_ms": msbf,
         "plain_ms": x_plain, "bound_ms": x_b[0], "bound_by": x_b[1],
         "library_ms": None,
         "library_note": "no single PyTorch call computes the row max, "
                         "sum-exp, target logit and row sum",
         "timed_shape": {"rows": n, "vocab": V, "dtype": "fp16",
                         "labels": "int64"}}]


def amp_counts(L, half_ln, half_xent):
    """One GPT step's launches under amp: the flash trio on the fp16
    instances, the norms and xent_stats on fp16 (O2) or fp32 (O1)."""
    want = {"flash_fwd": L, "flash_fwd_wgmma": L, "flash_fwd_f16": L,
            "flash_bwd_dq": L, "flash_bwd_dq_wgmma": L,
            "flash_bwd_dq_f16": L, "flash_bwd_dkv": L,
            "flash_bwd_dkv_wgmma": L, "flash_bwd_dkv_f16": L,
            "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1, "xent_stats": 1}
    if half_ln:
        want.update(ln_fwd_f16=2 * L + 1, ln_bwd_f16=2 * L + 1)
    if half_xent:
        want["xent_stats_f16"] = 1
    return want


def amp_batch(torch, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    V = MODEL["vocab_size"]
    return tuple(torch.randint(0, V, (AMP_BATCH, TRAIN_SEQ), generator=g,
                               device=dev) for _ in range(2))


def amp_flagship(torch, dev, init_scale=None):
    """The flagship's pieces: the model, amp.initialize's O2 fp16 state
    over FusedAdam(lr 1e-4) (or, with ``init_scale``, the same built from
    its parts with that scale) and the batch."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, TRAIN, torch.float32)
    opt = FusedAdam(param_leaves(params), lr=AMP_LR)
    st = amp.initialize(params, opt, "O2", half_dtype=torch.float16)
    if init_scale is not None:
        st.scaler = amp.init_loss_scaler("dynamic", init_scale=init_scale,
                                         device=dev)
    return model, st, amp_batch(torch, dev)


def amp_step(amp, model, st, tokens, targets):
    """One flagship step: scaled loss and gradients, the skip-guarded Adam
    step over the masters, the resync. Returns (loss, finite), on the
    device; st.scaler advances."""
    loss, (grads, finite, st.scaler) = amp.scaled_value_and_grad(
        model.loss_fn)(st.scaler, st.params.model, tokens, targets)
    amp.apply_updates_with_master(st.params, st.optimizer, grads,
                                  grads_finite=finite)
    return loss.detach(), finite


def phase_amp_o2_fp16_train(torch, dev):
    """The flagship: GPT-medium's train step under amp O2 at fp16 (fp32
    masters, the dynamic scaler from 2**16, FusedAdam(lr 1e-4) behind the
    skip guard), batch 16 x 1024: 2 warm-up steps, then 20 timed ones with
    the counters zeroed just before and read just after (12/12/12 flash
    forward/dQ/dK-dV, 25/25 ln_fwd/ln_bwd and 1 xent_stats a step, all on
    the fp16 instances); the loss and scale trajectories, the skipped
    steps, step ms, tokens/s, MFU, peak memory. Then the bf16 train leg's
    step (bf16 params, FusedAdam) at the same batch and step counts. Each
    leg with 2 profiled steps (device time by layer, busy share)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    model, st, (tokens, targets) = amp_flagship(torch, dev)
    for _ in range(AMP_WARMUP):
        amp_step(amp, model, st, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    losses, scales, flags = [], [], []
    t0 = time.perf_counter()
    for _ in range(AMP_STEPS):
        loss, finite = amp_step(amp, model, st, tokens, targets)
        losses.append(loss)
        flags.append(finite)
        scales.append(st.scaler.loss_scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    scales = [float(v) for v in scales]
    flags = [bool(v) for v in flags]
    L = TRAIN["num_layers"]
    check_launches(launches, amp_counts(L, True, True), AMP_STEPS,
                   "amp_o2_fp16_train")
    fin = [v for v, f in zip(losses, flags) if f]
    check(all(np.isfinite(fin)) and len(fin) >= 2 and fin[-1] < fin[0],
          f"amp_o2_fp16_train: finite-step losses {losses} (flags {flags})")
    tok = AMP_BATCH * TRAIN_SEQ * AMP_STEPS
    flops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
    info = {"batch": AMP_BATCH, "seq": TRAIN_SEQ, "steps": AMP_STEPS,
            "warmup_steps": AMP_WARMUP, "lr": AMP_LR,
            "losses": losses, "loss_scales": scales, "finite": flags,
            "skipped_steps": int(st.scaler.skipped_steps),
            "wall_s": wall, "step_ms": 1e3 * wall / AMP_STEPS,
            "tokens_per_s": tok / wall,
            "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense fp16/bf16 (H100 SXM data sheet)",
            "host_syncs_per_step": 1, "peak_memory_gb": peak,
            "launches_per_step": {k: v / AMP_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(
        torch, lambda: amp_step(amp, model, st, tokens, targets),
        wall / AMP_STEPS)
    del model, st
    torch.cuda.empty_cache()

    # the bf16 train leg's step at the flagship's batch
    from apex_tpu_torch.models.gpt import param_leaves
    model, params = gpt_model(torch, dev, TRAIN, torch.bfloat16)
    opt = FusedAdam(param_leaves(params), lr=AMP_LR)
    for _ in range(AMP_WARMUP):
        train_step(model, params, opt, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bl = [train_step(model, params, opt, tokens, targets)
          for _ in range(AMP_STEPS)]
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    bflops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / bwall
    info["bf16_train_same_batch"] = {
        "losses": [float(v) for v in bl],
        "step_ms": 1e3 * bwall / AMP_STEPS, "tokens_per_s": tok / bwall,
        "mfu": bflops / BF16_OPS_PER_S,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    info["fp16_over_bf16_step"] = info["step_ms"] / (1e3 * bwall / AMP_STEPS)
    info["bf16_train_same_batch"]["profile"] = phase_train_profile(
        torch, lambda: train_step(model, params, opt, tokens, targets),
        bwall / AMP_STEPS)
    del model, params, opt
    torch.cuda.empty_cache()
    return info, launches


def phase_amp_o1_fp16_train(torch, dev):
    """The same model under ``with_policy(O1 at fp16)`` (fp32 params, the
    flash route cast to fp16): one step's loss and gradients on the kernel
    path against the plain path and an fp32 truth (the loss within
    TRAIN_LOSS_TOL, each leaf's error from the truth within twice the plain
    path's + 1e-3), then a warm-up and 5 timed
    steps (amp.initialize's O1 scaler and the skip-guarded FusedAdam) with
    12/12/12 flash launches on the fp16 instances, 25/25 norms and 1
    xent_stats on the fp32 instances a step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, TRAIN, torch.float32)
    tokens, targets = amp_batch(torch, dev)
    _, truth = gpt_model(torch, dev, TRAIN, torch.float32)  # the same seed
    pol = amp.get_policy("O1", half_dtype=torch.float16)
    c = model.config
    hd = c.num_heads * c.head_dim

    def run(p, impl):
        if p is truth:  # the fp32 truth: no cast
            return model.loss_fn(p, tokens, targets, impl=impl)
        with amp.with_policy(pol):
            return model.loss_fn(p, tokens, targets, impl=impl)

    def view(name, g):  # the qkv bias's k window: an exact 0 gradient
        if name.endswith("qkv.bias"):
            return torch.cat([g[:hd], g[hd + c.kv_heads * c.head_dim:]])
        return g

    # the O1 rule: the loss within TRAIN_LOSS_TOL of the plain path's and
    # each leaf no farther from the fp32 truth than twice the plain path's
    # + 1e-3; no kernel-vs-plain leaf bound (both paths carry fp16 noise in
    # the attention's gradients: the vs_plain_path line prints the leaves'
    # kernel-vs-plain errors)
    vs_plain = compare_paths(torch, run, params, truth,
                             "initial (seed 0), O1 fp16", False, view)
    del truth
    torch.cuda.empty_cache()
    st = amp.initialize(params, FusedAdam(param_leaves(params), lr=AMP_LR),
                        "O1", half_dtype=torch.float16)
    check(st.scaler is not None and st.policy.per_op_rules,
          "amp.initialize O1: no scaler or no per-op rules")

    def step():
        with amp.with_policy(st.policy):
            loss, (grads, finite, st.scaler) = amp.scaled_value_and_grad(
                model.loss_fn)(st.scaler, st.params, tokens, targets)
        for t, g_ in zip(param_leaves(st.params), param_leaves(grads)):
            t.grad = g_
        st.optimizer.step(grads_finite=finite)
        st.optimizer.zero_grad(set_to_none=True)
        return loss

    losses, wall, launches = timed_steps(torch, step, AMP_O1_STEPS,
                                         "amp_o1_fp16_train")
    L = c.num_layers
    check_launches(launches, amp_counts(L, False, False), AMP_O1_STEPS,
                   "amp_o1_fp16_train")
    tok = AMP_BATCH * TRAIN_SEQ * AMP_O1_STEPS
    info = {"batch": AMP_BATCH, "seq": TRAIN_SEQ, "steps": AMP_O1_STEPS,
            "losses": losses, "step_ms": 1e3 * wall / AMP_O1_STEPS,
            "tokens_per_s": tok / wall,
            "mfu": model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
            / BF16_OPS_PER_S,
            "loss_scale": float(st.scaler.loss_scale),
            "skipped_steps": int(st.scaler.skipped_steps),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs_plain,
            "launches_per_step": {k: v / AMP_O1_STEPS
                                  for k, v in launches.items() if v}}
    del model, params, st
    torch.cuda.empty_cache()
    return info, launches


def phase_amp_overflow(torch, dev):
    """The flagship's step from a loss scale of 2**24: at least one skipped
    step; on each skipped step the masters, the fp16 model params and
    every exp_avg, exp_avg_sq and step count bit-identical to their copies
    from before it, the scale halved; finite steps after the overflows."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.utils.pytree import tree_leaves

    model, st, (tokens, targets) = amp_flagship(torch, dev,
                                                AMP_OVERFLOW_INIT)
    opt = st.optimizer
    trail = []
    finite_after = 0
    for _ in range(AMP_OVERFLOW_STEPS):
        masters = [t.clone() for t in tree_leaves(st.params.master)]
        models = [t.detach().clone() for t in tree_leaves(st.params.model)]
        state = [(s_["step"], s_["exp_avg"].clone(), s_["exp_avg_sq"].clone())
                 for s_ in (opt.state.get(t) for t in
                            tree_leaves(st.params.master)) if s_]
        scale = float(st.scaler.loss_scale)
        loss, finite = amp_step(amp, model, st, tokens, targets)
        finite = bool(finite)
        new_scale = float(st.scaler.loss_scale)
        rec = {"scale_before": scale, "scale_after": new_scale,
               "finite": finite, "loss": float(loss)}
        if not finite:
            after = [(s_["step"], s_["exp_avg"], s_["exp_avg_sq"])
                     for s_ in (opt.state.get(t) for t in
                                tree_leaves(st.params.master)) if s_]
            same = (all(torch.equal(a, b_) for a, b_ in zip(
                masters, tree_leaves(st.params.master)))
                and all(torch.equal(a, b_.detach()) for a, b_ in zip(
                    models, tree_leaves(st.params.model)))
                and len(after) == len(state)
                and all(a[0] == b_[0] and torch.equal(a[1], b_[1])
                        and torch.equal(a[2], b_[2])
                        for a, b_ in zip(state, after)))
            rec["state_unchanged"] = same
            check(same, f"amp_overflow: a skipped step changed the masters, "
                  f"the model params or Adam's state (scale {scale})")
            check(new_scale == scale / 2, f"amp_overflow: scale {scale} -> "
                  f"{new_scale} on an overflow")
        elif any(not r["finite"] for r in trail):
            finite_after += 1
        trail.append(rec)
        del masters, models, state
        if finite_after >= 3:
            break
    skipped = int(st.scaler.skipped_steps)
    check(skipped >= 1, "amp_overflow: no skipped step from 2**24")
    check(finite_after >= 1 and trail[-1]["finite"]
          and np.isfinite(trail[-1]["loss"]),
          f"amp_overflow: no finite step after the overflows: {trail}")
    info = {"init_scale": AMP_OVERFLOW_INIT, "steps": trail,
            "skipped_steps": skipped,
            "final_scale": float(st.scaler.loss_scale)}
    del model, st
    torch.cuda.empty_cache()
    return info


def main(argv=None):
    global PARENT, PTXAS, EMPTY
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive apex_tpu_torch's main "
                                 "paths on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout (e.g. a git archive of the parent "
                    "commit) whose ln_fwd, ln_bwd, softmax_fwd, decode, "
                    "sampling and verify kernels are timed in turns with "
                    "this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import apex_tpu_torch
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import decode_attention as dmod
    from apex_tpu_torch.ops import layer_norm as lnmod
    from apex_tpu_torch.ops import sampling as smod
    from apex_tpu_torch.tools import rowwise_ab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit("env", apex_tpu_torch.env_report())

    # --- build ----------------------------------------------------------------
    _build.library_path().unlink(missing_ok=True)  # build from the sources
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        other = (pool.submit(rowwise_ab.other_library, args.parent)
                 if args.parent else None)
        empty = pool.submit(rowwise_ab.empty_library)
        _build.library()
        build_s = time.perf_counter() - t0
        if other is not None:
            PARENT = other.result()
        EMPTY = empty.result()
    PTXAS = rowwise_ab.ptxas_report(_build.build_log())
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    changes = None if PARENT is None else rowwise_ab.ptxas_changes(
        PTXAS, rowwise_ab.ptxas_report(PARENT[1]))
    emit("build", {"seconds": build_s, "library": str(
        _build.library_path().relative_to(ROOT)), "ptxas": ptxas,
        "parent": None if PARENT is None else {
            "root": args.parent,
            "ptxas": rowwise_ab.ptxas_report(PARENT[1]),
            "ptxas_changes": changes}})
    # every parent kernel (the bf16 instances of the bodies that gained an
    # element type among them) keeps its registers and spills
    check(changes is None or (not changes["changed"]
                              and not changes["missing"]),
          f"kernels whose registers or spills differ from the parent's: "
          f"{changes}")

    # --- each kernel against its plain version --------------------------------
    kernels = [phase_decode_kernel(torch, dev),
               phase_sample_kernel(torch, dev),
               *phase_flash_kernels(torch, dev),
               phase_xent_kernel(torch, dev),
               *phase_ln_kernels(torch, dev),
               *phase_softmax_kernels(torch, dev)]
    for k in kernels:
        emit("kernel", k)
    torch.cuda.empty_cache()

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
    lnmod.ln_fwd_cuda.launches = 0
    greedy, g_info = serve(torch, model, params, dev)
    g_dec = dmod.paged_decode_attn_cuda.launches
    g_smp = smod.fused_sample_cuda.launches
    g_ln = lnmod.ln_fwd_cuda.launches
    sampled, s_info = serve(torch, model, params, dev, gen_seed=1,
                            **SAMPLED)
    launches = {"paged_decode_attn": dmod.paged_decode_attn_cuda.launches,
                "fused_sample": smod.fused_sample_cuda.launches,
                "ln_fwd": lnmod.ln_fwd_cuda.launches}
    # each main path's counts, read just after it ran with them zeroed
    paths = {"serve": launches}
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
    # 2L + 1 norms per model forward: each decode step and prefill chunk
    for what, n, info in (("greedy", g_ln, g_info),
                          ("sampled", launches["ln_fwd"] - g_ln, s_info)):
        forwards = info["decode_steps"] + info["prefill_chunks"]
        check(n == (2 * L + 1) * forwards,
              f"{what} serve: {n} ln_fwd launches for {forwards} model "
              f"forwards x {2 * L + 1} norms")

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
    del warm
    torch.cuda.empty_cache()

    # --- the decode-engine slice ----------------------------------------------
    d_kernels = [phase_bshd_kernel(torch, dev),
                 phase_contig_decode_kernel(torch, dev),
                 *phase_verify_kernels(torch, dev)]
    for k in d_kernels:
        emit("kernel", k)
    kernels += d_kernels
    torch.cuda.empty_cache()
    eng, cache, greedy_dec, d_info, paths["decode"] = phase_decode(
        torch, model, params, dev)
    emit("decode", d_info)
    emit("decode_profile", phase_decode_outside(
        torch, model, params, dev, eng, cache, greedy_dec,
        min(d_info["decode_pass_ms"]) / 1e3))
    del eng, cache
    torch.cuda.empty_cache()
    s_info, paths["spec"] = phase_spec(torch, model, params, dev)
    emit("spec", s_info)
    emit("spec_verify_gap", verify_gap(d_kernels,
                                       s_info["verify_launches_by_mode"]))
    torch.cuda.empty_cache()
    ss_info, paths["spec_serve"] = phase_spec_serve(torch, model, params,
                                                    dev)
    emit("spec_serve", ss_info)
    emit("spec_serve_verify_gap", serve_verify_gap(
        d_kernels, ss_info["verify_launches_by_mode"]))
    del model, params
    torch.cuda.empty_cache()

    # --- the train path -------------------------------------------------------
    state, t_info, paths["gpt_train"] = phase_train(torch, dev)
    emit("train", t_info)
    phase_train_plain(torch, *state[:2], *state[3:])
    emit("train_profile", phase_train_profile(
        torch, lambda: train_step(*state), t_info["step_ms"] / 1e3))
    del state
    torch.cuda.empty_cache()

    # --- dropout: the flash kernels' masks, the elementwise kernel, GPT ------
    drop_kernel, drop_times_ = phase_dropout_kernels(torch, dev)
    emit("kernel", drop_kernel)
    kernels.append(drop_kernel)
    torch.cuda.empty_cache()
    dt_info, paths["gpt_dropout_train"] = phase_gpt_dropout_train(
        torch, dev, t_info)
    emit("gpt_dropout_train", dt_info)
    torch.cuda.empty_cache()
    rp_info, rp_paths = phase_gpt_remat_policies(torch, dev)
    paths.update(rp_paths)
    emit("gpt_remat_policies", rp_info)
    torch.cuda.empty_cache()

    # --- amp: the fp16 instances, the O2 and O1 fp16 legs, the overflow ----
    f16_kernels = phase_fp16_flash(torch, dev) + phase_fp16_rows(torch, dev)
    for k in f16_kernels:
        emit("kernel", k)
    kernels += f16_kernels
    torch.cuda.empty_cache()
    a2_info, paths["amp_o2_fp16_train"] = phase_amp_o2_fp16_train(torch, dev)
    emit("amp_o2_fp16_train", a2_info)
    a1_info, paths["amp_o1_fp16_train"] = phase_amp_o1_fp16_train(torch, dev)
    emit("amp_o1_fp16_train", a1_info)
    emit("amp_overflow", phase_amp_overflow(torch, dev))
    torch.cuda.empty_cache()

    # --- the T5 slice ---------------------------------------------------------
    t5_kernels = phase_t5_kernels(torch, dev)
    for k in t5_kernels:
        emit("kernel", k)
    kernels += t5_kernels
    torch.cuda.empty_cache()
    # at the initial params, on a padded batch of the full 128 x (512, 114)
    emit("t5_plain_path", phase_t5_plain(
        torch, *t5_model(torch, dev, torch.bfloat16),
        *t5_batch(torch, dev, T5_BATCH, seed=3), "initial (seed 0)", True))
    torch.cuda.empty_cache()
    t5_state, t5_info, paths["t5_train"] = phase_t5_train(torch, dev)
    emit("t5_train", t5_info)
    # at the params the timed steps left, on the same unpadded batch
    enc, dec, tgt, _ = t5_batch(torch, dev, T5_BATCH, seed=1)
    emit("t5_plain_path_trained", phase_t5_plain(
        torch, *t5_state[:2], enc, dec, tgt, None,
        f"after {T5_STEPS + 1} Adam steps", False))
    torch.cuda.empty_cache()
    emit("t5_padded", phase_t5_padded(torch, t5_state, dev))
    emit("t5_profile", phase_train_profile(
        torch, lambda: t5_step(*t5_state, enc, dec, tgt),
        t5_info["step_ms"] / 1e3))
    del t5_state, enc, dec, tgt
    torch.cuda.empty_cache()
    eo_info, eo_paths = phase_t5_encode_only(torch, dev)
    paths.update(eo_paths)
    emit("t5_encode_only", eo_info)
    torch.cuda.empty_cache()

    # --- the BERT slice -------------------------------------------------------
    fwd_bert, bert_kernels = phase_bert_kernels(torch, dev)
    by_name = {k["name"]: k for k in kernels}
    bshd = by_name["flash_fwd_bshd"]
    bshd["per_shape"] = {"bert_padded": fwd_bert}
    bshd["max_abs_err"] = max(bshd["max_abs_err"], fwd_bert["max_abs_err"])
    for k in bert_kernels:
        emit("kernel", k)
    kernels += bert_kernels
    torch.cuda.empty_cache()
    emit("bert_plain_path", phase_bert_plain(torch, dev))
    torch.cuda.empty_cache()
    b_state, b_info, paths["bert_train"] = phase_bert_train(torch, dev)
    emit("bert_train", b_info)
    emit("bert_profile", phase_train_profile(
        torch, lambda: bert_step(*b_state), b_info["step_ms"] / 1e3))
    del b_state
    torch.cuda.empty_cache()

    # --- the array bias and the T5 materialized leg ---------------------------
    per_bias, dbias_kernel = phase_bias_kernels(torch, dev)
    flash_errs = dbias_kernel.pop("flash_max_abs_err")
    by_name = {k["name"]: k for k in kernels}
    # the array-bias option's checks and times go to the kernels that run it
    for op, names in (("fwd", ("flash_fwd_flat", "flash_fwd_bshd")),
                      ("dkv", ("flash_bwd_flat_dkv", "flash_bwd_bshd_dkv")),
                      ("dq", ("flash_bwd_flat_dq", "flash_bwd_bshd_dq"))):
        plain = "plain_fwd_ms" if op == "fwd" else "plain_bwd_ms"
        for name in names:
            k = by_name[name]
            layout = "bshd" if "bshd" in name else "bhsd"
            k["array_bias"] = {
                call: {"ms": v[f"{op}_ms"],
                       "sm80_ms": v.get(f"sm80_{op}_ms"),
                       "plain_ms": v[plain],
                       "bound_ms": v["bounds"][op][0],
                       "bound_by": v["bounds"][op][1],
                       "library_ms": v["sdpa_fwd_ms" if op == "fwd"
                                       else "sdpa_bwd_ms"]}
                for call, v in per_bias.items()
                if v["shape"]["layout"] == layout}
            k["max_abs_err"] = max(k["max_abs_err"], flash_errs[op])
    emit("kernel", dbias_kernel)
    kernels.append(dbias_kernel)
    torch.cuda.empty_cache()
    m_info, paths["t5_materialized"] = phase_t5_materialized(torch, dev)
    emit("t5_materialized", m_info)
    torch.cuda.empty_cache()

    # --- the softmax routes: the models' default attention_impl -------------
    sm_info, paths["gpt_softmax_train"] = phase_gpt_softmax(torch, dev)
    emit("gpt_softmax_train", sm_info)
    torch.cuda.empty_cache()
    sd_info, paths["gpt_softmax_dropout"] = phase_gpt_softmax_dropout(
        torch, dev)
    emit("gpt_softmax_dropout", sd_info)
    torch.cuda.empty_cache()
    sm_info, paths["bert_softmax_train"] = phase_bert_softmax(torch, dev)
    emit("bert_softmax_train", sm_info)
    torch.cuda.empty_cache()
    for pe in ("learned", "relative"):
        sm_info, paths[f"t5_softmax_train_{pe}"] = phase_t5_softmax(
            torch, dev, pe)
        emit(f"t5_softmax_train_{pe}", sm_info)
        torch.cuda.empty_cache()
    emit("softmax_bwd_gap", softmax_bwd_gap(
        by_name["softmax_bwd"]["per_shape"], paths))

    # --- the fused-dense and MLP slice: matmul_bias_act -----------------------
    mm_kernel = phase_matmul_kernel(torch, dev)
    emit("kernel", mm_kernel)
    kernels.append(mm_kernel)
    torch.cuda.empty_cache()
    b_info, paths["block_train"] = phase_block_leg(torch, dev)
    emit("block_train", b_info)
    torch.cuda.empty_cache()
    m_info, paths["mlp_train"], paths["mlp_forward"] = phase_mlp_leg(
        torch, dev)
    emit("mlp_train", m_info)
    torch.cuda.empty_cache()

    for k in kernels:
        by = {p_: n[k["name"]] for p_, n in paths.items()
              if n.get(k["name"])}
        k["launches"] = sum(by.values())
        k["launches_by_path"] = by
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    mm_kernel["variants"] = {
        v: {p_: n[f"matmul_bias_act_{v}"] for p_, n in paths.items()
            if n.get(f"matmul_bias_act_{v}")}
        for v in ("wgmma", "sm80", "fp32", "split")}
    for k in kernels:  # the flash kernels' launches by variant
        counter = {"flash_bwd_flat_dtable": "flash_bwd_flat_dkv"}.get(
            k["name"], k["name"])
        if f"{counter}_wgmma" in paths["gpt_train"]:
            k["variants"] = {
                v: {p_: n[f"{counter}_{v}"] for p_, n in paths.items()
                    if n.get(f"{counter}_{v}")} for v in ("wgmma", "sm80")}
    by_name = {k["name"]: k for k in kernels}
    # the flash kernels' dropout: the checks and the times with and
    # without it (the latter beside the parent's in turns under --parent)
    for fam, names in (("gpt_packed", ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")),
                       ("bert_bshd", ("flash_fwd_bshd", "flash_bwd_bshd_dq",
                                      "flash_bwd_bshd_dkv")),
                       ("t5_enc_flat", ("flash_fwd_flat", "flash_bwd_flat_dq",
                                        "flash_bwd_flat_dkv"))):
        for op, name in zip(("fwd", "dq", "dkv"), names):
            by_name[name]["dropout"] = dict(drop_times_[fam][op], call=fam)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        by_name[name]["dropout"]["gqa_check"] = DROPOUT_CHECKS["gqa_packed"]
        by_name[name]["dropout"]["launches_with_dropout"] = {
            p_: n[f"{name}_dropout"] for p_, n in paths.items()
            if n.get(f"{name}_dropout")}
    emit("flash_bwd_ab", {
        "calls": BWD_AB,
        "wgmma_slower_than_sm80": [c for c in BWD_AB
                                   if c["wgmma_ms"] >= c["sm80_ms"]]})
    emit("flash_fwd_ab", {
        "calls": FWD_AB,
        "wgmma_not_faster_than_sm80": [c for c in FWD_AB
                                       if c["wgmma_ms"] >= c["sm80_ms"]]})
    emit("dbias_ab", {
        "calls": DBIAS_AB,
        "wgmma_not_faster_than_sm80": [c for c in DBIAS_AB
                                       if c["wgmma_ms"] >= c["sm80_ms"]]})
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
