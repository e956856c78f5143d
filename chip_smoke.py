#!/usr/bin/env python3
"""chip_smoke.py — drive apex_tpu_torch's serving path, its decode engine
(with speculative decoding), its serving telemetry and weight hot-swap,
its GPT-medium train step (also with GPT-2's
dropout 0.1, under each remat policy, under amp at fp16: O2 with fp32
master weights and the dynamic loss scaler, and O1, and under the legacy
``FP16_Optimizer``), its T5-base train
step (with the bucketed and the materialised relative bias, and under
``remat_policy="encode_only"``), its
BERT-large padded MLM train step (also under LAMB and mixed-precision
LAMB), the three train steps again on the models' default softmax
attention route, the fused-dense block and MLP train steps (also under
LARC + SGD), every optimizer's step at GPT-medium's size, BERT's
encoder-serving entry, a Transformer-big step built from contrib's
attention modules (key padding and dropout beside the array bias, the
label-smoothed cross-entropy), the norms past hidden 4096 (contrib's
FastLayerNorm) driven by a GPT step and generation at Megatron's 39.1B
widths, contrib's RNN-T transducer and ASP 2:4 sparsity, ResNet-50's O2
step on the batch-norm kernel (with contrib's bottleneck and
conv_bias_relu) and the whole RNN-T step on rnn/'s LSTMs, on one CUDA
card.

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
6b. quantized pools and the decode bias, on the serve's model and
   weights: the paged kernel's int8 and fp8 instances at the serve's
   shapes (8 slots, MHA and GQA, ragged lengths with 0) against their fp32
   function within DECODE_TOL and the reference-order plain version
   within its own distance from that function plus one bf16 ulp,
   bit-identical across two runs, every scale at 1 refused, timed at 8 x
   512 and a ragged mix in turns with the bf16 instance
   (``quant_decode_times``); both decode kernels' bias instances (a
   seeded causal table, 32 buckets, max distance 128) at the serve's and
   the decode leg's shapes against the plain version, a zero table
   refused, timed in turns with the unbiased instance and beside SDPA
   with the bias as a float mask (``rel_decode_times``); then
   ``quant_serve``: the greedy trace with kv_dtype="int8" and "fp8_e4m3"
   (12 quantized launches per decode step asserted, tokens/s,
   pool_bytes beside the float pool's, exact accounting at drain, the
   teacher-forced max |logit difference| against the float pool over 32
   tokens, ``quant_logit_err``), an int8 serve with the n-gram chain
   drafter held to the int8 plain serve's tokens (near-ties only); and
   ``rel_decode``: GPT-medium with a ``decode_rel_bias`` hook through
   DecodeEngine at the decode leg's shape and a greedy serve (12 biased
   launches per step asserted), the kernel path's logits against
   impl="torch" on the same card (the gap at most twice the unbiased
   model's plus DECODE_TOL, and below the bias's own effect);
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
    * the bshd forward, dQ and dK/dV with T5's bucketed table (32
      bidirectional buckets, max distance 128, a column a head) at BERT's
      call, by the flash family's checks, the table gradient within 1e-3
      relative norm of the plain version's and the fp32 truth's, timed in
      turns with the bh-flat entry on the same data and beside SDPA with
      the bias as a float mask; then ``bshd_rel_attention``: 3 forward and
      backward steps of ``flash_attention(layout="bshd",
      bias=BucketedBias)`` through autograd, one launch of each biased
      kernel a step asserted;
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
14. the optimizers and the legacy fp16 API (no kernel of their own; the
    legs' launches are the kernels' they drive):
    * ``bert_lamb_train``: the BERT leg's model and batch under
      ``FusedLAMB`` in NVIDIA's recipe (two groups: the weights at decay
      0.01, the 1-D biases and norm parameters at 0; lr 4e-3, betas (0.9,
      0.999), eps 1e-6, clip 1.0), a warm-up and 10 timed steps with the
      BERT leg's launches asserted, losses finite and falling; step ms,
      tokens/s, MFU, peak memory and ``opt.step()``'s own ms (CUDA events)
      beside the FusedAdam leg's; ``bert_mp_lamb_train`` the same under
      ``FusedMixedPrecisionLamb`` (fp32 masters in its state);
    * ``gpt_fp16_optimizer_train`` (after the amp legs): GPT-medium through
      ``convert_network(params, torch.float16)`` (ln*/lnf_* kept fp32, the
      LayerNorm kernels handed fp16 x and fp32 parameters) under
      ``FP16_Optimizer(FusedAdam(lr=1e-4), dynamic_loss_scale=True)`` at
      16 x 1024: 2 warm-up and 10 timed steps with the flagship's fp16
      launches asserted, beside the flagship's step; then from 2**24 for 5
      steps, at least one skipped with the masters, fp16 params and Adam's
      state bit-identical across it;
    * ``mlp_larc_sgd`` (after the MLP leg): ``LARC(FusedSGD(lr=0.1,
      momentum=0.9), trust_coefficient=0.02, clip=True)`` on the MLP leg,
      10 timed steps with its 15 wgmma launches a step and no other kernel,
      losses finite and falling;
    * ``optimizer_steps``: FusedAdam, FusedLAMB, FusedMixedPrecisionLamb,
      FusedSGD (momentum, Nesterov), FusedNovoGrad (L2, inf), FusedAdagrad
      and LARC + FusedSGD each stepping GPT-medium's 186M bf16 parameters
      on seeded gradients: the first step held against the same optimizer
      on CPU copies of four leaves by the CPU parity tests' tolerance, 2
      more, the median of 10 more beside the bytes bound; LAMB with its
      trust ratio left out (a patched copy of ``lamb_math``) refused;
15. serving telemetry, weight hot-swap and the encoder entry (no kernel
    of their own; the legs' launches are the kernels' they drive):
    * ``serve_telemetry`` (after ``rel_decode``): the serve cell, greedy,
      four serves in ABBA turns with ``telemetry=False`` and with a
      ``ServeTelemetry(slots=8, window_s=0.5)`` attached while the monitor
      registry writes a JSONL file in a temporary directory: tokens and
      the paged-decode, ``fused_sample`` and ``ln_fwd`` launches (12 a
      decode step, 25 a forward) identical both ways; every request's
      submit, admit, first_token and finish in order under one trace id;
      at least one ``serve_window``; every record OK and finite; exact
      accounting at drain; the same sampled (one generator seed) and
      with the n-gram tree drafter (the spec records and the
      ``serve_spec_tree`` spans, one tree-verify launch a round) both
      ways; tokens/s both ways and the tracker's overhead as a share of
      the wall time; the reference's per-step hook budget (one
      ``on_decode_step``, one ``observe_itl`` a slot and one
      ``maybe_window``, the min of 3 passes of 1000) under 1% of the
      measured decode step; dispatches 1-40 of a telemetry serve under
      ``torch.profiler``: host and device ms under each
      ``serve_prefill``/``serve_decode`` range, their counts equal to the
      traced dispatches, and their share of the window's wall time;
    * ``serve_swap``: the serve cell with ``request_swap`` at dispatch 60:
      a clone of the weights token-identical to no swap (``swaps == 1``),
      seeded perturbed weights keeping every token made before the swap
      and changing later ones, an unreached step leaving ``swaps == 0``,
      the pool's tensors never moving; a hooked GPT-medium whose decode
      bias table is a parameter, swapped to another table: the first
      decode step after the swap replayed on the plain path agrees with
      the new table (the rel_decode rule) and not the old;
    * ``encoder`` (after ``bshd_rel_attention``): ``jit_encoder`` over
      BERT-large bf16 at 32 x 512 with the cell's lengths and token types,
      10 timed calls: 24 bshd flash forwards (all wgmma) and 49 ln_fwd a
      call and no other kernel; hidden and pooled against the plain path
      and an fp32 truth by the flash rule; sequences/s, valid tokens/s, ms
      a call;
16. dropout beside the array bias, the loss ops and contrib's attention
    (after the optimizer legs):
    * the kArr x kDrop instances of the flash forward, dQ and dK/dV and
      dbias's mask at the Transformer-big leg's key-padding call (the
      (h, b, s, d) views of (b, s, h, d) tensors, b·h 512, 128 x 128, d
      64, a (b, sq, sk) -1e9 bias) and at a bshd call with an (h, sq, sk)
      attn_mask and BERT's lengths at BERT-large's widths (32 x 512, 16
      heads of 64), dropout 0.1: o, dq, dk, dv by the flash rule, dbias
      within 1e-3 relative norm of the fp32 truth, lse equal to the
      dropout-free call's, every output bit-identical across two runs;
      on each call's GQA variant every dropout fault the kernels plant
      (the kv head's key, row and column swapped, dK/dV's dS unmasked, l
      from the dropped p, dbias's dP unmasked) refused; each instance
      timed in turns beside the call's bias-only and dropout-only
      instances, the plain version, SDPA with the bias as a float mask
      and dropout_p 0.1 and its bound (``bias_dropout_check``,
      ``bias_dropout_times``; the kernels line's ``bias_dropout``);
    * ``transformer_big_train``: Transformer-big (d_model 1024, d_ff
      4096, 16 heads, 6 + 6 pre-norm layers of contrib's
      ``SelfMultiheadAttn``/``EncdecMultiheadAttn`` with
      ``include_norm_add`` and attention dropout 0.1, a shared tied
      vocabulary of 37000, sinusoidal positions), 32 pairs padded to 128
      a side, ``SoftmaxCrossEntropyLoss`` with smoothing 0.1, FusedAdam
      (0.9, 0.98, 1e-9), bf16: one step against the plain path and an
      fp32 truth, 2 warm-up and 3 timed steps with fresh seeds: per step
      12 bh-flat forward, dQ, dK/dV and dbias launches with the bias and
      dropout, 6 bshd forward, dQ and dK/dV with dropout, 32 ``ln_fwd``
      and ``ln_bwd``, one ``xent_stats``, nothing else; step ms,
      tokens/s, model TFLOP/s and MFU, peak memory, a profile;
    * ``fmha_varlen`` at BERT-large's packed batch (the BERT cell's
      lengths, dropout 0.1): one bshd forward, dQ and dK/dV; o and dqkv
      by the flash rule; forward and backward ms;
    * ``loss_ops``: ``softmax_cross_entropy_loss`` at (4096, 37000) bf16,
      smoothing 0.1 (one ``xent_stats`` launch; within 1e-4 of its fp32
      truth; ms against the bytes bound and ``F.cross_entropy``), and
      ``focal_loss`` at RetinaNet's head (2 x 200,700 anchors x 80
      classes, fp32; within 1e-5 of its fp64 truth; ms);
17. the norms past hidden 4096, FastLayerNorm, the RNN-T transducer and
    ASP (after the loss ops):
    * ``ln_wide``: ``csrc/layer_norm_wide.cu``'s forward and backward (a
      row over a thread-block cluster) at hidden 4097, 5000, 5120, 6144,
      8192, 12288, 16384, 25600, 32768, 49152 and 65536, 2048 and 8 rows,
      bf16 LayerNorm (gamma, beta) and RMSNorm (gamma), fp32 and fp16 x at
      8192 and 65536: y and dx by the bf16 rule (the fp16 rule; fp32
      within 1e-5), mean and rstd within 1e-5, dgamma/dbeta within an ulp
      of the largest entry, all bit-identical across two runs
      (``ln_wide_check``); both planted faults (the row's last 16-byte
      chunk left out of the statistics; the last rank's, or warp's,
      partial not merged) refused at every width on fp32 rows with a large
      tail (``ln_wide_faults``); each call timed beside its bytes bound,
      the plain version and ``F.layer_norm`` (forward, and its autograd
      backward; the forward also at 8 rows; ``ln_wide_times``); then the
      path: ``contrib.layer_norm.FastLayerNorm`` and ``fused_rms_norm``
      forward and backward at every width (fp32 and fp16 too at 8192 and
      65536), every norm on the wide instances and none on
      ``layer_norm.cu``'s;
    * ``wide_gpt_train``: GPT at Megatron's 39.1B widths (Narayanan et al.
      2021, Table 1: vocab 51200, seq 2048, hidden 8192, 64 heads of 128,
      FFN 32768; flash, no remat) cut to 2 of 48 layers, bf16, batch 1 x
      2048, FusedAdam: one step against the plain path and an fp32 truth,
      2 warm-up and 5 timed steps on fresh data with 5 wide ``ln_fwd`` and
      ``ln_bwd``, 2 packed flash forward, dQ and dK/dV (wgmma) and one
      ``xent_stats`` a step and no other kernel; step ms, tokens/s, MFU,
      peak memory, a profile;
    * ``wide_decode``: ``DecodeEngine.generate`` on that model, batch 16,
      prompt 512, 32 greedy tokens: two passes token-identical, 5 wide
      ``ln_fwd`` a forward, 2 bshd flash forwards a prefill and 2
      ``decode_attn`` a step; prefill ms and decode tokens/s;
    * ``transducer_rnnt``: contrib's ``TransducerJoint`` (ReLU) and
      ``TransducerLoss`` at the MLPerf RNN-T joint's widths (batch 16, T
      in [140, 278], U in [20, 100], V 1024) on seeded encoder and
      predictor outputs: the loss within 1e-5 and the logits' gradient
      within 2e-4 of its largest entry of the fp64 truth; forward and
      backward ms, the card's kernel launches, peak memory;
    * ``asp_gpt``: ASP on GPT-medium: the permutation search on layer 0's
      ``qkv`` and ``mlp_down`` weights (256 sweeps: seconds, retained
      magnitude), the 2:4 masks applied, 2 warm-up and 5 timed steps under
      ``wrap_optimizer(FusedAdam)`` with every pruned entry 0 and no group
      over 2 of 4 after every step and the train leg's launches; step ms
      beside the dense leg's;
18. ResNet-50 and the whole RNN-T step (after ASP):
    * ``bn_kernel``: ``csrc/batch_norm.cu``'s forward (fp32 Welford sums
      over fixed row chunks, combined in a fixed order; the apply with the
      residual and the ReLU) and backward (Σdy', Σdy'·x̂ the same way; dx
      and dresidual) at each of the 16 distinct calls of ResNet-50's step
      at batch 256 (bf16 x, y and parameters), and at one call in fp32
      and in fp16: y, dx and dresidual by the norm rule against the fp32
      plain version (the backward given the kernel's y for the ReLU's
      mask), mean and rstd within 1e-5, dscale and dbias within 2^-7
      (bf16) or 1e-5 (fp32) of the largest, all bit-identical across two
      runs; two planted faults (the last row chunk left out of the
      statistics; dx without its −x̂·Σdy'x̂/M term) refused at every call;
      each call timed beside its bytes bound, the plain version and
      ``F.batch_norm`` on the channels_last view + ``add_``/``relu_`` (and
      its autograd backward), and the step's sums of each;
    * ``resnet50_train``: the reference example's defaults
      (``examples/imagenet/main_amp.py:34-54``: ResNet-50 v1.5, 224²,
      1000 classes, batch 256, O2 with the dynamic scaler, FusedSGD lr
      0.1, momentum 0.9, weight decay 1e-4, the xentropy loss with
      ``half_to_float``) on its --deterministic data (a fresh seeded batch
      a step, class colour templates): 2 warm-up and 48 timed steps with
      53 batch-norm forward and 53 backward launches (16 with the
      residual and ReLU, 33 with the ReLU, 4 with neither) and one
      ``xent_stats`` a step, nothing else; losses finite and falling; step
      ms, images/s, model TFLOP/s and MFU (3 × the convolutions' and fc's
      FLOPs over 989 TFLOP/s), peak memory, a profile;
    * ``resnet50_checks``: one O2 step at batch 32 against the plain path
      and an fp32 truth (each leaf's error from the truth within twice the
      plain path's + 1e-3; the loss's within twice the plain path's
      spread over the images at four scales, which the network does not
      see, + 1e-4), the same step in fp32 (loss kernel vs plain within
      1e-4), an eval forward on the trained running statistics (53 eval
      launches; logits within 1e-2 relative norm of the plain path's), a
      stage-1 ``Bottleneck`` and the ``conv_bias_relu`` family (XLA's SAME
      at stride 2) against their plain versions and fp32 truths;
    * ``rnnt_train``: the MLPerf RNN-T step (``baseline_v3-1023sp.yaml``:
      240 features, 2 + 3 LSTM layers of 1024 around a time stacking of 2,
      an embedding and 2 LSTM layers of 320, the joint of 512 and V 1024),
      batch 16 at ``transducer_rnnt``'s lengths, bf16 weights and the loss
      in fp32: a warm-up and 3 FusedSGD steps on one batch, losses finite
      and falling, no kernel of the port launched; forward and backward
      ms, peak memory;
19. one ``{"kernels": [...]}`` line (all twenty-three kernels, the six
    fp16 instances, ``<name>_f16``, the wide norm instances
    ``ln_fwd_wide``/``ln_bwd_wide`` and their fp16 ``_f16``, and the
    seven instances of
    ``paged_decode_attn_int8``/``_fp8``/``_rel``,
    ``decode_attn_rel``, ``flash_fwd_bshd_rel``,
    ``flash_bwd_bshd_dq_rel``/``_dkv_rel``; the flash kernels' kArr x
    kDrop instances under ``bias_dropout``; the batch-norm kernels
    ``bn_fwd``/``bn_bwd``), each with
    its launches by main path; matmul_bias_act and the flash kernels
    also by variant, every train leg's, the decode leg's and the T5
    materialized leg's flash forward and dbias launches asserted on
    wgmma; the flash kernels' ``sm80_ms`` from the A/B), the
    card's name and power limit as nvidia-smi prints them, and last
    ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import json
import math
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
# ``--parent DIR``: that checkout's FusedAdam class (its own fused_adam.py
# and, where it has one, its own _fused.py), stepped in turns with this
# tree's in the flagship and at 186M; None without it
PARENT_ADAM = None
# registers and spills of every kernel of this run's build, by name
PTXAS = {}
# this tree's ln_fwd, sampling and verify kernels returning at once
# (rowwise_ab.empty_library): the fixed cost of their launches
EMPTY = None


#: main's sections' wall seconds (build excluded), emitted as
#: ``section_seconds`` before the kernels line
SECTION_SECONDS = {}
_SECTION = [None, 0.0]


def section(name):
    """Close main's running section (its wall seconds into
    SECTION_SECONDS) and start ``name`` (None: close only)."""
    now = time.perf_counter()
    if _SECTION[0] is not None:
        SECTION_SECONDS[_SECTION[0]] = now - _SECTION[1]
    _SECTION[:] = [name, now]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


#: time_ms's trials: 5 (11 until the script's wall time passed 1000 s of
#: its 1200 s limit on slower hosts)
TRIALS = 5


def time_ms(fn, arg_sets, reps=20, trials=TRIALS):
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


def decode_plan_info(torch, q3, nb, bs, paged, kv_dtype=None, maxd=0):
    """The split plan of a decode call on q (rows, group, d) — on a
    quantized pool's ``kv_dtype`` or with the bias's ``maxd`` — S (the
    cluster's size), the ring's tiles, the CTAs, the shared memory, how
    many such clusters the card holds at once, and the instance's
    registers and spills (ptxas)."""
    from apex_tpu_torch.ops import decode_attention as D

    rows, group, d = q3.shape
    plan = D._plan_for(q3, nb, bs, kv_dtype, maxd)
    clusters = D.max_active_clusters(plan, q3.dtype, d, group, bs, paged,
                                     kv_dtype, maxd)
    check(clusters >= 1, f"the card holds no cluster of the decode plan "
          f"{plan}")
    dtype = "__nv_bfloat16" if q3.dtype == torch.bfloat16 else "float"
    cells = {torch.int8: "signed char",
             torch.float8_e4m3fn: "__nv_fp8_e4m3"}.get(kv_dtype, dtype)
    return {"rows": rows, "group": group, "blocks": nb, "block_rows": bs,
            "splits": plan.splits, "cluster": [plan.splits, 1, 1],
            "ctas": rows * plan.splits, "tiles": plan.tiles,
            "smem_bytes": plan.smem, "max_active_clusters": clusters,
            "ptxas": ptxas_of("decode_kernel", (
                dtype, cells, str(d), str(group),
                "true" if paged else "false", "true" if maxd else "false"))}


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
    if "namespace)::bn_" in name:
        return "batch-norm kernels"
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


# --- quantized pools and the decode bias -------------------------------------

# the serving engine's quantized pools (kv_dtype), each a kernel instance
QUANT_KV = ("int8", "fp8_e4m3")
QUANT_NAMES = {"int8": "paged_decode_attn_int8",
               "fp8_e4m3": "paged_decode_attn_fp8"}
# teacher-forced decode steps of the quantized serve's logit error
# (bench.py::_spec_quant_err's 32 tokens)
QUANT_ERR_TOKENS = 32
# the decode bias: T5's bucketing (32 causal buckets, max distance 128),
# one seeded table column a query head
REL_BUCKETS, REL_MAX_DISTANCE, REL_SEED = 32, 128, 71
# teacher-forced decode steps at which the biased model's kernel-path
# logits are held against its plain path's
REL_LOGIT_STEPS = 8


def quant_pools(torch, pk, pv, kv):
    """Pools quantized row by row as the serving engine's write sites do
    (``_quant_rows`` over each block row's kv heads and head_dim): (k
    cells, v cells, k_scale, v_scale)."""
    from apex_tpu_torch.serving.engine import KV_QUANT_SPECS, _quant_rows

    qmax, qdtype = KV_QUANT_SPECS[kv]
    cells, scales = [], []
    for pool in (pk, pv):
        c, s = _quant_rows(pool.transpose(1, 2), (2, 3), qmax=qmax,
                           qdtype=qdtype)
        cells.append(c.transpose(1, 2).contiguous())
        scales.append(s.contiguous())
    return cells[0], cells[1], scales[0], scales[1]


def quant_rule(got, plain, want32):
    """The quantized kernel's rules: within DECODE_TOL of its fp32
    function (``quant_decode_fp32``: the kernel differs from it by its
    bf16 output rounding and fp32 sums in another order), and within the
    reference-order plain version's own distance from that function plus
    one bf16 ulp of its largest output (the plain version rounds the
    dequantized cells and p to bf16: the triangle inequality's bound).
    Returns (ok, err vs the function, err vs the plain version, that
    bound)."""
    e32 = (got.float() - want32).abs().max().item()
    ep = (got.float() - plain.float()).abs().max().item()
    gap = ((plain.float() - want32).abs().max().item()
           + 2.0 ** -8 * want32.abs().max().item())
    return e32 <= DECODE_TOL and ep <= gap, e32, ep, gap


def quant_bytes(b, h, h_kv, d, live, cell):
    """Bytes a paged decode call must move: q in and out (bf16), each live
    row's K and V cells once (``cell`` bytes each), a quantized pool's two
    fp32 scales a live row, the tables and lengths."""
    scales = 2 * live * 4 if cell == 1 else 0
    return (2 * b * h * d * 2 + 2 * live * h_kv * d * cell + scales
            + b * 8 * 4 + b * 4)


def phase_quant_decode_kernel(torch, dev):
    """The paged kernel's int8 and fp8 instances at the serve's shapes (8
    slots, MHA and GQA, block 128, d 128, 41 blocks, permuted tables,
    ragged lengths with a 0): each against its fp32 function and the
    reference-order plain version (``quant_rule``), bit-identical across
    two runs, length-0 slots zeros, every scale at 1 (a planted fault)
    refused; the plans with ptxas's registers and spills; times at 8 x
    512 and at the ragged mix in turns with the bf16 instance on the same
    rows (quant, bf16, bf16, quant), each with its bytes bound."""
    from apex_tpu_torch.ops import decode_attention as D

    ragged = [0, 1, 127, 128, 129, 300, 512, 1000]
    b, h, d = 8, 8, 128
    errs = {kv: 0.0 for kv in QUANT_KV}
    plans = {}
    for h_kv in (8, 2):
        (q, pk, pv, lens, tables), = decode_case(torch, dev, h_kv, ragged,
                                                 seed=h_kv + 20)
        q3 = q.reshape(b * h_kv, h // h_kv, d)
        for kv in QUANT_KV:
            kc, vc, ks, vs = quant_pools(torch, pk, pv, kv)
            kw = dict(block_tables=tables, k_scale=ks, v_scale=vs)
            got = D.decode_attention(q, kc, vc, lens, **kw)
            again = D.decode_attention(q, kc, vc, lens, **kw)
            plain = D.decode_attention(q, kc, vc, lens, impl="torch", **kw)
            want32 = D.quant_decode_fp32(q.float(), kc, vc, lens, tables,
                                         ks, vs)
            bad = D.paged_decode_attn_cuda(
                q3, kc, vc, lens, tables, scale=d ** -0.5, k_scale=ks,
                v_scale=vs, planted_fault="unit_scales").reshape(b, h, d)
            decode_repeat_check(torch, got, again, f"{kv} decode kernel")
            check(torch.isfinite(got.float()).all().item(),
                  f"{kv} decode kernel output not finite")
            check(not got[lens == 0].any().item(),
                  f"{kv} decode kernel: length-0 slot not zeros")
            ok, e32, ep, gap = quant_rule(got, plain, want32)
            bad_ok, bad32, badp, _ = quant_rule(bad, plain, want32)
            plans[f"{kv} h_kv={h_kv}"] = decode_plan_info(
                torch, q3, 8, 128, True, kv_dtype=kc.dtype)
            emit("quant_decode_check", {
                "kv_dtype": kv, "h_kv": h_kv, "lengths": ragged,
                "splits": plans[f"{kv} h_kv={h_kv}"]["splits"],
                "max_abs_err_vs_fp32_function": e32, "tol": DECODE_TOL,
                "max_abs_err_vs_plain": ep, "plain_tol": gap,
                "unit_scales_fault_err": [bad32, badp]})
            check(ok, f"{kv} decode kernel: err {e32} vs its fp32 function "
                  f"(tol {DECODE_TOL}), {ep} vs the plain version (tol "
                  f"{gap}), h_kv={h_kv}")
            check(not bad_ok, f"{kv} decode kernel: the rules let the "
                  f"planted unit-scales fault through")
            errs[kv] = max(errs[kv], e32)
    emit("decode_plan", {"kernel": "paged_decode_attn (int8, fp8)",
                         "plans": plans})

    kern_q = lambda q, kc, vc, ks, vs, n, t: D.decode_attention(  # noqa
        q, kc, vc, n, block_tables=t, k_scale=ks, v_scale=vs)
    kern_b = lambda q, pk, pv, n, t: D.decode_attention(  # noqa: E731
        q, pk, pv, n, block_tables=t)
    per = {kv: {} for kv in QUANT_KV}
    serve_sets = {}
    for what, lengths in (("serve_512", [512] * 8),
                          ("ragged", [330, 1000, 512, 640, 384, 896, 600,
                                      350])):
        sets = decode_case(torch, dev, 8, lengths, seed=3, copies=6)
        live = sum(lengths)
        bf_bound = bound(quant_bytes(b, h, 8, d, live, 2), 4 * live * h * d,
                         BF16_OPS_PER_S)
        for kv in QUANT_KV:
            qsets = [(q, *quant_pools(torch, pk, pv, kv), n, t)
                     for q, pk, pv, n, t in sets]
            turns = [time_ms(kern_q, qsets), time_ms(kern_b, sets),
                     time_ms(kern_b, sets), time_ms(kern_q, qsets)]
            bms, by = bound(quant_bytes(b, h, 8, d, live, 1),
                            4 * live * h * d, BF16_OPS_PER_S)
            per[kv][what] = {"lengths": lengths,
                             "ms": (turns[0] + turns[3]) / 2,
                             "bf16_ms": (turns[1] + turns[2]) / 2,
                             "turns_ms": turns, "bound_ms": bms,
                             "bound_by": by, "bf16_bound_ms": bf_bound[0]}
            emit("quant_decode_times", dict(per[kv][what], call=what,
                                            kv_dtype=kv))
            if what == "serve_512":
                serve_sets[kv] = qsets
            del qsets
        del sets
    torch.cuda.empty_cache()
    out = []
    for kv in QUANT_KV:
        plain = lambda q, kc, vc, ks, vs, n, t: D.decode_attention(  # noqa
            q, kc, vc, n, block_tables=t, k_scale=ks, v_scale=vs,
            impl="torch")
        serve = per[kv]["serve_512"]
        out.append({
            "name": QUANT_NAMES[kv], "route": "cuda",
            "source": "apex_tpu_torch/csrc/paged_decode_attn_quant.cu",
            "replaces": "apex_tpu/ops/pallas/decode_attention.py:211",
            "max_abs_err": errs[kv], "ms": serve["ms"],
            "bf16_ms": serve["bf16_ms"],
            "plain_ms": time_ms(plain, serve_sets[kv], reps=5),
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": None,
            "library_note": "no PyTorch call attends over 1-byte cells "
                            "with per-row scales",
            "kernel_note": "the paged body's instance for "
                           f"{kv} cells (the body in paged_decode_attn.cu); "
                           "max_abs_err against its fp32 function; bf16_ms: "
                           "the bf16 instance on the same rows, in turns",
            "timed_shape": {"slots": b, "heads": h, "kv_heads": 8,
                            "head_dim": d, "block": 128,
                            "live_rows_per_slot": 512, "cells": kv},
            "plan": plans[f"{kv} h_kv=8"], "per_shape": per[kv]})
    del serve_sets
    torch.cuda.empty_cache()
    return out


def rel_table(torch, dev, h, std=1.0):
    g = torch.Generator(device=dev).manual_seed(REL_SEED)
    return torch.randn((REL_BUCKETS, h), generator=g, device=dev) * std


def causal_rel_bias(table):
    from apex_tpu_torch.ops.attention import BucketedBias

    return BucketedBias(table, bidirectional=False,
                        max_distance=REL_MAX_DISTANCE)


def rel_checks(torch, D, q, k, v, lens, bias, kw, what):
    """One biased decode call: the kernel against the plain version with
    the bias (DECODE_TOL), bit-identical across two runs, length-0 rows
    zeros, and a zero table (the bias left out) refused. Returns the
    error."""
    got = D.decode_attention(q, k, v, lens, bias=bias, **kw)
    again = D.decode_attention(q, k, v, lens, bias=bias, **kw)
    want = D.decode_attention(q, k, v, lens, bias=bias, impl="torch", **kw)
    zero = D.decode_attention(q, k, v, lens, bias=causal_rel_bias(
        torch.zeros_like(bias.table)), **kw)
    decode_repeat_check(torch, got, again, f"{what} biased decode kernel")
    e = (got.float() - want.float()).abs().max().item()
    ez = (zero.float() - want.float()).abs().max().item()
    check(torch.isfinite(got.float()).all().item(),
          f"{what} biased decode kernel output not finite")
    check(not got[lens == 0].any().item(),
          f"{what} biased decode kernel: length-0 row not zeros")
    emit("rel_decode_check", {"call": what, "max_abs_err": e,
                              "tol": DECODE_TOL, "zero_table_err": ez})
    check(e <= DECODE_TOL, f"{what} biased decode kernel vs plain: max abs "
          f"err {e} > {DECODE_TOL}")
    check(ez > DECODE_TOL, f"{what}: the rule let a zero table through")
    return e


def rel_library(torch, D, F, bias, q, k, v, lens):
    """SDPA with the bias and the length mask folded into one float mask
    (the plain version's bias), on a contiguous cache (b, h_kv, s, d)."""
    b, h, d = q.shape
    h_kv, max_s = k.shape[1], k.shape[2]
    fm = D._bias_scores(bias, lens, h_kv, h // h_kv, max_s).reshape(
        b, h, 1, max_s)
    live = (torch.arange(max_s, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    fm = fm.masked_fill(~live, float("-inf")).to(q.dtype)
    kk = k.repeat_interleave(h // h_kv, 1)
    vv = v.repeat_interleave(h // h_kv, 1)
    return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv,
                                          attn_mask=fm)


def phase_rel_decode_kernel(torch, dev):
    """Both decode kernels' bias instances with a seeded causal table (32
    buckets, max distance 128, 8 heads): the paged one at the serve's
    shapes (MHA and GQA, ragged lengths with 0), the contiguous one at the
    decode leg's (16 x 8 rows, max_s 1024, ragged, and GQA) (``rel_checks``;
    the plans with ptxas's registers and spills); times at 8 x 512 (paged)
    and 16 x 640 (contiguous) in turns with the unbiased instance, each
    with its bound, and SDPA with the bias as a float mask."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import decode_attention as D

    b, h, d = 8, 8, 128
    bias = causal_rel_bias(rel_table(torch, dev, h))
    ragged = [0, 1, 127, 128, 129, 300, 512, 1000]
    errs, plans = {"paged": 0.0, "contig": 0.0}, {}
    for h_kv in (8, 2):
        (q, pk, pv, lens, tables), = decode_case(torch, dev, h_kv, ragged,
                                                 seed=h_kv + 30)
        errs["paged"] = max(errs["paged"], rel_checks(
            torch, D, q, pk, pv, lens, bias, dict(block_tables=tables),
            f"paged h_kv={h_kv}"))
        plans[f"paged h_kv={h_kv}"] = decode_plan_info(
            torch, q.reshape(b * h_kv, h // h_kv, d), 8, 128, True,
            maxd=REL_MAX_DISTANCE)
    B, max_s = DECODE_BATCH, 1024
    c_ragged = ([0, 1, 127, 128, 129, 300, 512, 513, 600, 640, 700, 900,
                 1000, 1023, 1024, 2] * B)[:B]

    def ccase(h_kv, lengths, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((B, h, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, h_kv, max_s, d), generator=g,
                        device=dev).bfloat16()
        v = torch.randn((B, h_kv, max_s, d), generator=g,
                        device=dev).bfloat16()
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    for h_kv in (8, 2):
        q, k, v, lens = ccase(h_kv, c_ragged, seed=h_kv + 35)
        errs["contig"] = max(errs["contig"], rel_checks(
            torch, D, q, k, v, lens, bias, {}, f"contiguous h_kv={h_kv}"))
        plans[f"contig h_kv={h_kv}"] = decode_plan_info(
            torch, q.reshape(B * h_kv, h // h_kv, d), max_s // 128, 128,
            False, maxd=REL_MAX_DISTANCE)
    emit("decode_plan", {"kernel": "decode_attn and paged_decode_attn "
                         "(bias)", "plans": plans})

    lut_bytes = h * (2 * REL_MAX_DISTANCE + 1) * 4
    out = []
    for name, kind in (("paged_decode_attn_rel", "paged"),
                       ("decode_attn_rel", "contig")):
        if kind == "paged":
            sets = decode_case(torch, dev, 8, [512] * 8, seed=3, copies=6)
            live, bb = 512 * 8, b
            kw_of = lambda s: dict(block_tables=s[4])  # noqa: E731
            lib_sets = [(q, D._gather_blocks(pk, t), D._gather_blocks(pv, t),
                         n) for q, pk, pv, n, t in sets[:2]]
        else:
            L = DECODE_PROMPT + DECODE_NEW
            sets = [ccase(8, [L] * B, seed=50 + i) + (None,)
                    for i in range(2)]
            live, bb = L * B, B
            kw_of = lambda s: {}  # noqa: E731
            lib_sets = [s[:4] for s in sets]

        def biased(*s, kw_of=kw_of):
            return D.decode_attention(*s[:4], bias=bias, **kw_of(s))

        def unbiased(*s, kw_of=kw_of):
            return D.decode_attention(*s[:4], **kw_of(s))

        def plain(*s, kw_of=kw_of):
            return D.decode_attention(*s[:4], bias=bias, impl="torch",
                                      **kw_of(s))
        turns = [time_ms(biased, sets), time_ms(unbiased, sets),
                 time_ms(unbiased, sets), time_ms(biased, sets)]
        bms, by = bound(quant_bytes(bb, h, 8, d, live, 2) + lut_bytes,
                        4 * live * h * d, BF16_OPS_PER_S)
        lib_ms = time_ms(lambda q, k, v, n: rel_library(
            torch, D, F, bias, q, k, v, n), lib_sets, reps=5)
        entry = {"name": name, "route": "cuda",
                 "source": "apex_tpu_torch/csrc/paged_decode_attn_rel.cu",
                 "replaces": ("apex_tpu/ops/pallas/decode_attention.py:211"
                              if kind == "paged" else
                              "apex_tpu/ops/pallas/decode_attention.py:149"),
                 "max_abs_err": errs[kind],
                 "ms": (turns[0] + turns[3]) / 2,
                 "unbiased_ms": (turns[1] + turns[2]) / 2,
                 "turns_ms": turns,
                 "plain_ms": time_ms(plain, sets, reps=5),
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                 "library_note": "F.scaled_dot_product_attention with the "
                                 "bias and the length mask as one float "
                                 "mask" + (", on the gathered cache"
                                           if kind == "paged" else ""),
                 "kernel_note": "the body's causal bucketed-bias instance "
                                "(32 buckets, max distance 128, a lookup "
                                "in shared memory); unbiased_ms: the "
                                "unbiased instance on the same rows, in "
                                "turns",
                 "timed_shape": {"rows": bb, "heads": h, "kv_heads": 8,
                                 "head_dim": d,
                                 "live_rows_per_row": live // bb},
                 "plan": plans[f"{kind} h_kv=8"]}
        emit("rel_decode_times", {k_: entry[k_] for k_ in (
            "name", "ms", "unbiased_ms", "turns_ms", "bound_ms",
            "library_ms")})
        out.append(entry)
        del sets, lib_sets
        torch.cuda.empty_cache()
    return out


def quant_serve_run(torch, model, params, dev, kv, draft=None):
    """One greedy serve of the whole trace with a ``kv`` pool, its paged
    decode counters zeroed just before and read just after: 12 launches
    of the quantized instance per plain decode step and none of another,
    exact accounting at drain. Returns (tokens by rid, info, launches)."""
    from apex_tpu_torch.ops import decode_attention as D
    from apex_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, device=dev, kv_dtype=kv, **ENGINE)
    sched = eng.make_scheduler()
    reqs = build_trace()
    fn = D.paged_decode_attn_cuda
    torch.cuda.synchronize()
    fn.launches = fn.int8_launches = fn.fp8_launches = fn.rel_launches = 0
    t0 = time.perf_counter()
    done = eng.serve(params, reqs, scheduler=sched, draft=draft)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attn": fn.launches,
                "paged_decode_attn_int8": fn.int8_launches,
                "paged_decode_attn_fp8": fn.fp8_launches}
    check(len(done) == len(reqs), f"{kv} serve lost requests")
    for r in done:
        check(len(r.tokens) == r.max_new_tokens
              and all(0 <= t < MODEL["vocab_size"] for t in r.tokens),
              f"{kv} serve: request {r.rid} bad tokens")
    sched.allocator.check_accounting()
    check(sched.allocator.num_live == sched.allocator.num_resident,
          f"{kv} serve: blocks live beyond the prefix cache's residents "
          f"after drain")
    st = eng.last_stats
    L = MODEL["num_layers"]
    plain = st.decode_steps - st.spec_rounds
    mine = QUANT_NAMES[kv]
    check(launches["paged_decode_attn"] == launches[mine] == L * plain
          and fn.rel_launches == 0,
          f"{kv} serve: {launches} paged decode launches for {plain} plain "
          f"steps x {L} layers")
    n_tok = sum(len(r.tokens) for r in done)
    info = {"kv_dtype": kv, "requests": len(done), "tokens": n_tok,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "decode_steps": st.decode_steps, "plain_steps": plain,
            "spec_rounds": st.spec_rounds,
            "prefill_chunks": st.prefill_chunks,
            "decode_step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
            "preemptions": sched.preemptions,
            "prefix_hit_blocks": sum(r.prefix_hit_blocks for r in done),
            "pool_bytes": eng.pool_bytes(), "launches": launches,
            "launches_per_plain_step": launches[mine] / max(plain, 1)}
    return {r.rid: list(r.tokens) for r in done}, info, launches


def teacher_forced_logits(torch, engine, params, dev, prompt, n, forced):
    """One request through ``engine``'s own steps (prefill chunks, then
    n - 1 decode steps), each step's sampled token replaced by
    ``forced[t]`` where given: (logits (n - 1, V) fp32, the tokens)."""
    from apex_tpu_torch.serving.scheduler import Request

    sched = engine.make_scheduler()
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=n))
    sched.admit(0.0)
    pool = engine.init_pool()
    as_dev = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    while True:
        w = sched.next_prefill(0.0)
        if w is None:
            break
        tok, _ = engine.prefill_chunk(params, pool,
                                      as_dev(sched.tables.row(w.slot)),
                                      as_dev(w.tokens), w.start, w.live)
        sched.note_prefill(w, int(tok), 0.0)
    rows, toks = [], []
    for t in range(n - 1):
        batch = sched.decode_batch(0.0)
        if batch is None:
            break
        tk, lens = batch
        sampled, logits = engine.decode_step(
            params, pool, as_dev(sched.tables.asarray()), as_dev(tk),
            as_dev(lens))
        sampled = sampled.cpu().numpy().copy()
        if forced is not None:
            sampled[0] = forced[t]
        rows.append(logits[0].float())
        toks.append(int(sampled[0]))
        sched.note_decode(sampled, 0.0)
    return torch.stack(rows), toks


def phase_quant_serve(torch, model, params, dev, float_toks):
    """The serve's GPT-medium, ENGINE and trace with a quantized pool:
    greedy with kv_dtype="int8", then "fp8_e4m3" (``quant_serve_run``):
    tokens/s, launches, pool_bytes beside the float pool's, the share of
    requests token-identical to the float pool's greedy serve
    (``float_toks``, the main path's); the teacher-forced
    max |logit difference| against the float pool over 32 tokens (one
    request, its prompt halved: bench.py::_spec_quant_err); an int8 serve
    with the n-gram chain drafter, whose tokens must equal the int8 plain
    serve's or leave them only at a near-tie (``spec_near_ties``).
    Returns (info, launches)."""
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.spec import NGramDrafter

    float_eng = ServingEngine(model, device=dev, **ENGINE)
    info, totals = {"float_pool_bytes": float_eng.pool_bytes()}, {}
    plain_by_kv = {}
    for kv in QUANT_KV:
        toks, inf, launches = quant_serve_run(torch, model, params, dev, kv)
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
        inf["share_of_requests_identical_to_float_pool"] = sum(
            toks[r] == float_toks[r] for r in toks) / len(toks)
        inf["pool_bytes_over_float"] = inf["pool_bytes"] / info[
            "float_pool_bytes"]
        check(inf["pool_bytes"] < 0.6 * info["float_pool_bytes"],
              f"{kv} pool_bytes {inf['pool_bytes']} not about half the "
              f"float pool's {info['float_pool_bytes']}")
        info[kv] = inf
        plain_by_kv[kv] = toks
        torch.cuda.empty_cache()
    req = build_trace()[0]
    prompt = np.asarray(req.prompt[:max(len(req.prompt) // 2, 4)], np.int32)
    oracle, forced = teacher_forced_logits(torch, float_eng, params, dev,
                                           prompt, QUANT_ERR_TOKENS, None)
    for kv in QUANT_KV:
        q_eng = ServingEngine(model, device=dev, kv_dtype=kv, **ENGINE)
        got, _ = teacher_forced_logits(torch, q_eng, params, dev, prompt,
                                       QUANT_ERR_TOKENS, forced)
        err = (got - oracle).abs().max().item()
        check(np.isfinite(err), f"{kv} teacher-forced logits not finite")
        info[kv]["logit_err"] = {
            "max_abs": err, "tokens": QUANT_ERR_TOKENS,
            "oracle_max_abs_logit": oracle.abs().max().item(),
            "top1_agreement": float((got.argmax(-1) == oracle.argmax(
                -1)).float().mean())}
    emit("quant_logit_err", {kv: info[kv]["logit_err"] for kv in QUANT_KV})
    spec, s_inf, s_launch = quant_serve_run(torch, model, params, dev,
                                            "int8",
                                            draft=NGramDrafter(SPEC_K))
    for k, n in s_launch.items():
        totals[k] = totals.get(k, 0) + n
    check(s_inf["spec_rounds"] > 0, "int8 spec serve: no round ran")
    s_inf["vs_int8_plain"] = spec_near_ties(
        torch, model, params, build_trace(), spec, plain_by_kv["int8"],
        "int8 chain")
    info["int8_spec_chain"] = s_inf
    del float_eng
    torch.cuda.empty_cache()
    return info, totals


def rel_gpt(torch, model, dev):
    """GPT-medium with a ``decode_rel_bias`` hook: the seeded causal table
    (32 buckets, max distance 128, a column a head)."""
    from apex_tpu_torch.models.gpt import GPTModel

    class RelGPT(GPTModel):
        def decode_rel_bias(self, params):
            return causal_rel_bias(self.table)

    m = RelGPT(model.config)
    m.table = rel_table(torch, dev, model.config.num_heads)
    return m


def decode_forced_logits(torch, eng, params, prompt, steps):
    """The prefill's logits, then ``steps`` decode steps' (each fed the
    greedy token of the first engine's run: teacher-forced), (steps + 1,
    b, V) fp32, and those tokens."""
    cache, tok, lg = eng.prefill(params, prompt)
    rows, toks = [lg.float()], [tok]
    for t in range(steps):
        cache, tok, lg = eng.decode_step(params, cache, toks[-1],
                                         prompt.shape[1] + t)
        rows.append(lg.float())
        toks.append(tok)
    return torch.stack(rows), toks


def phase_rel_decode(torch, model, params, dev):
    """GPT-medium with a ``decode_rel_bias`` hook (``rel_gpt``), on the
    serve's weights: a) DecodeEngine at the decode leg's shape (16 x 512,
    128 new tokens, greedy) with the contiguous kernel's launches counted
    (12 biased launches per step); its logits over REL_LOGIT_STEPS
    teacher-forced steps held against impl="torch" on the same card: the
    biased model's kernel-vs-plain gap at most twice the unbiased model's
    plus DECODE_TOL, and below the bias's own effect; b) a greedy serve of
    the trace (12 biased paged launches per decode step), and one serve
    decode step on a seeded pool against impl="torch" by the same rule.
    Returns (info, launches)."""
    from apex_tpu_torch.inference import DecodeEngine
    from apex_tpu_torch.ops import decode_attention as D
    from apex_tpu_torch.serving.engine import ServingEngine

    rmodel = rel_gpt(torch, model, dev)
    L = MODEL["num_layers"]
    prompt = decode_prompt(torch, dev)
    info = {}
    eng = DecodeEngine(rmodel, device=dev)
    eng.generate(params, prompt[:, :DECODE_PROMPT], 2)  # warm-up
    c = D.decode_attn_cuda
    torch.cuda.synchronize()
    c.launches = c.rel_launches = 0
    t0 = time.perf_counter()
    out = eng.generate(params, prompt, DECODE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = DECODE_NEW - 1
    check(c.launches == c.rel_launches == L * steps,
          f"rel decode: {c.launches} decode_attn launches ({c.rel_launches} "
          f"biased) for {steps} steps x {L} layers")
    check(((out >= 0) & (out < MODEL["vocab_size"])).all().item(),
          "rel decode produced a token outside the vocabulary")
    launches = {"decode_attn": c.launches, "decode_attn_rel": c.rel_launches}
    info["decode_engine"] = {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
                             "new_tokens": DECODE_NEW, "wall_s": wall,
                             "tokens_per_s": DECODE_BATCH * DECODE_NEW / wall,
                             "launches": dict(launches)}
    gaps = {}
    for what, m in (("biased", rmodel), ("unbiased", model)):
        k_rows, toks = decode_forced_logits(
            torch, DecodeEngine(m, device=dev), params, prompt,
            REL_LOGIT_STEPS)
        p_eng = DecodeEngine(m, device=dev, impl="torch")
        cache, _, lg = p_eng.prefill(params, prompt)
        p_rows = [lg.float()]
        for t in range(REL_LOGIT_STEPS):
            cache, _, lg = p_eng.decode_step(params, cache, toks[t],
                                             DECODE_PROMPT + t)
            p_rows.append(lg.float())
        gaps[what] = (k_rows - torch.stack(p_rows)).abs().max().item()
        if what == "biased":
            biased_rows = k_rows
        else:
            gaps["bias_effect"] = (biased_rows - k_rows).abs().max().item()
        del cache, p_eng
        torch.cuda.empty_cache()
    info["decode_engine"]["logit_gaps"] = gaps
    check(gaps["biased"] <= 2 * gaps["unbiased"] + DECODE_TOL
          and gaps["biased"] < gaps["bias_effect"],
          f"rel decode: kernel-vs-plain logit gaps {gaps}")

    s_eng = ServingEngine(rmodel, device=dev, **ENGINE)
    p = D.paged_decode_attn_cuda
    torch.cuda.synchronize()
    p.launches = p.rel_launches = 0
    t0 = time.perf_counter()
    done = s_eng.serve(params, build_trace())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = s_eng.last_stats
    check(p.launches == p.rel_launches == L * st.decode_steps,
          f"rel serve: {p.launches} paged launches ({p.rel_launches} "
          f"biased) for {st.decode_steps} steps x {L} layers")
    launches.update(paged_decode_attn=p.launches,
                    paged_decode_attn_rel=p.rel_launches)
    n_tok = sum(len(r.tokens) for r in done)
    info["serve"] = {"tokens": n_tok, "wall_s": wall,
                     "tokens_per_s": n_tok / wall,
                     "decode_steps": st.decode_steps,
                     "launches": {"paged_decode_attn": p.launches,
                                  "paged_decode_attn_rel": p.rel_launches}}

    (q, pk, pv, lens, tables), = decode_case(torch, dev, 8, [0, 1, 127, 128,
                                                             129, 300, 512,
                                                             1000], seed=77)
    g = torch.Generator(device=dev).manual_seed(78)
    tokens = torch.randint(0, MODEL["vocab_size"], (8,), generator=g,
                           device=dev, dtype=torch.int32)
    cfg = model.config
    shape = (L, ENGINE["num_blocks"], cfg.kv_heads, ENGINE["block_size"],
             cfg.head_dim)
    base = torch.randn(shape, generator=g, device=dev).bfloat16()
    del q, pk, pv
    step_gaps = {}
    for what, m in (("biased", rmodel), ("unbiased", model)):
        rows = []
        for impl in ("auto", "torch"):
            e = ServingEngine(m, device=dev, impl=impl, **ENGINE)
            pool = {"k": base.clone(), "v": base.flip(0).clone()}
            _, lg = e.decode_step(params, pool, tables, tokens, lens)
            rows.append(lg.float())
        step_gaps[what] = (rows[0] - rows[1]).abs().max().item()
        if what == "biased":
            b_row = rows[0]
        else:
            step_gaps["bias_effect"] = (b_row - rows[0]).abs().max().item()
    info["serve"]["decode_step_logit_gaps"] = step_gaps
    check(step_gaps["biased"] <= 2 * step_gaps["unbiased"] + DECODE_TOL
          and step_gaps["biased"] < step_gaps["bias_effect"],
          f"rel serve step: kernel-vs-plain logit gaps {step_gaps}")
    del s_eng, base
    torch.cuda.empty_cache()
    return info, launches


# --- serving telemetry, weight hot-swap, the encoder entry -------------------

# the serve cell's telemetry: the reference's window period, the slot count
TEL_WINDOW_S = 0.5
TEL_SPANS = ("serve_prefill", "serve_decode")
# the reference's per-step hook budget (tests/test_serve_telemetry.py:
# 324-366): passes of TEL_HOOK_ITERS iterations, the min of TEL_HOOK_PASSES
TEL_HOOK_ITERS, TEL_HOOK_PASSES, TEL_BUDGET = 1000, 3, 0.01
# the profiled window of the telemetry serve: dispatch 0 warms the
# profiler, dispatches 1..TEL_PROFILE_DISPATCHES are traced
TEL_PROFILE_DISPATCHES = 40
# the dispatch (prefill chunk or decode step) a hot-swap waits for, and the
# seeded perturbation of the swapped-in weights (std a leaf, times 0.02)
SWAP_STEP, SWAP_SEED, SWAP_STD = 60, 13, 0.02
ENCODER_CALLS = 10      # timed jit_encoder calls at BERT-large's 32 x 512


def tel_serve_run(torch, model, params, dev, what, *, telemetry,
                  gen_seed=None, on_dispatch=None):
    """One serve of the trace (greedy, or sampled at SAMPLED from
    ``gen_seed``) with ``telemetry``, the serve's kernel counters zeroed
    just before and read just after: 12 paged-decode launches a decode
    step, 25 ln_fwd a decode step or prefill chunk, one sampling launch
    each when sampled (none greedy), no verify launch; exact accounting
    at drain. ``on_dispatch(name)`` is called after each prefill chunk
    and decode step. Returns (tokens by rid, info, launches, scheduler)."""
    from apex_tpu_torch.serving.engine import ServingEngine

    knobs = SAMPLED if gen_seed is not None else {}
    eng = ServingEngine(model, device=dev, **ENGINE, **knobs)
    if on_dispatch is not None:
        for name in ("prefill_chunk", "decode_step"):
            def hooked(*a, _real=getattr(eng, name), _name=name, **k):
                out = _real(*a, **k)
                on_dispatch(_name)
                return out

            setattr(eng, name, hooked)
    sched = eng.make_scheduler()
    reqs = build_trace()
    gen = (None if gen_seed is None
           else torch.Generator(device=dev).manual_seed(gen_seed))
    counters = spec_serve_counters()
    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    done = eng.serve(params, reqs, scheduler=sched, generator=gen,
                     telemetry=telemetry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    check(len(done) == len(reqs), f"{what}: the serve lost requests")
    for r in done:
        check(len(r.tokens) == r.max_new_tokens
              and all(0 <= t < MODEL["vocab_size"] for t in r.tokens),
              f"{what}: request {r.rid} bad tokens")
    sched.allocator.check_accounting()
    check(sched.allocator.num_live == sched.allocator.num_resident,
          f"{what}: blocks live beyond the prefix cache's residents at "
          f"drain")
    st = eng.last_stats
    L = MODEL["num_layers"]
    forwards = st.decode_steps + st.prefill_chunks
    want = {"paged_decode_attn": L * st.decode_steps,
            "ln_fwd": (2 * L + 1) * forwards,
            "fused_sample": forwards if gen_seed is not None else 0}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"{what}: launches {launches}, want {want} ({st.decode_steps} "
          f"decode steps, {st.prefill_chunks} prefill chunks)")
    n_tok = sum(len(r.tokens) for r in done)
    info = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "decode_steps": st.decode_steps,
            "prefill_chunks": st.prefill_chunks,
            "decode_step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
            "prefill_chunk_ms": 1e3 * st.prefill_s / max(st.prefill_chunks,
                                                         1),
            "preemptions": sched.preemptions,
            "launches_per_decode_step": {
                k: launches[k] / max(st.decode_steps, 1)
                for k in ("paged_decode_attn",)},
            "launches": {k: v for k, v in launches.items() if v}}
    return {r.rid: list(r.tokens) for r in done}, info, launches, sched


def tel_spec_run(torch, model, params, dev, telemetry, path=None):
    """One greedy serve of the trace drafted by NGramTreeDrafter(SPEC_K,
    2) (tree rounds, chain rounds near the row cap) with ``telemetry``
    (and the registry writing ``path`` when given), the counters zeroed
    just before and read just after: one fused_verify_tree launch a tree
    round, one fused_verify a chain round, exact accounting at drain.
    Returns (tokens by rid, stats, launches, records)."""
    from apex_tpu_torch import monitor
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.spec import NGramTreeDrafter

    eng = ServingEngine(model, device=dev, **ENGINE)
    sched = eng.make_scheduler()
    reqs = build_trace()
    counters = spec_serve_counters()
    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    if path is not None:
        monitor.enable(path)
    try:
        done = eng.serve(params, reqs, scheduler=sched, telemetry=telemetry,
                         draft=NGramTreeDrafter(depth=SPEC_K, branching=2))
    finally:
        monitor.disable()
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    st = eng.last_stats
    check(len(done) == len(reqs) and st.tree_rounds > 0
          and launches["fused_verify_tree"] == st.tree_rounds
          and launches["fused_verify"] == st.spec_rounds - st.tree_rounds,
          f"spec serve with telemetry {telemetry is not False}: "
          f"{st.tree_rounds} tree and {st.spec_rounds} rounds, launches "
          f"{launches}")
    sched.allocator.check_accounting()
    records = []
    if path is not None:
        with open(path) as fh:
            records = [json.loads(ln) for ln in fh]
    return {r.rid: list(r.tokens) for r in done}, st, launches, records


def finite_numbers(obj):
    """Every number inside ``obj`` (dicts, lists) is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    if isinstance(obj, float):
        return obj == obj and abs(obj) != float("inf")
    return True


def tel_stream_checks(records, n_req):
    """The telemetry serve's JSONL stream: every request's submit → admit
    → first_token → finish in order under one trace id, at least one
    serve_window, every status-carrying record OK and finite."""
    by_rid, ids = {}, {}
    for r in records:
        check(finite_numbers(r), f"telemetry record with a non-finite "
              f"number: {r}")
        if "status" in r:
            check(r["status"] == "OK", f"telemetry record not OK: {r}")
        if r.get("kind") == "serve_event" and r["rid"] >= 0:
            by_rid.setdefault(r["rid"], []).append(r["phase"])
            ids.setdefault(r["rid"], set()).add(r.get("trace_id"))
    check(len(by_rid) == n_req, f"{len(by_rid)} requests in the stream "
          f"of {n_req}")
    for rid, phases in by_rid.items():
        seen = [p for p in phases
                if p in ("submit", "admit", "first_token", "finish")]
        firsts = [seen.index(p) for p in ("submit", "admit", "first_token",
                                          "finish")
                  if p in seen]
        check(len(firsts) == 4 and firsts == sorted(firsts)
              and seen[-1] == "finish",
              f"request {rid}: lifecycle {phases}")
        check(len(ids[rid]) == 1 and None not in ids[rid],
              f"request {rid}: trace ids {ids[rid]}")
    check(len(set().union(*ids.values())) == n_req,
          "two requests share a trace id")
    windows = [r for r in records if r.get("kind") == "serve_window"]
    check(len(windows) >= 1, "no serve_window record")
    return {"records": len(records), "serve_windows": len(windows),
            "phases": sorted({p for ph in by_rid.values() for p in ph}),
            "spans": sorted({r["name"] for r in records
                             if r.get("kind") == "span"})}


def tel_hook_budget(torch, sched, step_ms):
    """The reference's per-step hook budget: the min over passes of one
    on_decode_step, one observe_itl a live slot and one maybe_window (no
    sink), against the leg's measured decode step."""
    from apex_tpu_torch.serving.telemetry import ServeTelemetry

    tel = ServeTelemetry(slots=ENGINE["num_slots"], window_s=TEL_WINDOW_S)
    slots = ENGINE["num_slots"]

    def hook_pass(base):
        t0 = time.perf_counter()
        for i in range(base, base + TEL_HOOK_ITERS):
            for _ in range(slots):
                tel.observe_itl(0.001)
            tel.on_decode_step(0.001, slots, i, i * 0.001)
            tel.maybe_window(i * 0.001, sched)
        return (time.perf_counter() - t0) / TEL_HOOK_ITERS

    hook_pass(0)
    per_step = min(hook_pass((p + 1) * TEL_HOOK_ITERS)
                   for p in range(TEL_HOOK_PASSES))
    share = per_step * 1e3 / step_ms
    check(share < TEL_BUDGET, f"per-step telemetry {per_step * 1e6:.1f} us "
          f"is {share:.4%} of a {step_ms:.3f} ms decode step (budget "
          f"{TEL_BUDGET:.0%})")
    return {"per_step_us": per_step * 1e6, "decode_step_ms": step_ms,
            "share_of_decode_step": share, "budget": TEL_BUDGET}


def tel_profile(torch, model, params, dev):
    """One telemetry serve with the registry on, dispatches 1 to
    TEL_PROFILE_DISPATCHES traced by torch.profiler (dispatch 0 warms it;
    the device drains before the window closes): the host ms and the
    device ms under each serve_* range (the range's kernels, through the
    profiler's CPU-op tree; and the range's own device-side annotation
    where the profiler records one), and the share of the window's wall
    time each covers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from apex_tpu_torch import monitor
    from apex_tpu_torch.serving.telemetry import ServeTelemetry

    n = TEL_PROFILE_DISPATCHES
    kinds, window = [], {}

    def on_dispatch(name):
        kinds.append(name)
        if len(kinds) == 1:
            window["t0"] = time.perf_counter()
        elif len(kinds) == n + 1:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
        prof.step()

    monitor.enable()  # no sink: the spans need the registry, not a file
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n,
                                       repeat=1)) as prof:
            tel_serve_run(torch, model, params, dev,
                          "profiled telemetry serve",
                          telemetry=ServeTelemetry(slots=ENGINE["num_slots"],
                                                   window_s=TEL_WINDOW_S),
                          on_dispatch=on_dispatch)
    finally:
        monitor.disable()
    check(len(kinds) > n, f"profiled serve: {len(kinds)} dispatches, "
          f"fewer than the window's {n + 1}")
    traced = kinds[1:n + 1]
    want = {"serve_prefill": traced.count("prefill_chunk"),
            "serve_decode": traced.count("decode_step")}
    wall_ms = (window["t1"] - window["t0"]) * 1e3
    ranges = {r: {"count": 0, "host_ms": 0.0, "device_ms": 0.0}
              for r in TEL_SPANS}
    for e in prof.events():
        if e.name in ranges and e.device_type == DeviceType.CPU:
            r = ranges[e.name]
            r["count"] += 1
            r["host_ms"] += e.cpu_time_total / 1e3
            r["device_ms"] += e.device_time_total / 1e3
    kernels_ms = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key in ranges:
            ranges[e.key]["annotation_device_ms"] = \
                e.device_time_total / 1e3
        else:
            kernels_ms += e.self_device_time_total / 1e3
    for r in ranges.values():
        r["host_share_of_wall"] = r["host_ms"] / wall_ms
        r["device_share_of_wall"] = r["device_ms"] / wall_ms
    check(all(want[r] > 0 and ranges[r]["count"] == want[r]
              for r in TEL_SPANS),
          f"profiled serve: ranges {ranges} for the traced dispatches "
          f"{want}")
    return {"dispatches": want, "wall_ms": wall_ms,
            "device_kernels_ms": kernels_ms,
            "device_busy_share": kernels_ms / wall_ms,
            "ranges_device_share_of_kernels":
                sum(r["device_ms"] for r in ranges.values())
                / max(kernels_ms, 1e-9),
            "ranges": ranges}


def phase_serve_telemetry(torch, model, params, dev):
    """The serve cell, greedy, in turns without telemetry
    (``telemetry=False``, the registry off), with a
    ``ServeTelemetry(slots=8, window_s=0.5)`` attached while the registry
    writes a JSONL file, twice each in ABBA order: the same tokens and the
    same launches both ways; the stream's lifecycle, trace ids, windows
    and honesty; then sampled (one generator seed) both ways; the
    reference's per-step hook budget; a window of one telemetry serve
    profiled by range. Returns (info, launches of the telemetry runs)."""
    import tempfile

    from apex_tpu_torch import monitor
    from apex_tpu_torch.serving.telemetry import ServeTelemetry

    t_leg = time.perf_counter()
    info = {"runs": []}
    tokens, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # ABBA: a linear drift of the host's speed over the leg falls
        # alike on each mode's mean
        for turn, mode in enumerate(("off", "on", "on", "off")):
            what = f"telemetry {mode} (turn {turn})"
            on = mode == "on"
            tel = (ServeTelemetry(slots=ENGINE["num_slots"],
                                  window_s=TEL_WINDOW_S) if on else False)
            path = os.path.join(tmp, f"serve{turn}.jsonl")
            if on:
                monitor.enable(path)
            try:
                toks, run, counts, sched = tel_serve_run(
                    torch, model, params, dev, what, telemetry=tel)
            finally:
                monitor.disable()
            run["telemetry"] = mode
            if on:
                with open(path) as fh:
                    records = [json.loads(ln) for ln in fh]
                run["stream"] = tel_stream_checks(records, len(toks))
                run["overhead_s"] = tel.overhead_s
                run["overhead_share_of_wall"] = tel.overhead_s / run["wall_s"]
                run["windows"] = tel.windows_emitted
                check(tel.finished == len(toks) and tel.leaked_blocks == 0,
                      f"{what}: tracker finished {tel.finished}, leaked "
                      f"{tel.leaked_blocks}")
            info["runs"].append(run)
            tokens[turn] = toks
            launches[turn] = counts
    check(all(tokens[t] == tokens[0] for t in tokens),
          "serve_telemetry: tokens differ with telemetry on and off")
    check(all(launches[t] == launches[0] for t in launches),
          f"serve_telemetry: launches differ with telemetry on and off: "
          f"{launches}")
    sampled = {}
    for on in (False, True):
        tel = (ServeTelemetry(slots=ENGINE["num_slots"],
                              window_s=TEL_WINDOW_S) if on else False)
        sampled[on] = tel_serve_run(torch, model, params, dev,
                                    f"sampled, telemetry {on}",
                                    telemetry=tel, gen_seed=21)
    check(sampled[True][0] == sampled[False][0]
          and sampled[True][2] == sampled[False][2],
          "serve_telemetry: the sampled serve's tokens or launches differ "
          "with telemetry on and off")
    info["sampled"] = {k: {"tokens_per_s": v[1]["tokens_per_s"],
                           "launches": v[1]["launches"]}
                       for k, v in (("off", sampled[False]),
                                    ("on", sampled[True]))}
    # speculative serving with telemetry: the spec lifecycle records and
    # the serve_spec/serve_spec_tree spans, the verify launches unchanged
    with tempfile.TemporaryDirectory() as tmp:
        spec_off = tel_spec_run(torch, model, params, dev, False)
        tel = ServeTelemetry(slots=ENGINE["num_slots"], window_s=TEL_WINDOW_S)
        spec_on = tel_spec_run(torch, model, params, dev, tel,
                               os.path.join(tmp, "spec.jsonl"))
    check(spec_on[0] == spec_off[0] and spec_on[2] == spec_off[2],
          "serve_telemetry: the spec serve's tokens or launches differ with "
          "telemetry on and off")
    st, records = spec_on[1], spec_on[3]
    spec_events = [r for r in records if r.get("kind") == "serve_event"
                   and r.get("phase") == "spec"]
    spans = {r["name"] for r in records if r.get("kind") == "span"}
    check(len(spec_events) == st.spec_slot_rounds == tel.spec_slot_rounds
          and tel.spec_tree_rounds > 0 and "serve_spec_tree" in spans
          and ("serve_spec" in spans) == (st.spec_rounds > st.tree_rounds)
          and all(finite_numbers(r) and r.get("status", "OK") == "OK"
                  for r in records),
          f"serve_telemetry: spec stream {len(spec_events)} spec records "
          f"for {st.spec_slot_rounds} slot-rounds, spans {spans}")
    info["spec"] = {"spec_rounds": st.spec_rounds,
                    "tree_rounds": st.tree_rounds,
                    "spec_records": len(spec_events),
                    "acceptance": st.spec_acceptance_rate,
                    "spans": sorted(spans),
                    "launches": {k: v for k, v in spec_on[2].items() if v}}
    info["tokens_per_s"] = {
        mode: [r["tokens_per_s"] for r in info["runs"]
               if r["telemetry"] == mode] for mode in ("off", "on")}
    info["decode_step_ms"] = {
        mode: [r["decode_step_ms"] for r in info["runs"]
               if r["telemetry"] == mode] for mode in ("off", "on")}
    step_ms = statistics.median(info["decode_step_ms"]["off"])
    info["hook_budget"] = tel_hook_budget(torch, sched, step_ms)
    t0 = time.perf_counter()
    info["profile"] = tel_profile(torch, model, params, dev)
    info["profile"]["seconds"] = time.perf_counter() - t0
    info["seconds"] = time.perf_counter() - t_leg
    paths = {k: launches[1][k] + launches[2][k] + sampled[True][2][k]
             + spec_on[2][k] for k in ("paged_decode_attn", "fused_sample",
                                       "ln_fwd", "fused_verify",
                                       "fused_verify_tree")}
    return info, paths


def swap_serve(torch, model, params, dev, what, swap=None, at_step=None,
               telemetry=None):
    """One greedy serve of the trace with ``swap`` requested at dispatch
    ``at_step``: each token's birth (the dispatches completed when it
    appeared), the pool tensors' addresses and the final norm's weight's
    at every decode step. Returns (tokens, births, engine, seen)."""
    from apex_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, device=dev, **ENGINE)
    if swap is not None:
        eng.request_swap(swap, at_step=at_step, source=what)
    step, seen = [0], []
    for name in ("prefill_chunk", "decode_step"):
        real = getattr(eng, name)

        def counted(p, pool, *a, _real=real, _name=name, **k):
            if _name == "decode_step":
                seen.append((pool["k"].data_ptr(), pool["v"].data_ptr(),
                             p["lnf_w"].data_ptr()))
            out = _real(p, pool, *a, **k)
            step[0] += 1
            return out

        setattr(eng, name, counted)
    reqs = build_trace()
    born, lens = {}, {r.rid: 0 for r in reqs}

    def clock():
        for r in reqs:
            while lens[r.rid] < len(r.tokens):
                born[(r.rid, lens[r.rid])] = step[0]
                lens[r.rid] += 1
        return time.perf_counter()

    sched = eng.make_scheduler()
    done = eng.serve(params, reqs, clock=clock, scheduler=sched,
                     telemetry=telemetry)
    clock()
    check(len(done) == len(reqs), f"{what}: the serve lost requests")
    sched.allocator.check_accounting()
    return {r.rid: list(r.tokens) for r in reqs}, born, eng, seen


class _ParamRelBias:
    """A decode_rel_bias hook whose table is a parameter
    (``params["rel_table"]``), so a hot-swap changes it."""

    def decode_rel_bias(self, params):
        return causal_rel_bias(params["rel_table"])


def phase_serve_swap(torch, model, params, dev):
    """The serve cell with ``request_swap`` at dispatch SWAP_STEP: a clone
    of the weights gives the no-swap tokens (``swaps == 1``); seeded
    perturbed weights keep every token made before the swap and change
    later ones; an unreached step leaves ``swaps == 0``; the pool's
    tensors never move. Then a hooked GPT-medium whose decode-bias table
    lives in the params, swapped to another table mid-serve: the first
    decode step after the swap, replayed on the plain path with the old
    and the new table, agrees with the new one by the rel_decode rule.
    Returns (info, launches)."""
    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.ops import decode_attention as D
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.serving.telemetry import ServeTelemetry
    from apex_tpu_torch.utils.pytree import tree_map

    t_leg = time.perf_counter()
    info = {"at_step": SWAP_STEP}
    base, born, eng0, _ = swap_serve(torch, model, params, dev, "no swap")
    clone = tree_map(lambda t: t.clone(), params)
    same, born1, eng1, seen = swap_serve(torch, model, params, dev,
                                         "equal weights", clone, SWAP_STEP)
    check(same == base and born1 == born and eng1.last_stats.swaps == 1,
          f"serve_swap: an equal-weights swap changed the tokens (swaps "
          f"{eng1.last_stats.swaps})")
    check(len({s[:2] for s in seen}) == 1, "serve_swap: the pool moved")
    check({s[2] for s in seen} == {params["lnf_w"].data_ptr(),
                                   clone["lnf_w"].data_ptr()},
          "serve_swap: the steps did not rebind to the swapped tensors")
    del clone
    g = torch.Generator(device=dev).manual_seed(SWAP_SEED)
    jolt = tree_map(lambda t: (t.float() + SWAP_STD * torch.randn(
        t.shape, generator=g, device=dev)).to(t.dtype), params)
    tel = ServeTelemetry(slots=ENGINE["num_slots"], window_s=0.0,
                         collect_events=True)
    moved, born2, eng2, _ = swap_serve(torch, model, params, dev,
                                       "perturbed weights", jolt, SWAP_STEP,
                                       telemetry=tel)
    swap_ev = [e for e in tel.events if e.get("phase") == "swap"]
    check(eng2.last_stats.swaps == 1 and len(swap_ev) == 1
          and swap_ev[0]["step"] == SWAP_STEP,
          f"serve_swap: the perturbed swap did not land at dispatch "
          f"{SWAP_STEP}: {swap_ev}")
    info["swap_pause_ms"] = swap_ev[0]["dur_ms"]
    kept = changed = later = 0
    for (rid, i), s in born2.items():
        if s <= SWAP_STEP:
            check(born.get((rid, i)) == s and moved[rid][i] == base[rid][i],
                  f"serve_swap: request {rid}'s token {i}, made at dispatch "
                  f"{s} before the swap, changed")
            kept += 1
        else:
            later += 1
            changed += (rid not in base or i >= len(base[rid])
                        or moved[rid][i] != base[rid][i])
    check(kept > 0 and changed > 0, f"serve_swap: {kept} tokens before the "
          f"swap, {changed} of {later} after it changed")
    _, _, eng3, _ = swap_serve(torch, model, params, dev, "unreached",
                               jolt, 10 ** 9)
    check(eng3.last_stats.swaps == 0 and eng3._pending_swap is None,
          "serve_swap: an unreached swap landed or outlived the serve")
    del jolt
    info.update(tokens_before_swap=kept, tokens_after_swap=later,
                tokens_changed_after_swap=changed,
                swaps={"equal": eng1.last_stats.swaps,
                       "perturbed": eng2.last_stats.swaps,
                       "unreached": eng3.last_stats.swaps})

    # the decode bias's table, swapped with the params
    rmodel = type("ParamRelGPT", (_ParamRelBias, GPTModel), {})(
        model.config)
    h = model.config.num_heads
    old = dict(params, rel_table=rel_table(torch, dev, h))
    g = torch.Generator(device=dev).manual_seed(REL_SEED + 1)
    new_table = torch.randn((REL_BUCKETS, h), generator=g, device=dev)
    eng = ServingEngine(rmodel, device=dev, **ENGINE)
    eng.request_swap(dict(params, rel_table=new_table), at_step=SWAP_STEP,
                     source="rel_table")
    captured = []
    real = eng.decode_step

    def spy(p, pool, tables, tokens, lengths, *a, **k):
        if not captured and p["rel_table"] is new_table:
            captured.append(({n: t.clone() for n, t in pool.items()},
                             tables.clone(), tokens.clone(),
                             lengths.clone()))
            out = real(p, pool, tables, tokens, lengths, *a, **k)
            captured.append(out[1].float())
            return out
        return real(p, pool, tables, tokens, lengths, *a, **k)

    eng.decode_step = spy
    p = D.paged_decode_attn_cuda
    torch.cuda.synchronize()
    p.launches = p.rel_launches = 0
    eng.serve(old, build_trace())
    torch.cuda.synchronize()
    st = eng.last_stats
    L = MODEL["num_layers"]
    check(st.swaps == 1 and len(captured) == 2,
          "serve_swap: the decode-bias swap did not land before a decode "
          "step")
    check(p.launches == p.rel_launches == L * st.decode_steps,
          f"serve_swap: {p.launches} paged launches ({p.rel_launches} "
          f"biased) for {st.decode_steps} steps x {L} layers")
    launches = {"paged_decode_attn": p.launches,
                "paged_decode_attn_rel": p.rel_launches}
    (pool, tables, tokens, lengths), got = captured
    gaps = {}
    for what, table in (("new", new_table), ("old", old["rel_table"])):
        pe = ServingEngine(rmodel, device=dev, impl="torch", **ENGINE)
        _, lg = pe.decode_step(dict(params, rel_table=table),
                               {n: t.clone() for n, t in pool.items()},
                               tables, tokens, lengths)
        live = lengths > 0
        gaps[what] = (got[live] - lg.float()[live]).abs().max().item()
    # the unbiased model's kernel-vs-plain gap at the same step: the rule's
    # yardstick (phase_rel_decode's)
    rows = []
    for impl in ("auto", "torch"):
        e = ServingEngine(model, device=dev, impl=impl, **ENGINE)
        _, lg = e.decode_step(params, {n: t.clone() for n, t in pool.items()},
                              tables, tokens, lengths)
        rows.append(lg.float()[lengths > 0])
    gaps["unbiased"] = (rows[0] - rows[1]).abs().max().item()
    check(gaps["new"] <= 2 * gaps["unbiased"] + DECODE_TOL
          and gaps["new"] < gaps["old"],
          f"serve_swap: after the decode-bias swap the kernel's logits "
          f"are not the new table's: gaps {gaps}")
    info["rel_swap"] = {"decode_steps": st.decode_steps,
                        "live_slots_at_capture": int((lengths > 0).sum()),
                        "logit_gaps": gaps, "launches": launches}
    info["seconds"] = time.perf_counter() - t_leg
    del captured, pool, eng
    torch.cuda.empty_cache()
    return info, launches


def phase_encoder(torch, dev):
    """``inference.jit_encoder`` over BERT-large (BERT's widths, bf16, the
    flash route) at 32 x 512 with the cell's seeded lengths and token
    types, ``with_pooler=True``: per call 24 bshd flash forwards, all on
    wgmma, and 2 x 24 + 1 ln_fwd, no other kernel; hidden and pooled
    against the plain path on the card and an fp32 truth by the flash/norm
    rule (max abs error at most twice the bf16 plain path's + FLASH_SLACK);
    sequences/s, valid tokens/s and ms a call. Returns (info, launches)."""
    from apex_tpu_torch.inference import jit_encoder

    model, params = bert_model(torch, dev, torch.bfloat16)
    # the BERT cell's batch (bert_train's seed): its lengths and types
    (tokens, _, _, types, pad), lens = bert_batch(torch, dev, seed=1)
    encode = jit_encoder(model, with_pooler=True, device=dev)
    encode(params, tokens, types, pad)  # warm-up
    L = BERT["num_layers"]
    torch.cuda.synchronize()
    zero_counters()
    for fn in decode_counters().values():
        fn.launches = 0
    for fn, attr in spec_serve_counters().values():
        setattr(fn, attr, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ENCODER_CALLS):
        hidden, pooled = encode(params, tokens, types, pad)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    others = {k: fn.launches for k, fn in decode_counters().items()
              if k not in ("flash_fwd_bshd", "ln_fwd")}
    others.update({k: getattr(fn, attr)
                   for k, (fn, attr) in spec_serve_counters().items()
                   if k != "ln_fwd"})
    check_launches(launches, {"flash_fwd_bshd": L,
                              "flash_fwd_bshd_wgmma": L,
                              "ln_fwd": 2 * L + 1}, ENCODER_CALLS, "encoder")
    check(not any(others.values()), f"encoder: other kernels launched: "
          f"{others}")
    check(hidden.shape == (BERT_BATCH, BERT_SEQ, BERT["hidden_size"])
          and pooled.shape == (BERT_BATCH, BERT["hidden_size"])
          and torch.isfinite(hidden).all().item()
          and torch.isfinite(pooled).all().item(),
          "encoder: bad hidden or pooled")
    with torch.inference_mode():
        plain_h = model.hidden_states(params, tokens, types, pad,
                                      impl="torch")
        plain_p = model.pooled(params, plain_h)
    model32, params32 = bert_model(torch, dev, torch.float32)
    upcast_copy(torch, params32, params)
    with torch.inference_mode():
        truth_h = model32.hidden_states(params32, tokens, types, pad,
                                        impl="torch")
        truth_p = model32.pooled(params32, truth_h)
    del model32, params32
    errs = {}
    for what, got, plain, truth in (("hidden", hidden, plain_h, truth_h),
                                    ("pooled", pooled, plain_p, truth_p)):
        e_k = (got.float() - truth).abs().max().item()
        e_p = (plain.float() - truth).abs().max().item()
        errs[what] = {"kernel_vs_fp32": e_k, "plain_vs_fp32": e_p,
                      "limit": 2 * e_p + FLASH_SLACK}
        check(e_k <= 2 * e_p + FLASH_SLACK, f"encoder {what}: kernel error "
              f"{e_k} vs the fp32 truth, limit 2 x {e_p} + {FLASH_SLACK}")
    ms = start.elapsed_time(end) / ENCODER_CALLS
    valid = int(lens.sum().item())
    info = {"batch": BERT_BATCH, "seq": BERT_SEQ, "calls": ENCODER_CALLS,
            "ms_per_call": ms, "host_wall_ms_per_call":
                wall * 1e3 / ENCODER_CALLS,
            "sequences_per_s": BERT_BATCH * 1e3 / ms,
            "valid_tokens_per_s": valid * 1e3 / ms,
            "valid_share": valid / (BERT_BATCH * BERT_SEQ),
            "errors": errs,
            "launches_per_call": {k: v / ENCODER_CALLS
                                  for k, v in launches.items() if v}}
    del model, params, hidden, pooled, plain_h, truth_h
    torch.cuda.empty_cache()
    return info, {k: v for k, v in launches.items() if v}



def phase_bshd_rel_kernels(torch, dev):
    """The bshd forward, dQ and dK/dV with T5's bucketed table (32
    bidirectional buckets, max distance 128, a column a head) at BERT's
    call (32 x 512, 16 heads of 64, views of one packed projection,
    seeded lengths with a full row and one of length 0): the flash family
    checks (``family_check``: the bf16 rule, the sm80 variant, wgmma
    bit-identical, the two planted faults) and the table gradient within
    T5_DTABLE_TOL relative norm of the plain version's and of the fp32
    truth's; times beside the bh-flat route on the same data (the
    operands' (b, h, s, d) views, per-row lengths) and SDPA with the bias
    as a float mask, with bounds; then the path: 3 forward + backward
    steps of ``flash_attention(layout="bshd", bias=BucketedBias)``
    through autograd with the counters zeroed just before and read just
    after (one launch of each biased kernel a step). Returns (kernel
    entries, launches)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    b, s = BERT_BATCH, BERT_SEQ
    h = BERT["num_heads"]
    d = BERT["hidden_size"] // h
    table = rel_table(torch, dev, h, std=0.5)
    bias = A.BucketedBias(table, bidirectional=True,
                          max_distance=REL_MAX_DISTANCE)
    lens = seeded_lens(torch, dev, b, BERT_PAD_MIN, s, seed=81)
    lens[0], lens[1] = s, 0
    q, k, v, do = packed_views(torch, dev, b, s, h, h, d, 82)
    kw = dict(scale=d ** -0.5, causal=False, kv_lens=lens, rel_bias=bias)
    shape = {"b": b, "s": s, "h": h, "d": d, "buckets": REL_BUCKETS,
             "max_distance": REL_MAX_DISTANCE, "bidirectional": True,
             "kv_lens": lens.tolist()[:8]}
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0, "dbias": 0.0}
    family_check(torch, "bshd", q, k, v, do, kw, shape, errs, "bshd_rel")
    o, lse = A.flash_fwd_bshd(q, k, v, **kw)
    got = A.flash_bwd_bshd(q, k, v, o, lse, do, **kw)[3]
    plain = A.flash_bwd_bshd(q, k, v, o, lse, do, impl="torch", **kw)[3]
    truth = A.flash_bwd_bshd(*(t.float() for t in (q, k, v, o)), lse,
                             do.float(), impl="torch", **kw)[3]
    rel_p = ((got - plain).norm() / plain.norm()).item()
    rel_t = ((got - truth).norm() / truth.norm()).item()
    emit("flash_check", {"output": "bshd_rel dtable", "shape": shape,
                         "rel_norm_err_vs_plain": rel_p,
                         "rel_norm_err_vs_fp32": rel_t,
                         "tol": T5_DTABLE_TOL})
    check(rel_p <= T5_DTABLE_TOL and rel_t <= T5_DTABLE_TOL,
          f"bshd table gradient: rel norm err {rel_p} vs plain, {rel_t} vs "
          f"fp32 (tol {T5_DTABLE_TOL})")
    errs["dbias"] = (got - truth).abs().max().item()

    t = lambda x: x.transpose(1, 2)  # noqa: E731
    flat_lens = lens.repeat_interleave(h)
    fkw = dict(scale=d ** -0.5, causal=False, kv_lens=flat_lens,
               rel_bias=bias)
    bkw = kw
    dq_, delta = A.flash_bwd_bshd_dq_cuda(q, k, v, o, lse, do, **bkw)
    fo, flse = A.flash_fwd_flat_cuda(t(q), t(k), t(v), **fkw)
    _, fdelta = A.flash_bwd_flat_dq_cuda(t(q), t(k), t(v), fo, flse, t(do),
                                         **fkw)
    turns = {}
    for name, fn_b, fn_f in (
            ("fwd", lambda: A.flash_fwd_bshd_cuda(q, k, v, **bkw),
             lambda: A.flash_fwd_flat_cuda(t(q), t(k), t(v), **fkw)),
            ("dq", lambda: A.flash_bwd_bshd_dq_cuda(q, k, v, o, lse, do,
                                                    **bkw),
             lambda: A.flash_bwd_flat_dq_cuda(t(q), t(k), t(v), fo, flse,
                                              t(do), **fkw)),
            ("dkv", lambda: A.flash_bwd_bshd_dkv_cuda(
                q, k, v, o, lse, do, delta=delta, **bkw),
             lambda: A.flash_bwd_flat_dkv_cuda(
                 t(q), t(k), t(v), fo, flse, t(do), delta=fdelta, **fkw))):
        tt = [time_ms(fn_b, [()]), time_ms(fn_f, [()]),
              time_ms(fn_f, [()]), time_ms(fn_b, [()])]
        turns[name] = {"ms": (tt[0] + tt[3]) / 2,
                       "flat_ms": (tt[1] + tt[2]) / 2, "turns_ms": tt}
    plain_fwd = time_ms(lambda: A.flash_fwd_bshd(q, k, v, impl="torch",
                                                 **kw), [()], reps=2,
                        trials=3)
    plain_bwd = time_ms(lambda: A.flash_bwd_bshd(q, k, v, o, lse, do,
                                                 impl="torch", **kw),
                        [()], reps=2, trials=3)
    lib_fwd, lib_bwd, _ = sdpa_times(torch, F, t(q), t(k), t(v), t(do),
                                     kw["scale"], False, lens,
                                     bias.materialize(s, s))
    live = float(lens.sum())
    bd = flash_bounds(b, h, h, s, s, d, s * h * live, h * live)
    del dq_, delta, fo, flse, fdelta, o, lse
    torch.cuda.empty_cache()

    # the path: flash_attention through autograd, counted
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    tab = table.clone().requires_grad_()
    counters = {"flash_fwd_bshd_rel": A.flash_fwd_bshd_cuda,
                "flash_bwd_bshd_dq_rel": A.flash_bwd_bshd_dq_cuda,
                "flash_bwd_bshd_dkv_rel": A.flash_bwd_bshd_dkv_cuda}
    steps = 3
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = fn.rel_launches = fn.wgmma_launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        out = A.flash_attention(*leaves, layout="bshd", kv_lens=lens,
                                bias=A.BucketedBias(
                                    tab, bidirectional=True,
                                    max_distance=REL_MAX_DISTANCE))
        out.backward(do)
    torch.cuda.synchronize()
    path_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = {}
    for name, fn in counters.items():
        check(fn.launches == fn.rel_launches == fn.wgmma_launches == steps,
              f"bshd_rel path: {fn.launches} {name} launches "
              f"({fn.rel_launches} biased, {fn.wgmma_launches} wgmma) for "
              f"{steps} steps")
        launches[name] = fn.rel_launches
        launches[name[:-4]] = fn.launches
    check(torch.isfinite(tab.grad).all().item() and tab.grad.abs().sum() > 0,
          "bshd_rel path: the table got no gradient")
    del leaves, tab, out, q, k, v, do
    torch.cuda.empty_cache()
    timed = dict(shape, layout="views of the packed projection",
                 dtype="bf16")
    src = "apex_tpu_torch/csrc/"
    note = ("flat_ms: the bh-flat entry on the same operands' (b, h, s, d) "
            "views with per-row lengths, in turns (ms, flat, flat, ms)")
    lib_note = ("F.scaled_dot_product_attention with the bias and the "
                "key-padding mask as one float mask")
    common = dict(route="cuda", plain_note="one plain backward computes "
                  "dq, dk, dv and the table gradient together",
                  timed_shape=timed, path_step_ms=path_ms, kernel_note=note)
    return [
        dict(common, name="flash_fwd_bshd_rel",
             source=src + "flash_attn_fwd.cu",
             replaces="apex_tpu/ops/pallas/attention.py:778",
             max_abs_err=errs["fwd"], ms=turns["fwd"]["ms"],
             flat_ms=turns["fwd"]["flat_ms"], plain_ms=plain_fwd,
             bound_ms=bd["fwd"][0], bound_by=bd["fwd"][1],
             library_ms=lib_fwd, library_note=lib_note + " (forward)"),
        dict(common, name="flash_bwd_bshd_dq_rel",
             source=src + "flash_attn_bwd.cu",
             replaces="apex_tpu/ops/pallas/attention.py:1455",
             max_abs_err=errs["dq"], ms=turns["dq"]["ms"],
             flat_ms=turns["dq"]["flat_ms"], plain_ms=plain_bwd,
             bound_ms=bd["dq"][0], bound_by=bd["dq"][1],
             library_ms=lib_bwd, library_note=lib_note + " (its autograd "
             "backward: dq, dk and dv in one call)"),
        dict(common, name="flash_bwd_bshd_dkv_rel",
             source=src + "flash_attn_bwd.cu",
             replaces="apex_tpu/ops/pallas/attention.py:1486",
             max_abs_err=errs["dkv"], dtable_max_abs_err=errs["dbias"],
             ms=turns["dkv"]["ms"], flat_ms=turns["dkv"]["flat_ms"],
             plain_ms=plain_bwd, bound_ms=bd["dkv"][0],
             bound_by=bd["dkv"][1], library_ms=lib_bwd,
             library_note=lib_note + " (its autograd backward)"),
    ], launches


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


def bert_step(model, params, opt, batch, opt_events=None):
    loss = model.mlm_loss(params, *batch)
    loss.backward()
    opt_step(opt, opt_events)
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def opt_step(opt, events=None):
    """``opt.step()``; with ``events`` (a list), between two CUDA events
    appended to it as a pair (read them after a synchronize)."""
    if events is None:
        opt.step()
        return
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.step()
    end.record()
    events.append((start, end))


def event_ms(events):
    """Each (start, end) pair's elapsed ms; the device must be synced."""
    return [a.elapsed_time(b) for a, b in events]


def path_counters():
    """Every flash, xent_stats, layer-norm, softmax, matmul and dropout
    counter, by name (the flash kernels' also by variant: ``<name>_wgmma``,
    ``<name>_sm80``, and with dropout, ``<name>_dropout``; the dropout
    kernel's forward and backward launches, ``dropout_fwd`` and
    ``dropout_bwd``; the packed flash trio's, ``ln_fwd``'s, ``ln_bwd``'s and
    ``xent_stats``'s launches on their fp16 instances, ``<name>_f16``):
    the kernels a path must launch and those it must not."""
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import batch_norm as BN
    from apex_tpu_torch.ops import dropout as D
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import matmul as MM
    from apex_tpu_torch.ops import softmax as S
    from apex_tpu_torch.ops import xentropy as X

    flash = (("flash_fwd", A.flash_fwd_cuda),
             ("flash_bwd_dbias", A.flash_bwd_dbias_cuda),
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
            "ln_fwd_wide": (LN.ln_fwd_wide_cuda, "launches"),
            "ln_bwd_wide": (LN.ln_bwd_wide_cuda, "launches"),
            # the fp16 instances (amp's strict-fp16 step)
            **{f"{name}_f16": (fn, "f16_launches") for name, fn in (
                ("flash_fwd", A.flash_fwd_cuda),
                ("flash_bwd_dq", A.flash_bwd_dq_cuda),
                ("flash_bwd_dkv", A.flash_bwd_dkv_cuda),
                ("xent_stats", X.xent_stats_cuda),
                ("ln_fwd", LN.ln_fwd_cuda), ("ln_bwd", LN.ln_bwd_cuda),
                ("ln_fwd_wide", LN.ln_fwd_wide_cuda),
                ("ln_bwd_wide", LN.ln_bwd_wide_cuda))},
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
                                      "split_launches"),
            # the batch-norm kernels, by epilogue and in eval
            **{f"bn_{d}{k and '_' + k}": (fn, f"{k}_launches" if k
                                          else "launches")
               for d, fn in (("fwd", BN.bn_fwd_cuda),
                             ("bwd", BN.bn_bwd_cuda))
               for k in ("", "res_relu", "relu", "res", "bare", "eval")}}


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
    events = []
    losses, wall, launches = timed_steps(
        torch, lambda: bert_step(model, params, opt, batch, events),
        BERT_STEPS, "BERT train path")
    check_launches(launches, bert_train_counts(), BERT_STEPS,
                   "BERT train path")
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
            "opt_step_ms": statistics.median(event_ms(events[1:])),
            "launches_per_step": {k: v / BERT_STEPS
                                  for k, v in launches.items() if v}}
    return (model, params, opt, batch), info, launches


def bert_train_counts():
    """Per BERT flash step: 48 bshd forwards (24 layers, run again by the
    remat), 24 bshd dQ, 24 bshd dK/dV, all on wgmma, one xent_stats, and
    the norms."""
    L = BERT["num_layers"]
    return {"flash_fwd_bshd": 2 * L, "flash_fwd_bshd_wgmma": 2 * L,
            "flash_bwd_bshd_dq": L, "flash_bwd_bshd_dkv": L,
            "flash_bwd_bshd_dq_wgmma": L, "flash_bwd_bshd_dkv_wgmma": L,
            "xent_stats": 1, **bert_ln_counts()}


def compare_paths(torch, run, params, params32, what, bound_kernel_vs_plain,
                  view=None, hold_loss=True):
    """One step's loss and gradients at ``params``: the kernel path against
    the plain path, and both against an fp32 plain-path truth at
    ``params32`` (the same params upcast). ``run(p, impl)`` returns the
    loss. Each leaf's kernel-path error from the truth must be at most
    twice the bf16 plain path's plus 1e-3 (the flash kernels' rule lifted
    to the step), the losses within TRAIN_LOSS_TOL; where
    ``bound_kernel_vs_plain``, each leaf's kernel-vs-plain error is also
    held to TRAIN_GRAD_TOL. ``view(name, grad)`` may narrow a leaf's
    gradient; leaves without a gradient are skipped. ``hold_loss=False``
    reports the losses and leaves their rule to the caller."""

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
            "loss_rel_err_vs_truth": abs(loss_k - loss_t) / abs(loss_t),
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
    if hold_loss:
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


def ln_case(torch, dev, rows, hidden, affine, seed, copies=1, dtype=None):
    """``copies`` (x, dy) pairs and (gamma, beta) per ``affine`` ("wb",
    "w" or ""), all in ``dtype`` (default bf16)."""
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    sets = [((torch.randn((rows, hidden), generator=g, device=dev) * 2
              + 0.5).to(dtype),
             torch.randn((rows, hidden), generator=g, device=dev).to(dtype))
            for _ in range(copies)]
    w = (1 + 0.3 * torch.randn((hidden,), generator=g, device=dev))
    b = 0.2 * torch.randn((hidden,), generator=g, device=dev)
    return (sets, w.to(dtype) if "w" in affine else None,
            b.to(dtype) if "b" in affine else None)


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


def parent_turns(torch, fn, arg_sets, reps=20, trials=TRIALS,
                 parent_fn=None):
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
               "signed char": "a", "__nv_fp8_e4m3": "13__nv_fp8_e4m3",
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
    check(losses[-1] < losses[0],
          f"{what}: loss did not fall: {losses}")
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


def f16_turns(torch, fn16, fn_bf16, arg_sets=((),), reps=20,
              trials=TRIALS):
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


def amp_flagship(torch, dev, init_scale=None, adam=None):
    """The flagship's pieces: the model, amp.initialize's O2 fp16 state
    over FusedAdam(lr 1e-4) (the class ``adam`` if given; with
    ``init_scale``, the same built from its parts with that scale) and
    the batch."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, TRAIN, torch.float32)
    opt = (adam or FusedAdam)(param_leaves(params), lr=AMP_LR)
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


def load_parent_adam(root):
    """``root``'s FusedAdam class: its optimizers/fused_adam.py, run with
    its own optimizers/_fused.py in place of this tree's where it has
    one (both import torch and numpy only)."""
    import importlib.util

    import apex_tpu_torch.optimizers  # noqa: F401  (this tree's, bound first)

    where = os.path.join(root, "apex_tpu_torch", "optimizers")

    def load(name, file):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(where, file))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    base = "apex_tpu_torch.optimizers._fused"
    saved = sys.modules.get(base)
    try:
        if os.path.exists(os.path.join(where, "_fused.py")):
            sys.modules[base] = load("parent_fused", "_fused.py")
        return load("parent_fused_adam", "fused_adam.py").FusedAdam
    finally:
        sys.modules.pop(base, None)
        if saved is not None:
            sys.modules[base] = saved


def amp_adam_turns(torch, dev):
    """The flagship over the parent's FusedAdam and over this tree's, in
    turns (parent, this, this, parent) of AMP_STEPS steps each after
    AMP_WARMUP warm-up steps: each side's step ms (the mean of its two
    turns), its device time (2 profiled steps), and whether the two
    sides' losses agree bit for bit (both take the same steps from the
    same seeded state)."""
    from apex_tpu_torch import amp

    sides = {"parent": amp_flagship(torch, dev, adam=PARENT_ADAM),
             "this": amp_flagship(torch, dev)}
    losses = {k: [] for k in sides}
    for k, (model, st, (tokens, targets)) in sides.items():
        for _ in range(AMP_WARMUP):
            amp_step(amp, model, st, tokens, targets)
    turns = {k: [] for k in sides}
    for k in ("parent", "this", "this", "parent"):
        model, st, (tokens, targets) = sides[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [amp_step(amp, model, st, tokens, targets)[0]
               for _ in range(AMP_STEPS)]
        torch.cuda.synchronize()
        turns[k].append(1e3 * (time.perf_counter() - t0) / AMP_STEPS)
        losses[k] += [float(v) for v in out]
    info = {"turn_step_ms": turns,
            "losses_bit_identical": losses["parent"] == losses["this"]}
    for k, (model, st, (tokens, targets)) in sides.items():
        step_ms = statistics.mean(turns[k])
        prof = phase_train_profile(
            torch, lambda: amp_step(amp, model, st, tokens, targets),
            step_ms / 1e3)
        info[k] = {"step_ms": step_ms,
                   "device_ms_per_step": 1e3 * prof["device_busy_s_per_step"],
                   "device_busy_share": prof["device_busy_share"],
                   "by_layer": prof["by_layer"]}
    del sides, model, st
    torch.cuda.empty_cache()
    return info


def phase_amp_o2_fp16_train(torch, dev):
    """The flagship: GPT-medium's train step under amp O2 at fp16 (fp32
    masters, the dynamic scaler from 2**16, FusedAdam(lr 1e-4) behind the
    skip guard), batch 16 x 1024: 2 warm-up steps, then 20 timed ones with
    the counters zeroed just before and read just after (12/12/12 flash
    forward/dQ/dK-dV, 25/25 ln_fwd/ln_bwd and 1 xent_stats a step, all on
    the fp16 instances); the loss and scale trajectories, the skipped
    steps, step ms, tokens/s, MFU, peak memory; under ``--parent`` the
    flagship over the parent's FusedAdam and this tree's in turns
    (amp_adam_turns). Then the bf16 train leg's step (bf16 params,
    FusedAdam) at the same batch and step counts. Each leg with 2
    profiled steps (device time by layer, busy share)."""
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
    if PARENT_ADAM is not None:
        info["parent_adam_turns"] = amp_adam_turns(torch, dev)

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


# --- the optimizers and the legacy fp16 API ----------------------------------

# NVIDIA's BERT pretraining recipe (DeepLearningExamples' phase-2 LAMB):
# lr 4e-3, betas (0.9, 0.999), eps 1e-6, the gradient clipped at a global
# norm of 1.0, weight decay 0.01 on the weights and 0 on the biases and
# norm parameters
LAMB = dict(lr=4e-3, betas=(0.9, 0.999), eps=1e-6, max_grad_norm=1.0)
LAMB_DECAY = 0.01
# FP16_Optimizer on GPT-medium at the amp flagship's batch: 2 warm-up and
# 10 timed steps from 2**16, then 5 steps from 2**24
FP16_OPT_WARMUP, FP16_OPT_STEPS = 2, 10
FP16_OPT_OVERFLOW_STEPS, FP16_OPT_OVERFLOW_INIT = 5, 2.0 ** 24
LARC_SGD, LARC_TRUST = dict(lr=0.1, momentum=0.9), 0.02
# optimizer_steps: seeded gradients of std 1e-3 over GPT-medium's 186M
# bf16 parameters (global norm ~13.6: LAMB's clip of 1 divides by it);
# after the checked first step, 2 untimed (on an H100 the first steps
# after it ran up to 20x the rest) and 10 timed
OPT_GRAD_STD, OPT_WARM_STEPS, OPT_TIMED_STEPS = 1e-3, 2, 10
# LAMB's clip divisor on the card (over both groups' 186M gradients)
# against the float64 norm of every gradient: relative
OPT_CLIP_RTOL = 1e-5
# the leaves the card's step is held against on the CPU, by the CPU parity
# tests' tolerance (fp32 state: 1e-6 relative + 1e-9, or 1e-6 of the
# leaf's largest entry where a norm's summation order enters; bf16
# params: at most 1 in 1000 one ulp off)
OPT_CHECK_LEAVES = ("lnf_w", "layers.0.qkv.bias", "layers.0.mlp_up.weight",
                    "pos_embedding")
OPT_RTOL, OPT_ATOL, OPT_OF_LARGEST = 1e-6, 1e-9, 1e-6


def lamb_groups(leaves):
    """NVIDIA's recipe's two groups: the weights (every tensor of 2 or more
    dims: the matrices and the embeddings) at LAMB_DECAY, the biases and
    norm parameters (1-D) at 0."""
    return [{"params": [t for t in leaves if t.ndim >= 2],
             "weight_decay": LAMB_DECAY},
            {"params": [t for t in leaves if t.ndim < 2],
             "weight_decay": 0.0}]


def leg_summary(info):
    keys = ("step_ms", "opt_step_ms", "tokens_per_s", "mfu",
            "peak_memory_gb")
    return {k: info[k] for k in keys if k in info}


def phase_bert_lamb_train(torch, dev, mixed, beside):
    """BERT-large's flash step (bert_train's model, batch 32 x 512 with
    padded lengths, remat, bf16) under FusedLAMB in NVIDIA's two groups,
    or with ``mixed`` under FusedMixedPrecisionLamb (fp32 masters in its
    state): a warm-up and BERT_STEPS timed steps with bert_train's
    launches per step asserted (the optimizer adds no kernel), losses
    finite and falling; step ms, tokens/s, MFU, peak memory and the
    optimizer step's own ms (CUDA events around opt.step()), beside the
    legs in ``beside``."""
    from apex_tpu_torch.models.bert import param_leaves
    from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb

    what = "bert_mp_lamb_train" if mixed else "bert_lamb_train"
    cls = FusedMixedPrecisionLamb if mixed else FusedLAMB
    model, params = bert_model(torch, dev, torch.bfloat16)
    leaves = param_leaves(params)
    opt = cls(lamb_groups(leaves), **LAMB)
    batch, lens = bert_batch(torch, dev, seed=1)
    events = []
    losses, wall, launches = timed_steps(
        torch, lambda: bert_step(model, params, opt, batch, events),
        BERT_STEPS, what)
    check_launches(launches, bert_train_counts(), BERT_STEPS, what)
    info = {"optimizer": cls.__name__, "hyper": {**LAMB,
                                                 "weight_decay": LAMB_DECAY},
            "groups": [len(g["params"]) for g in opt.param_groups]}
    if mixed:  # fp32 masters; the model lands where the reference's old +
        # (cast(new) - old) in bf16 puts it, which misses the master's own
        # rounding where that difference is not a bf16 number: counted
        stepped = [t for t in leaves if t in opt.state]
        check(all(opt.state[t]["master"].dtype == torch.float32
                  for t in stepped), f"{what}: a master is not fp32")
        n = sum(t.numel() for t in stepped)
        info["model_off_master_rounding"] = sum(
            int((opt.state[t]["master"].to(t.dtype) != t.detach()).sum())
            for t in stepped) / n
        info["master_gb"] = n * 4 / 1e9
    tok = BERT_BATCH * BERT_SEQ * BERT_STEPS
    flops = bert_flops_per_step(lens) * BERT_STEPS / wall
    opt_ms = event_ms(events[1:])
    info.update({
        "batch": BERT_BATCH, "seq": BERT_SEQ, "steps": BERT_STEPS,
        "losses": losses, "wall_s": wall, "step_ms": 1e3 * wall / BERT_STEPS,
        "tokens_per_s": tok / wall, "mfu": flops / BF16_OPS_PER_S,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "opt_step_ms": statistics.median(opt_ms), "opt_step_ms_all": opt_ms,
        "card": torch.cuda.get_device_name(0),
        "beside": {k: leg_summary(v) for k, v in beside.items()},
        "launches_per_step": {k: v / BERT_STEPS
                              for k, v in launches.items() if v}})
    del model, params, opt, batch
    torch.cuda.empty_cache()
    return info, launches


def fp16_optimizer_gpt(torch, dev, dynamic_loss_args=None):
    """GPT-medium at fp32, ``convert_network(params, torch.float16)`` (the
    ln*/lnf_* leaves stay fp32, every other leaf fp16, checked by name),
    ``FP16_Optimizer(FusedAdam(lr=AMP_LR), dynamic_loss_scale=True)``."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer, convert_network
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params32 = gpt_model(torch, dev, TRAIN, torch.float32)
    params = convert_network(params32, torch.float16)
    del params32
    for name, t in named_leaves(params):
        norm = name.split(".")[-1].startswith("ln")
        check(t.dtype == (torch.float32 if norm else torch.float16)
              and t.requires_grad and t.is_leaf,
              f"convert_network: {name} is {t.dtype}")
    opt = FP16_Optimizer(FusedAdam(param_leaves(params), lr=AMP_LR),
                         dynamic_loss_scale=True,
                         dynamic_loss_args=dynamic_loss_args)
    return model, params, opt


def fp16_optimizer_step(model, params, opt, tokens, targets, trail=None):
    loss = model.loss_fn(params, tokens, targets)
    opt.backward(loss)
    opt.step()
    opt.zero_grad()
    if trail is not None:
        trail.append((opt.overflow, opt.loss_scale))
    return loss.detach()


def ln_dtype_probe(torch, step):
    """Run ``step`` once with the LayerNorm wrappers recording the dtypes
    they are handed (x, weight, bias). Returns the forward's and the
    backward's sets."""
    from apex_tpu_torch.ops import layer_norm as LN

    seen = {"fwd": set(), "bwd": set()}
    orig = LN.ln_fwd_cuda, LN.ln_bwd_cuda

    def fwd(x2d, weight, bias, *a, **k):
        seen["fwd"].add((str(x2d.dtype), str(weight.dtype), str(bias.dtype)))
        return orig[0](x2d, weight, bias, *a, **k)

    def bwd(dy, x2d, mean, rstd, weight, *a, **k):
        seen["bwd"].add((str(x2d.dtype), str(weight.dtype)))
        return orig[1](dy, x2d, mean, rstd, weight, *a, **k)

    # the wrappers count through their module names: the probes carry the
    # counters while they stand in
    for f in (fwd, bwd):
        f.launches = f.f16_launches = 0
    LN.ln_fwd_cuda, LN.ln_bwd_cuda = fwd, bwd
    try:
        step()
    finally:
        LN.ln_fwd_cuda, LN.ln_bwd_cuda = orig
    return {k: sorted(v) for k, v in seen.items()}


def phase_gpt_fp16_optimizer_train(torch, dev, amp_info):
    """The legacy fp16 API on GPT-medium at the amp flagship's batch (16 x
    1024): ``convert_network`` to fp16 with the norms' parameters in fp32,
    ``FP16_Optimizer(FusedAdam(lr=1e-4), dynamic_loss_scale=True)``; the
    first warm-up step with the LayerNorm wrappers handed fp16 x and the
    fp32 parameters (no cast in GPT's forward), a second, then
    FP16_OPT_STEPS timed steps with 12/12/12 packed flash forward/dQ/dK-dV,
    25/25 ln_fwd/ln_bwd and 1 xent_stats launches a step, all on the fp16
    instances; step ms, tokens/s, MFU, peak memory and the scale beside the
    flagship's. Then anew from a scale of 2**24 for 5 steps: at least one
    skipped, and on each skipped step the masters, the fp16 params and
    every Adam state tensor bit-identical, the scale halved."""
    from apex_tpu_torch.models.gpt import param_leaves

    what = "gpt_fp16_optimizer_train"
    model, params, opt = fp16_optimizer_gpt(torch, dev)
    tokens, targets = amp_batch(torch, dev)
    trail = []

    def step():
        return fp16_optimizer_step(model, params, opt, tokens, targets,
                                   trail)

    probe = ln_dtype_probe(torch, step)
    check(probe["fwd"] == [("torch.float16", "torch.float32",
                            "torch.float32")]
          and probe["bwd"] == [("torch.float16", "torch.float32")],
          f"{what}: the LayerNorm kernels were handed {probe}")
    # the probe's step and timed_steps' own: FP16_OPT_WARMUP warm-up steps
    losses, wall, launches = timed_steps(torch, step, FP16_OPT_STEPS, what)
    L = TRAIN["num_layers"]
    check_launches(launches, amp_counts(L, True, True), FP16_OPT_STEPS, what)
    tok = AMP_BATCH * TRAIN_SEQ * FP16_OPT_STEPS
    flops = model_flops_per_token(TRAIN, TRAIN_SEQ) * tok / wall
    timed = trail[-FP16_OPT_STEPS:]
    info = {"batch": AMP_BATCH, "seq": TRAIN_SEQ, "steps": FP16_OPT_STEPS,
            "warmup_steps": FP16_OPT_WARMUP, "lr": AMP_LR,
            "ln_dtypes": probe, "losses": losses,
            "loss_scales": [s_ for _, s_ in timed],
            "skipped_steps": sum(o for o, _ in timed),
            "wall_s": wall, "step_ms": 1e3 * wall / FP16_OPT_STEPS,
            "tokens_per_s": tok / wall, "mfu": flops / BF16_OPS_PER_S,
            "host_syncs_per_step": 1,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": torch.cuda.get_device_name(0),
            "amp_o2_fp16_train": leg_summary(amp_info),
            "over_amp_o2_step": 1e3 * wall / FP16_OPT_STEPS
            / amp_info["step_ms"],
            "launches_per_step": {k: v / FP16_OPT_STEPS
                                  for k, v in launches.items() if v}}
    del model, params, opt
    torch.cuda.empty_cache()

    model, params, opt = fp16_optimizer_gpt(
        torch, dev, {"init_scale": FP16_OPT_OVERFLOW_INIT})
    adam = opt.optimizer
    steps = []
    for _ in range(FP16_OPT_OVERFLOW_STEPS):
        masters = [m.clone() for m in opt.master_params]
        model_ts = [t.detach().clone() for t in param_leaves(params)]
        state = {k: (v["step"], v["exp_avg"].clone(), v["exp_avg_sq"].clone())
                 for k, v in adam.state.items()}
        scale = opt.loss_scale
        loss = fp16_optimizer_step(model, params, opt, tokens, targets)
        rec = {"scale_before": scale, "scale_after": opt.loss_scale,
               "overflow": opt.overflow, "loss": float(loss)}
        if opt.overflow:
            same = (all(torch.equal(a, b) for a, b in zip(
                masters, opt.master_params))
                and all(torch.equal(a, b.detach()) for a, b in zip(
                    model_ts, param_leaves(params)))
                and state.keys() == adam.state.keys()
                and all(v[0] == adam.state[k]["step"]
                        and torch.equal(v[1], adam.state[k]["exp_avg"])
                        and torch.equal(v[2], adam.state[k]["exp_avg_sq"])
                        for k, v in state.items()))
            rec["state_unchanged"] = same
            check(same, f"{what}: a skipped step changed the masters, the "
                  f"fp16 params or Adam's state (scale {scale})")
            check(opt.loss_scale == scale / 2,
                  f"{what}: scale {scale} -> {opt.loss_scale} on an overflow")
        steps.append(rec)
        del masters, model_ts, state
    skipped = sum(r["overflow"] for r in steps)
    check(skipped >= 1, f"{what}: no skipped step from 2**24: {steps}")
    info["overflow"] = {"init_scale": FP16_OPT_OVERFLOW_INIT,
                        "steps": steps, "skipped_steps": skipped}
    del model, params, opt, adam
    torch.cuda.empty_cache()
    return info, launches


def phase_mlp_larc_sgd(torch, dev, mlp_info):
    """The MLP leg's model and data (DLRM's top MLP, bf16, batch 32768)
    under ``LARC(FusedSGD(lr=0.1, momentum=0.9), trust_coefficient=0.02,
    clip=True)``: a warm-up and MLP_STEPS timed steps with 15
    matmul_bias_act launches a step, all wgmma (the 5 weight gradients
    split-K), and no other kernel; losses finite and falling; step ms and the
    optimizer step's ms beside the FusedAdam MLP leg's."""
    from apex_tpu_torch.ops.mlp import MLP
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import LARC

    g = torch.Generator(device=dev).manual_seed(0)
    model = MLP(MLP_SIZES, activation="relu", generator=g, device=dev,
                dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((MLP_BATCH, MLP_SIZES[0]), generator=g,
                    device=dev).bfloat16()
    target = torch.rand((MLP_BATCH, 1), generator=g, device=dev)
    opt = LARC(FusedSGD(list(model.parameters()), **LARC_SGD),
               trust_coefficient=LARC_TRUST, clip=True)
    events = []

    def step():
        loss = (model(x).float() - target).pow(2).mean()
        loss.backward()
        opt_step(opt, events)
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    losses, wall, launches = timed_steps(torch, step, MLP_STEPS,
                                         "mlp_larc_sgd")
    n = len(MLP_SIZES) - 1
    check_launches(launches, {"matmul_bias_act": 3 * n,
                              "matmul_bias_act_wgmma": 3 * n,
                              "matmul_bias_act_split": n}, MLP_STEPS,
                   "mlp_larc_sgd")
    step_s = wall / MLP_STEPS
    info = {"optimizer": "LARC(FusedSGD)", "hyper": {
                **LARC_SGD, "trust_coefficient": LARC_TRUST, "clip": True},
            "sizes": list(MLP_SIZES), "batch": MLP_BATCH,
            "steps": MLP_STEPS, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * step_s, "samples_per_s": MLP_BATCH / step_s,
            "opt_step_ms": statistics.median(event_ms(events[1:])),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mlp_train": leg_summary(mlp_info),
            "launches_per_step": {k: v / MLP_STEPS
                                  for k, v in launches.items() if v}}
    del model, opt, x, target
    torch.cuda.empty_cache()
    return info, launches


def optimizer_configs():
    """name -> (the optimizer over a list of tensors, fp32 state bytes per
    parameter, extra bytes per parameter, the parity tolerance's share of
    a leaf's largest entry)."""
    from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam,
                                           FusedLAMB, FusedMixedPrecisionLamb,
                                           FusedNovoGrad, FusedSGD)
    from apex_tpu_torch.parallel import LARC

    return {
        "adam": (lambda ps: FusedAdam(ps, lr=AMP_LR), 8, 0, 0.0),
        "lamb": (lambda ps: FusedLAMB(lamb_groups(ps), **LAMB), 8, 0,
                 OPT_OF_LARGEST),
        "mp_lamb": (lambda ps: FusedMixedPrecisionLamb(lamb_groups(ps),
                                                       **LAMB), 12, 0,
                    OPT_OF_LARGEST),
        "sgd_momentum": (lambda ps: FusedSGD(ps, **LARC_SGD), 4, 0, 0.0),
        "sgd_nesterov": (lambda ps: FusedSGD(ps, nesterov=True, **LARC_SGD),
                         4, 0, 0.0),
        "novograd_l2": (lambda ps: FusedNovoGrad(ps, lr=1e-2), 4, 0,
                        OPT_OF_LARGEST),
        "novograd_inf": (lambda ps: FusedNovoGrad(ps, lr=1e-2, norm_type=0),
                         4, 0, OPT_OF_LARGEST),
        "adagrad": (lambda ps: FusedAdagrad(ps), 4, 0, 0.0),
        # LARC reads p and g and writes g (bf16) before the SGD step
        "larc_sgd": (lambda ps: LARC(FusedSGD(ps, **LARC_SGD),
                                     trust_coefficient=LARC_TRUST), 4, 6,
                     OPT_OF_LARGEST)}


def lamb_without_trust_ratio():
    """A context that puts a patched copy of ``fused_lamb.lamb_math`` in
    its module, the trust ratio left out (every tensor steps by lr): the
    planted fault the CPU check must refuse."""
    import contextlib
    import inspect

    from apex_tpu_torch.optimizers import fused_lamb as FL

    src = inspect.getsource(FL.lamb_math)
    old = "lr * p_norm / u_norm"
    check(src.count(old) == 1, "lamb_math no longer holds the trust ratio "
          "the planted fault removes")
    ns = dict(vars(FL))
    exec(compile(src.replace(old, "torch.full_like(p_norm, lr)"),
                 FL.__file__, "exec"), ns)

    @contextlib.contextmanager
    def planted():
        orig = FL.lamb_math
        FL.lamb_math = ns["lamb_math"]
        try:
            yield
        finally:
            FL.lamb_math = orig
    return planted()


def opt_rule(got, want, of_largest, half):
    """The CPU parity tests' rule for one tensor: (ok, max abs error)."""
    a = got.detach().float().cpu().numpy()
    b = want.detach().float().numpy()
    err = float(np.abs(a - b).max()) if a.size else 0.0
    if half:  # at most 1 in 1000 (and at least 1) one ulp off
        diff = a != b
        ok = (int(diff.sum()) <= max(1, a.size // 1000)
              and bool((np.abs(a - b)[diff]
                        <= np.abs(b[diff]) * 2.0 ** -7).all()))
        return ok, err
    big = float(np.abs(b).max()) if b.size else 0.0
    ok = bool((np.abs(a - b) <= OPT_ATOL + max(0.0, of_largest * big)
               + OPT_RTOL * np.abs(b)).all())
    return ok, err


def lamb_clip(torch, opt, leaves):
    """LAMB's clip divisor as the card's ``opt`` computes it over all its
    groups, held against one from the float64 norm of every gradient in
    ``leaves``: (divisor, relative error)."""
    got = opt._global_stats([g["params"] for g in opt.param_groups])
    sq = sum(float(t.grad.double().square().sum()) for t in leaves)
    norm = np.float32(np.sqrt(sq))
    cap = np.float32(opt.max_grad_norm)
    want = norm / cap if norm > cap else np.float32(1.0)
    return got, abs(float(got) - float(want)) / float(want)


def opt_check(torch, make, leaves, idx, of_largest, fault=None):
    """One step of ``make(leaves)`` on the card (under ``fault``, a
    context, if given) held against ``make`` over CPU copies of the leaves
    ``idx`` stepped on copies of their gradients. LAMB's clip spans every
    gradient, not the copies': the CPU side takes the card's divisor,
    itself held against the float64 norm (OPT_CLIP_RTOL). Returns (ok,
    errors by leaf and tensor, the card's optimizer)."""
    import contextlib

    from apex_tpu_torch.optimizers import FusedLAMB

    cpu = [leaves[i].detach().cpu().clone().requires_grad_() for i in idx]
    for c, i in zip(cpu, idx):
        c.grad = leaves[i].grad.detach().cpu().clone()
    opt = make(leaves)
    ok, errs = True, {}
    copt = make(cpu)
    inner, cinner = getattr(opt, "optim", opt), getattr(copt, "optim", copt)
    if isinstance(inner, FusedLAMB):
        clip, rel = lamb_clip(torch, inner, leaves)
        check(float(clip) > 1.0, f"optimizer_steps: the clip divisor "
              f"{float(clip)} does not engage the clip")
        ok &= rel <= OPT_CLIP_RTOL
        errs["clip_divisor_rel"] = rel
        cinner._global_stats = lambda params: clip.cpu()
    with fault if fault is not None else contextlib.nullcontext():
        opt.step()
    torch.cuda.synchronize()
    copt.step()
    for c, i in zip(cpu, idx):
        pairs = [("param", leaves[i], c, True)] + [
            (k, v, cinner.state[c][k], False)
            for k, v in inner.state[leaves[i]].items()
            if isinstance(v, torch.Tensor)]
        for k, got, want, half in pairs:
            good, err = opt_rule(got, want, of_largest, half)
            ok &= good
            errs[f"{i}.{k}"] = err
    return ok, errs, opt


def opt_adam_turns(torch, leaves):
    """The parent's FusedAdam and this tree's, each over ``leaves`` and
    warmed OPT_WARM_STEPS + 1 steps, then OPT_TIMED_STEPS steps between
    CUDA events in turns (parent, this, this, parent): each side's median
    ms."""
    from apex_tpu_torch.optimizers import FusedAdam

    opts = {"parent": PARENT_ADAM(leaves, lr=AMP_LR),
            "this": FusedAdam(leaves, lr=AMP_LR)}
    for opt in opts.values():
        for _ in range(OPT_WARM_STEPS + 1):
            opt.step()
    events = {k: [] for k in opts}
    for k in ("parent", "this", "this", "parent"):
        for _ in range(OPT_TIMED_STEPS):
            opt_step(opts[k], events[k])
    torch.cuda.synchronize()
    out = {k: statistics.median(event_ms(ev)) for k, ev in events.items()}
    del opts
    torch.cuda.empty_cache()
    return {"ms": out["this"], "parent_ms": out["parent"]}


def phase_optimizer_steps(torch, dev):
    """Each optimizer's step over GPT-medium's 186M bf16 parameters with
    seeded gradients: the first step held against the same optimizer
    stepping CPU copies of OPT_CHECK_LEAVES, OPT_WARM_STEPS more, then
    OPT_TIMED_STEPS each between CUDA events (median ms; the host's
    enqueue inside, as a train step sees it) beside the bound: each
    parameter
    and state tensor read once and written once, each gradient read once
    (LARC: p and g read, g written too), over 3.35 TB/s; under
    ``--parent`` the parent's FusedAdam in turns with this tree's
    (opt_adam_turns). The planted fault (LAMB without its trust ratio)
    must be refused. No kernel launches."""
    model, params = gpt_model(torch, dev, TRAIN, torch.bfloat16)
    del model
    named = named_leaves(params)
    leaves = [t for _, t in named]
    idx = [i for i, (n, _) in enumerate(named) if n in OPT_CHECK_LEAVES]
    check(len(idx) == len(OPT_CHECK_LEAVES), f"optimizer_steps: leaves "
          f"{OPT_CHECK_LEAVES} not all found")
    n_params = sum(t.numel() for t in leaves)

    def seed_grads():
        g = torch.Generator(device=dev).manual_seed(7)
        for t in leaves:
            t.grad = (torch.randn(t.shape, generator=g, device=dev)
                      * OPT_GRAD_STD).to(t.dtype)

    zero_counters()
    out = {}
    for name, (make, state_b, extra_b, ofl) in optimizer_configs().items():
        seed_grads()
        ok, errs, opt = opt_check(torch, make, leaves, idx, ofl)
        check(ok, f"optimizer_steps {name}: the card's step off the CPU's: "
              f"{errs}")
        for _ in range(OPT_WARM_STEPS):
            opt.step()
        events = []
        for _ in range(OPT_TIMED_STEPS):
            opt_step(opt, events)
        torch.cuda.synchronize()
        ms = event_ms(events)
        nbytes = n_params * (2 * 2 + 2 + 2 * state_b + extra_b)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": statistics.median(ms), "ms_all": ms,
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "bytes": nbytes,
                     "over_bound": statistics.median(ms) / bound_ms,
                     "check_max_abs_err": errs}
        del opt
        torch.cuda.empty_cache()
    if PARENT_ADAM is not None:
        seed_grads()
        out["adam"]["parent_turns"] = opt_adam_turns(torch, leaves)
    seed_grads()
    make, _, _, ofl = optimizer_configs()["lamb"]
    ok, errs, opt = opt_check(torch, make, leaves, idx, ofl,
                              fault=lamb_without_trust_ratio())
    check(not ok, f"optimizer_steps: the planted fault (LAMB without its "
          f"trust ratio) was not refused: {errs}")
    launches = read_counters()
    check(not any(launches.values()), f"optimizer_steps launched kernels: "
          f"{ {k: v for k, v in launches.items() if v} }")
    info = {"params": n_params, "grad_std": OPT_GRAD_STD,
            "warm_steps": OPT_WARM_STEPS, "timed_steps": OPT_TIMED_STEPS,
            "check_leaves": list(OPT_CHECK_LEAVES),
            "card": torch.cuda.get_device_name(0),
            "optimizers": out,
            "planted_fault": {"lamb_without_trust_ratio": errs,
                              "refused": True}}
    del opt, params, leaves, named
    torch.cuda.empty_cache()
    return info, launches


# --- dropout beside the array bias; the loss ops and contrib's attention ---

# Transformer-big (Vaswani et al. 2017, Table 3 "big": d_model 1024, d_ff
# 4096, 16 heads, 6 + 6 layers, attention dropout 0.1 as fairseq's
# transformer_wmt_en_de_big_t2t trains it, pre-norm), the paper's shared
# BPE vocabulary of about 37000 tied to the output, sinusoidal positions;
# 32 sentence pairs padded to 128 a side, lengths uniform in [16, 128];
# label smoothing 0.1; Adam betas (0.9, 0.98), eps 1e-9 (section 5.3)
TBIG = dict(vocab=37000, d_model=1024, d_ff=4096, heads=16, enc_layers=6,
            dec_layers=6, batch=32, seq=128, len_min=16, dropout=0.1,
            smoothing=0.1, lr=5e-4, betas=(0.9, 0.98), eps=1e-9)
TBIG_WARMUP, TBIG_STEPS = 2, 3
# the new kernel instances' calls: the Transformer-big leg's key-padding
# route (its (h, b, s, d) views of (b, s, h, d) tensors, b·h 512, 128 x
# 128, d 64, the (b, sq, sk) -1e9 bias: hb 32), and bshd with an (h, sq,
# sk) attn_mask and per-batch lengths at BERT-large's widths (the BERT
# cell's 32 x 512, 16 heads of 64)
BIAS_DROP_CALLS = ("tbig_keypad_flat", "bert_bshd_attn_mask")
# each dropout fault where the kernels plant it; every one must fail its
# rule at every call (on the call's shape with half the kv heads, where a
# kv head's row is not a q head's)
BIAS_DROP_FAULTS = {"key_kv_head": ("fwd", "dq", "dkv", "dbias"),
                    "swap_row_col": ("fwd", "dq", "dkv", "dbias"),
                    "no_dkv_ds_mask": ("dkv",),
                    "l_from_dropped": ("fwd",),
                    "no_dbias_dp_mask": ("dbias",)}
# loss_ops: softmax_cross_entropy_loss at the leg's logits; focal_loss at
# RetinaNet's head (Lin et al. 2017: 9 anchors a location over P3-P7 of an
# 800 x 1333 input, 200,700 anchors an image, 80 classes), 2 images
FOCAL = dict(images=2, anchors=200700, classes=80, alpha=0.25, gamma=2.0)
LOSS_TOL = 1e-4      # the xentropy loss against its fp32 truth, relative
FOCAL_TOL = 1e-5     # the focal loss against its fp64 truth, relative


def bias_drop_case(torch, dev, name, gqa=False):
    """(layout, q, k, v, do, kw) of one new-instance call (kw with the
    bias, lengths, dropout 0.1 and a seed); ``gqa`` halves the kv heads."""
    if name == "tbig_keypad_flat":
        b, s, h, d = TBIG["batch"], TBIG["seq"], TBIG["heads"], 64
        g = torch.Generator(device=dev).manual_seed(101)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev)
                       .bfloat16().permute(2, 0, 1, 3) for _ in range(4))
        lens = seeded_lens(torch, dev, b, TBIG["len_min"], s, seed=102)
        pad = torch.arange(s, device=dev)[None, :] >= lens[:, None]
        bias = torch.where(pad[:, None, :], -1e9, 0.0).expand(
            b, s, s).contiguous()
        if gqa:
            k, v = k[:, :b // 2], v[:, :b // 2]
        return "bhsd", q, k, v, do, dict(
            scale=d ** -0.5, causal=False, bias=bias,
            dropout_rate=TBIG["dropout"], dropout_seed=-123457)
    b, s, h, d = BERT_BATCH, BERT_SEQ, BERT["num_heads"], 64
    q, k, v, do = packed_views(torch, dev, b, s, h, h, d, 103)
    g = torch.Generator(device=dev).manual_seed(104)
    bias = torch.randn((h, s, s), generator=g, device=dev) * 0.5
    lens = seeded_lens(torch, dev, b, BERT_PAD_MIN, s, seed=105)
    if gqa:
        k, v = k[:, :, :h // 2], v[:, :, :h // 2]
    return "bshd", q, k, v, do, dict(
        scale=d ** -0.5, causal=False, bias=bias, kv_lens=lens,
        dropout_rate=DROP_RATE, dropout_seed=2 ** 31 - 5)


def bias_drop_run(torch, layout, q, k, v, o, lse, do, kw, fault=None):
    """The four kernels of one call on the given o and lse, each planting
    ``fault`` where BIAS_DROP_FAULTS says: (o, lse, dq, dk, dv, dbias)."""
    from apex_tpu_torch.ops import attention as A

    fwd, (dq_w, dkv_w) = fwd_wrapper(layout), bwd_wrappers(layout)
    at = BIAS_DROP_FAULTS.get(fault, ())
    f = lambda w: fault if w in at else None  # noqa: E731
    o_k, lse_k = fwd(q, k, v, planted_fault=f("fwd"), **kw)
    dq, delta = dq_w(q, k, v, o, lse, do, planted_fault=f("dq"), **kw)
    dk, dv, *_ = dkv_w(q, k, v, o, lse, do, delta=delta,
                       planted_fault=f("dkv"), **kw)
    dkw = {n: kw[n] for n in ("scale", "causal", "dropout_rate",
                              "dropout_seed")}
    db = A.flash_bwd_dbias_cuda(q, k, v, o, lse, do, kw["bias"],
                                kv_lens=kw.get("kv_lens"), layout=layout,
                                delta=delta, planted_fault=f("dbias"), **dkw)
    return o_k, lse_k, dq, dk, dv, db


def bias_drop_checks(torch, name):
    """One call of the new instances against the plain version by the
    flash rules and the dbias rule, the outputs bit-identical across two
    runs, lse equal to the dropout-free call's, and (on the call's GQA
    variant) every planted dropout fault refused. Returns (max abs errors
    by output, dbias rel norm error, the refusals)."""
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    layout, q, k, v, do, kw = bias_drop_case(torch, dev, name)
    fwd, bwd = ((A.flash_fwd_bshd, A.flash_bwd_bshd) if layout == "bshd"
                else (A.flash_fwd, A.flash_bwd))
    shape = {"call": name, "layout": layout, "q": list(q.shape),
             "bias": list(kw["bias"].shape), "rate": kw["dropout_rate"],
             "kv_lens": kw.get("kv_lens") is not None}
    tag = "bias_dropout_check"
    up = [x.float() for x in (q, k, v)]
    o_p, lse_p = fwd(q, k, v, impl="torch", **kw)
    o_t, lse_t = fwd(*up, impl="torch", **kw)
    first = bias_drop_run(torch, layout, q, k, v, o_p, lse_p, do, kw)
    second = bias_drop_run(torch, layout, q, k, v, o_p, lse_p, do, kw)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, f"{name}: an output of the bias x dropout instances "
          f"differs between two runs")
    nodrop = dict(kw, dropout_rate=0.0, dropout_seed=None)
    _, lse0 = fwd_wrapper(layout)(q, k, v, **nodrop)
    check(torch.equal(first[1], lse0), f"{name}: lse with dropout differs "
          f"from the dropout-free call's")
    errs = {"o": rule_check(f"{name} o", first[0], o_p, o_t, shape, tag),
            "lse": rule_check(f"{name} lse", first[1], lse_p, lse_t, shape,
                              tag)}
    del o_t, lse_t
    plain = bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = bwd(*up, o_p.float(), lse_p, do.float(), impl="torch", **kw)
    for out, g_, p_, t_ in zip(("dq", "dk", "dv"), first[2:5], plain,
                               truth):
        check(torch.isfinite(g_.float()).all().item(),
              f"{name} {out}: not finite")
        errs[out] = rule_check(f"{name} {out}", g_, p_, t_, shape, tag)
    db_rel = ((first[5] - truth[3]).norm() / truth[3].norm()).item()
    emit(tag, {"output": f"{name} dbias", "shape": shape,
               "rel_norm_err": db_rel, "tol": DBIAS_TOL})
    check(db_rel <= DBIAS_TOL, f"{name} dbias: rel norm err {db_rel}")
    errs["dbias"] = (first[5] - truth[3]).abs().max().item()
    del first, second, plain, truth, up
    torch.cuda.empty_cache()

    # the faults, on the GQA variant of the call
    layout, q, k, v, do, kw = bias_drop_case(torch, dev, name, gqa=True)
    up = [x.float() for x in (q, k, v)]
    o_p, lse_p = fwd(q, k, v, impl="torch", **kw)
    o_t, _ = fwd(*up, impl="torch", **kw)
    plain = bwd(q, k, v, o_p, lse_p, do, impl="torch", **kw)
    truth = bwd(*up, o_p.float(), lse_p, do.float(), impl="torch", **kw)
    _, lse0 = fwd_wrapper(layout)(q, k, v, **dict(
        kw, dropout_rate=0.0, dropout_seed=None))
    refused = {}
    for fault in BIAS_DROP_FAULTS:
        got = bias_drop_run(torch, layout, q, k, v, o_p, lse_p, do, kw,
                            fault)
        fails = [n for n, g_, p_, t_ in (("o", got[0], o_p, o_t),
                                         ("dq", got[2], plain[0], truth[0]),
                                         ("dk", got[3], plain[1], truth[1]),
                                         ("dv", got[4], plain[2], truth[2]))
                 if not rule_ok(g_, p_, t_)[0]]
        if not torch.equal(got[1], lse0):
            fails.append("lse")
        if ((got[5] - truth[3]).norm() / truth[3].norm()).item() > DBIAS_TOL:
            fails.append("dbias")
        refused[fault] = fails
        check(fails, f"{name}: the planted dropout fault {fault!r} passed "
              f"every rule")
    del plain, truth, up, o_p, o_t
    torch.cuda.empty_cache()
    return errs, db_rel, refused


def sdpa_drop_times(torch, F, q4, k4, v4, do4, scale, fmask, rate):
    """One PyTorch call for the same work but another mask: SDPA with the
    bias as a float attn_mask and dropout_p, its forward, its autograd
    backward, and the backward that also returns the mask's gradient.
    Timed, used nowhere. Returns (fwd ms, bwd ms, bwd with the mask's
    gradient ms)."""
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    mask = fmask.to(q4.dtype)

    def call(m):
        return F.scaled_dot_product_attention(*leaves, attn_mask=m,
                                              dropout_p=rate, scale=scale)

    fwd = time_ms(lambda: call(mask), [()])
    out = call(mask)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do4,
                                              retain_graph=True), [()],
                  reps=5)
    mask = mask.detach().requires_grad_()
    out = call(mask)
    dbias = time_ms(lambda: torch.autograd.grad(out, [*leaves, mask], do4,
                                                retain_graph=True), [()],
                    reps=5)
    del out, mask, leaves
    return fwd, bwd, dbias


def bias_drop_times(torch, name):
    """Each new instance timed in turns (A B C C B A) beside the same
    call's bias-only instance (B) and dropout-only instance (C; for dbias
    the bias-only kernel alone), the plain version, SDPA with the bias as
    a float mask and dropout_p 0.1 (the same work, another mask), and the
    bounds (PERF.md §6's bytes rule)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    layout, q, k, v, do, kw = bias_drop_case(torch, dev, name)
    fwd_w, (dq_w, dkv_w) = fwd_wrapper(layout), bwd_wrappers(layout)
    fwd, bwd = ((A.flash_fwd_bshd, A.flash_bwd_bshd) if layout == "bshd"
                else (A.flash_fwd, A.flash_bwd))
    o, lse = fwd(q, k, v, **kw)
    cfgs = {"bias_dropout": kw,
            "bias_only": dict(kw, dropout_rate=0.0, dropout_seed=None),
            "dropout_only": dict(kw, bias=None)}
    deltas = {c: dq_w(q, k, v, o, lse, do, **k_)[1] for c, k_ in
              cfgs.items()}
    dkw = lambda c: {n: cfgs[c][n] for n in (  # noqa: E731
        "scale", "causal", "kv_lens", "dropout_rate", "dropout_seed")
        if n in cfgs[c]}
    ops = {"fwd": lambda c: fwd_w(q, k, v, **cfgs[c]),
           "dq": lambda c: dq_w(q, k, v, o, lse, do, **cfgs[c]),
           "dkv": lambda c: dkv_w(q, k, v, o, lse, do, delta=deltas[c],
                                  **cfgs[c]),
           "dbias": lambda c: A.flash_bwd_dbias_cuda(
               q, k, v, o, lse, do, kw["bias"], layout=layout,
               delta=deltas[c], **dkw(c))}
    out = {}
    for op, fn in ops.items():
        order = (["bias_dropout", "bias_only"] if op == "dbias"
                 else ["bias_dropout", "bias_only", "dropout_only"])
        turns = [(c, time_ms(lambda c=c: fn(c), [()]))
                 for c in order + order[::-1]]
        out[op] = {c: statistics.mean(t for c_, t in turns if c_ == c)
                   for c in order}
        out[op]["turns_ms"] = [t for _, t in turns]
    out["plain_fwd_ms"] = time_ms(lambda: fwd(q, k, v, impl="torch", **kw),
                                  [()], reps=2, trials=3)
    out["plain_bwd_ms"] = time_ms(lambda: bwd(q, k, v, o, lse, do,
                                              impl="torch", **kw),
                                  [()], reps=2, trials=3)
    torch.cuda.empty_cache()
    # SDPA on the kernels' (b, heads, s, d) views: the bias as a float
    # mask broadcast over the views' rows (-inf past a row's length)
    if layout == "bshd":
        q4, k4, v4, do4 = (x.transpose(1, 2) for x in (q, k, v, do))
        b, h, sq, _ = q4.shape
        fmask = kw["bias"][None].expand(b, h, sq, sq)
        live = (torch.arange(sq, device=dev)[None, :]
                < kw["kv_lens"][:, None])[:, None, None, :]
        fmask = fmask.masked_fill(~live, float("-inf"))
        lens = kw["kv_lens"]
        live_rows = h * float(lens.double().sum())
        pairs = sq * live_rows
    else:
        q4, k4, v4, do4 = q, k, v, do
        b, h, sq, _ = q4.shape
        fmask = kw["bias"][None]
        live_rows, pairs = b * h * sq, b * h * sq * sq
    lib = sdpa_drop_times(torch, F, q4, k4, v4, do4, kw["scale"], fmask,
                          kw["dropout_rate"])
    out["library_ms"] = {"fwd": lib[0], "dq": lib[1], "dkv": lib[1],
                         "dbias": lib[2]}
    bd = flash_bounds(b, h, k4.shape[1], sq, k4.shape[2], q4.shape[3],
                      pairs, live_rows, kw["bias"])
    out["bounds"] = {op: bd[op] for op in ("fwd", "dq", "dkv", "dbias")}
    out["score_pairs"] = pairs
    del q, k, v, do, o, lse, deltas, q4, k4, v4, do4, fmask
    torch.cuda.empty_cache()
    return out


def phase_bias_dropout_kernels(torch, dev):
    """The new kArr x kDrop instances of the flash forward, dQ and dK/dV
    and dbias's mask at the two BIAS_DROP_CALLS: checks (bias_drop_checks)
    and times (bias_drop_times). Returns, by kernel name, the entry for
    the kernels line's ``bias_dropout`` field, and the max abs error by
    operation."""
    names = {"bhsd": {"fwd": "flash_fwd_flat", "dq": "flash_bwd_flat_dq",
                      "dkv": "flash_bwd_flat_dkv", "dbias": "flash_bwd_dbias"},
             "bshd": {"fwd": "flash_fwd_bshd", "dq": "flash_bwd_bshd_dq",
                      "dkv": "flash_bwd_bshd_dkv",
                      "dbias": "flash_bwd_dbias"}}
    by_kernel, errs = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}
    for call in BIAS_DROP_CALLS:
        layout = "bshd" if "bshd" in call else "bhsd"
        e, db_rel, refused = bias_drop_checks(torch, call)
        t = bias_drop_times(torch, call)
        emit("bias_dropout_times", dict(t, call=call))
        for op, kname in names[layout].items():
            err = (e["dbias"] if op == "dbias" else
                   max(e["o"], e["lse"]) if op == "fwd" else
                   e["dq"] if op == "dq" else max(e["dk"], e["dv"]))
            errs[op] = max(errs[op], err)
            by_kernel.setdefault(kname, {})[call] = {
                "ms": t[op]["bias_dropout"],
                "bias_only_ms": t[op]["bias_only"],
                "dropout_only_ms": t[op].get("dropout_only"),
                "turns_ms": t[op]["turns_ms"],
                "plain_ms": t["plain_fwd_ms" if op == "fwd"
                              else "plain_bwd_ms"],
                "bound_ms": t["bounds"][op][0],
                "bound_by": t["bounds"][op][1],
                "library_ms": t["library_ms"][op],
                "max_abs_err": err,
                "dbias_rel_norm_err": db_rel if op == "dbias" else None,
                "faults_refused_by": {f: r for f, r in refused.items()
                                      if op in BIAS_DROP_FAULTS[f]}}
    return by_kernel, errs


def tbig_model(torch, dev, dtype):
    """Transformer-big (TBIG) from contrib's modules, weights from seed 0:
    pre-norm blocks of SelfMultiheadAttn(include_norm_add=True,
    dropout=0.1) (+ EncdecMultiheadAttn in the decoder) and a
    FusedLayerNorm-Linear-ReLU-Linear FFN with its residual, final norms,
    the shared embedding (N(0, 1/d_model), scaled by sqrt(d_model)) tied
    to the output, sinusoidal positions. Returns (model, every module
    with an ``impl``)."""
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    from apex_tpu_torch.ops.fused_dense import uniform_weight
    from apex_tpu_torch.ops.layer_norm import FusedLayerNorm

    nn = torch.nn
    E, Fd, h = TBIG["d_model"], TBIG["d_ff"], TBIG["heads"]
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(dropout=TBIG["dropout"], include_norm_add=True, generator=g,
              device=dev, dtype=dtype)

    def ffn():
        m = nn.ModuleDict(dict(
            ln=FusedLayerNorm(E, device=dev, dtype=dtype),
            up=nn.Linear(E, Fd, device=dev, dtype=dtype),
            down=nn.Linear(Fd, E, device=dev, dtype=dtype)))
        with torch.no_grad():
            for lin in (m["up"], m["down"]):
                n = lin.in_features
                lin.weight.copy_(uniform_weight(lin.weight.shape,
                                                n ** -0.5, g, dev, dtype))
                lin.bias.zero_()
        return m

    model = nn.ModuleDict(dict(
        enc=nn.ModuleList(nn.ModuleDict(dict(
            attn=SelfMultiheadAttn(E, h, **kw), ffn=ffn()))
            for _ in range(TBIG["enc_layers"])),
        dec=nn.ModuleList(nn.ModuleDict(dict(
            attn=SelfMultiheadAttn(E, h, **kw),
            cross=EncdecMultiheadAttn(E, h, **kw), ffn=ffn()))
            for _ in range(TBIG["dec_layers"])),
        enc_ln=FusedLayerNorm(E, device=dev, dtype=dtype),
        dec_ln=FusedLayerNorm(E, device=dev, dtype=dtype)))
    emb = torch.randn((TBIG["vocab"], E), generator=g, device=dev) * E ** -0.5
    model.emb = nn.Parameter(emb.to(dtype))
    pos = torch.arange(TBIG["seq"], device=dev, dtype=torch.float64)[:, None]
    inv = torch.exp(-math.log(1e4) * torch.arange(
        0, E, 2, device=dev, dtype=torch.float64) / E)
    model.register_buffer("pos", torch.cat(
        [torch.sin(pos * inv), torch.cos(pos * inv)], 1).to(dtype))
    return model, [m for m in model.modules() if hasattr(m, "impl")]


def tbig_ffn(m, x):
    import torch.nn.functional as F

    return x + m["down"](F.relu(m["up"](m["ln"](x))))


def tbig_loss(model, batch, seeds, impl="auto"):
    """One forward to the label-smoothed loss over the target tokens:
    ``seeds`` one int32 dropout seed an attention call (18)."""
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

    src, tgt_in, tgt_out, src_pad, tgt_mask = batch
    E = TBIG["d_model"]
    sd = iter(seeds)
    x = F.embedding(src, model.emb) * E ** 0.5 + model.pos
    for layer in model.enc:
        x = layer["attn"](x, key_padding_mask=src_pad, key=next(sd))
        x = tbig_ffn(layer["ffn"], x)
    mem = model.enc_ln(x)
    y = F.embedding(tgt_in, model.emb) * E ** 0.5 + model.pos
    for layer in model.dec:
        y = layer["attn"](y, causal=True, key=next(sd))
        y = layer["cross"](y, mem, key_padding_mask=src_pad, key=next(sd))
        y = tbig_ffn(layer["ffn"], y)
    logits = F.linear(model.dec_ln(y), model.emb)
    loss = SoftmaxCrossEntropyLoss.apply(
        logits.reshape(-1, TBIG["vocab"]), tgt_out.reshape(-1),
        TBIG["smoothing"], 0, True, impl=impl)
    return (loss * tgt_mask.reshape(-1)).sum() / tgt_mask.sum()


def tbig_batch(torch, dev, seed):
    """32 pairs padded to 128 a side, source and target lengths uniform in
    [16, 128]: (src, target input, target output, source pad mask, target
    loss mask)."""
    b, s, V = TBIG["batch"], TBIG["seq"], TBIG["vocab"]
    g = torch.Generator(device=dev).manual_seed(seed)
    src_len, tgt_len = (torch.randint(TBIG["len_min"], s + 1, (b,),
                                      generator=g, device=dev)
                        for _ in range(2))
    cols = torch.arange(s, device=dev)[None, :]
    src = torch.randint(4, V, (b, s), generator=g, device=dev)
    tgt = torch.randint(4, V, (b, s), generator=g, device=dev)
    src_pad = cols >= src_len[:, None]
    tgt_live = cols < tgt_len[:, None]
    src = torch.where(src_pad, 1, src)          # 1: the pad token
    tgt = torch.where(tgt_live, tgt, 1)
    tgt_in = torch.cat([torch.full((b, 1), 2, device=dev), tgt[:, :-1]], 1)
    return (src, tgt_in, tgt, src_pad, tgt_live.float()), (src_len, tgt_len)


TBIG_FLOPS_FORMULA = (
    "6 x (t x Le x (4H^2 + 2HF) + t x Ld x (6H^2 + 2HF) + t x Ld x 2H^2 "
    "+ t x V x H) + 12 x H x (t x Le x s + t x Ld x 2s), t = b x s padded "
    "tokens a side")


def tbig_flops_per_step():
    """Model FLOPs of one step (forward + backward), t5_flops_per_step's
    convention: 6 x the matmul parameters each token passes through
    (encoder 4H^2 + 2HF a layer; decoder 6H^2 + 2HF plus the cross k/v
    projection 2H^2 on every encoder token in every decoder layer; the
    tied head VH per decoder token) plus 12 x H x keys per query token per
    layer (all 128 padded keys: the kernels compute them), at the padded
    4,096 tokens a side."""
    H, Fd, V = TBIG["d_model"], TBIG["d_ff"], TBIG["vocab"]
    Le, Ld, s = TBIG["enc_layers"], TBIG["dec_layers"], TBIG["seq"]
    t = TBIG["batch"] * s
    matmul = (t * Le * (4 * H * H + 2 * H * Fd)
              + t * Ld * (6 * H * H + 2 * H * Fd)
              + t * Ld * 2 * H * H + t * V * H)
    return 6 * matmul + 12 * H * (t * Le * s + t * Ld * 2 * s)


def tbig_counts():
    """Per step: 12 key-padding attention calls (6 encoder, 6 cross) on
    the bh-flat kArr x kDrop instances and dbias, 6 causal decoder calls
    on the bshd kDrop instances, all wgmma; one xent_stats; 32 norms
    (2 an encoder block, 3 a decoder block, the two final ones)."""
    Le, Ld = TBIG["enc_layers"], TBIG["dec_layers"]
    flat, bshd = Le + Ld, Ld
    want = {"xent_stats": 1, "ln_fwd": 2 * Le + 3 * Ld + 2,
            "ln_bwd": 2 * Le + 3 * Ld + 2}
    for n in ("flash_fwd_flat", "flash_bwd_flat_dq", "flash_bwd_flat_dkv"):
        for suffix in ("", "_wgmma", "_bias", "_dropout"):
            want[f"{n}{suffix}"] = flat
    for suffix in ("", "_wgmma", "_dropout"):
        want[f"flash_bwd_dbias{suffix}"] = flat
    for n in ("flash_fwd_bshd", "flash_bwd_bshd_dq", "flash_bwd_bshd_dkv"):
        for suffix in ("", "_wgmma", "_dropout"):
            want[f"{n}{suffix}"] = bshd
    return want


def phase_transformer_big_train(torch, dev):
    """The slice's main path: Transformer-big's step (TBIG) from contrib's
    modules, bf16, FusedAdam: one step at the initial params against the
    plain path and an fp32 truth (the same seeds; compare_paths),
    TBIG_WARMUP warm-up steps, then TBIG_STEPS timed ones with the
    counters zeroed just before and read just after (tbig_counts, nothing
    else), each step with fresh seeds from seed_from_key; 2 profiled
    steps."""
    from apex_tpu_torch.ops.attention import seed_from_key
    from apex_tpu_torch.optimizers import FusedAdam

    model, mods = tbig_model(torch, dev, torch.bfloat16)
    batch, (src_len, tgt_len) = tbig_batch(torch, dev, seed=7)
    keys = torch.Generator().manual_seed(8)  # host seeds: no device read
    n_attn = TBIG["enc_layers"] + 2 * TBIG["dec_layers"]

    def seeds():
        return [seed_from_key(keys) for _ in range(n_attn)]

    model32, mods32 = tbig_model(torch, dev, torch.float32)
    with torch.no_grad():
        for a, c in zip(model32.parameters(), model.parameters()):
            a.copy_(c.float())
    params = {"m": dict(model.named_parameters())}
    params32 = {"m": dict(model32.named_parameters())}
    cmp_seeds = seeds()

    def run(p, impl):
        m, ms = (model32, mods32) if p is params32 else (model, mods)
        set_impl(ms, impl)
        try:
            return tbig_loss(m, batch, cmp_seeds, impl)
        finally:
            set_impl(ms, "auto")

    vs = compare_paths(torch, run, params, params32, "initial (seed 0)",
                       True)
    del model32, mods32, params32
    torch.cuda.empty_cache()
    opt = FusedAdam(list(model.parameters()), lr=TBIG["lr"],
                    betas=TBIG["betas"], eps=TBIG["eps"])

    def step():
        loss = tbig_loss(model, batch, seeds())
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    for _ in range(TBIG_WARMUP - 1):  # timed_steps runs one more
        step()
    losses, wall, launches = timed_steps(torch, step, TBIG_STEPS,
                                         "Transformer-big train path")
    check_launches(launches, tbig_counts(), TBIG_STEPS,
                   "Transformer-big train path")
    step_s = wall / TBIG_STEPS
    flops = tbig_flops_per_step()
    tok = 2 * TBIG["batch"] * TBIG["seq"]
    valid = float(src_len.sum() + tgt_len.sum())
    info = {"config": {k: v for k, v in TBIG.items()}, "steps": TBIG_STEPS,
            "warmup_steps": TBIG_WARMUP, "losses": losses, "wall_s": wall,
            "step_ms": 1e3 * step_s, "tokens_per_s": tok / step_s,
            "valid_tokens_per_s": valid / step_s,
            "padding_share": 1 - valid / tok,
            "model_flops_per_step": flops,
            "flops_formula": TBIG_FLOPS_FORMULA,
            "model_tflops_per_s": flops / step_s / 1e12,
            "mfu": flops / step_s / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "card": torch.cuda.get_device_name(0),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / TBIG_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(torch, step, step_s)
    del model, opt, batch
    torch.cuda.empty_cache()
    return info, launches


def phase_fmha_varlen(torch, dev):
    """contrib.fmha's fmha_varlen at BERT-large's packed batch (the BERT
    cell's lengths, qkv (total, 3, 16, 64), max_s 512, dropout 0.1):
    forward and backward once with the counters zeroed just before and
    read just after (one bshd forward, dQ and dK/dV, all with dropout,
    nothing else), o and dqkv against the plain version by the flash rule,
    forward and backward ms."""
    from apex_tpu_torch.contrib.fmha import fmha_varlen

    b, s, h, d = BERT_BATCH, BERT_SEQ, BERT["num_heads"], 64
    lens = seeded_lens(torch, dev, b, BERT_PAD_MIN, s, seed=1)
    cu = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.cumsum(lens, 0).to(torch.int32)])
    total = int(cu[-1])
    g = torch.Generator(device=dev).manual_seed(111)
    qkv = torch.randn((total, 3, h, d), generator=g, device=dev).bfloat16()
    do = torch.randn((total, h, d), generator=g, device=dev).bfloat16()
    kw = dict(p_dropout=DROP_RATE, key=424243)

    def fwd_bwd(x, impl="auto"):
        x = x.detach().requires_grad_()
        o = fmha_varlen(x, cu, s, impl=impl, **kw)
        o.backward(do.to(o.dtype))
        return o.detach(), x.grad

    fwd_bwd(qkv)
    torch.cuda.synchronize()
    zero_counters()
    o, dqkv = fwd_bwd(qkv)
    torch.cuda.synchronize()
    launches = read_counters()
    want = {}
    for n in ("flash_fwd_bshd", "flash_bwd_bshd_dq", "flash_bwd_bshd_dkv"):
        for suffix in ("", "_wgmma", "_dropout"):
            want[f"{n}{suffix}"] = 1
    check_launches(launches, want, 1, "fmha_varlen")
    o_p, g_p = fwd_bwd(qkv, "torch")
    o_t, g_t = fwd_bwd(qkv.float(), "torch")
    shape = {"total": total, "b": b, "max_s": s, "h": h, "d": d,
             "rate": DROP_RATE}
    errs = {"o": rule_check("fmha_varlen o", o, o_p, o_t, shape),
            "dqkv": rule_check("fmha_varlen dqkv", dqkv, g_p, g_t, shape)}
    del o_p, g_p, o_t, g_t
    x = qkv.detach().requires_grad_()
    fwd_ms = time_ms(lambda: fmha_varlen(qkv, cu, s, **kw), [()])
    out = fmha_varlen(x, cu, s, **kw)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, x, do,
                                                 retain_graph=True), [()],
                     reps=5)
    del out, x
    torch.cuda.empty_cache()
    return {"shape": shape, "valid_share": total / (b * s),
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "max_abs_err": errs,
            "launches": {k: v for k, v in launches.items() if v}}, launches


def phase_loss_ops(torch, dev):
    """softmax_cross_entropy_loss at the Transformer-big leg's (4096,
    37000) bf16 logits with smoothing 0.1 and half_to_float (forward once
    with the counters zeroed: one xent_stats launch, nothing else; the
    loss against its fp32 truth within LOSS_TOL; forward and backward ms
    against the bytes bound and F.cross_entropy(reduction="none",
    label_smoothing=0.1), the same function), and focal_loss at
    RetinaNet's head (FOCAL, fp32; against its fp64 truth within
    FOCAL_TOL; ms against the bytes bound)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import focal_loss as FL
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

    n, V, eps = TBIG["batch"] * TBIG["seq"], TBIG["vocab"], TBIG["smoothing"]
    g = torch.Generator(device=dev).manual_seed(121)
    logits = (3 * torch.randn((n, V), generator=g, device=dev)).bfloat16()
    labels = torch.randint(0, V, (n,), generator=g, device=dev)
    dl = torch.randn((n,), generator=g, device=dev)
    softmax_cross_entropy_loss(logits, labels, eps, True)
    torch.cuda.synchronize()
    zero_counters()
    loss = softmax_cross_entropy_loss(logits, labels, eps, True)
    torch.cuda.synchronize()
    launches = read_counters()
    check_launches(launches, {"xent_stats": 1}, 1, "loss_ops")
    truth = softmax_cross_entropy_loss(logits.float(), labels, eps, True,
                                       impl="torch")
    xent_err = ((loss - truth).norm() / truth.norm()).item()
    check(loss.dtype == torch.float32 and xent_err <= LOSS_TOL,
          f"softmax_cross_entropy_loss vs its fp32 truth: {xent_err}")
    x = logits.detach().requires_grad_()
    fwd_ms = time_ms(lambda: softmax_cross_entropy_loss(logits, labels, eps,
                                                        True), [()])
    out = softmax_cross_entropy_loss(x, labels, eps, True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, x, dl,
                                                 retain_graph=True), [()],
                     reps=5)
    lib_fwd = time_ms(lambda: F.cross_entropy(logits, labels,
                                              reduction="none",
                                              label_smoothing=eps), [()])
    lib_out = F.cross_entropy(x, labels, reduction="none",
                              label_smoothing=eps)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, x, dl.bfloat16(),
                                                  retain_graph=True), [()],
                      reps=5)
    plain_ms = time_ms(lambda: softmax_cross_entropy_loss(
        logits, labels, eps, True, impl="torch"), [()], reps=2, trials=3)
    del out, lib_out, x
    # bytes: the logits read once, the labels and the loss (fp32) once;
    # backward: the logits, lse and dloss read, the gradient written
    fb = bound(n * V * 2 + n * 8 + n * 4, 0, FP32_OPS_PER_S)
    bb = bound(2 * n * V * 2 + n * 8 + 2 * n * 4, 0, FP32_OPS_PER_S)
    xent = {"shape": {"n": n, "V": V, "dtype": "bf16", "smoothing": eps,
                      "half_to_float": True},
            "rel_norm_err_vs_fp32": xent_err, "tol": LOSS_TOL,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": plain_ms,
            "fwd_bound_ms": fb[0], "bwd_bound_ms": bb[0],
            "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd,
            "library": "F.cross_entropy(reduction='none', "
                       "label_smoothing=0.1)"}
    del logits, labels, dl, truth, loss
    torch.cuda.empty_cache()

    A, C = FOCAL["images"] * FOCAL["anchors"], FOCAL["classes"]
    g = torch.Generator(device=dev).manual_seed(122)
    fl_x = torch.randn((FOCAL["images"], FOCAL["anchors"], C), generator=g,
                       device=dev)
    # ~1% of the anchors foreground, the rest background (class 0)
    fg = torch.rand((FOCAL["images"], FOCAL["anchors"]), generator=g,
                    device=dev) < 0.01
    tg = torch.where(fg, torch.randint(1, C + 1, fg.shape, generator=g,
                                       device=dev), 0)
    fkw = dict(alpha=FOCAL["alpha"], gamma=FOCAL["gamma"])
    xg = fl_x.detach().requires_grad_()
    loss = FL.focal_loss(xg, tg, C, **fkw)
    loss.backward()
    with torch.no_grad():
        truth = FL._fl_sum(fl_x.double(), tg, C, FOCAL["alpha"],
                           FOCAL["gamma"], 0.0)
    x64 = fl_x.double().requires_grad_()
    FL._fl_sum(x64, tg, C, FOCAL["alpha"], FOCAL["gamma"], 0.0).backward()
    fl_err = abs(loss.item() - truth.item()) / abs(truth.item())
    g_err = ((xg.grad.double() - x64.grad).abs().max()
             / x64.grad.abs().max()).item()
    check(fl_err <= FOCAL_TOL and g_err <= FOCAL_TOL,
          f"focal_loss vs its fp64 truth: loss {fl_err}, grad {g_err}")
    del x64
    ffwd = time_ms(lambda: FL.focal_loss(fl_x, tg, C, **fkw), [()], reps=5)
    floss = FL.focal_loss(xg, tg, C, **fkw)
    fbwd = time_ms(lambda: torch.autograd.grad(floss, xg,
                                               retain_graph=True), [()],
                   reps=5)
    # bytes: the logits and targets read once, the partial gradient (the
    # residual) written; backward: the residual read, the gradient written
    focal = {"shape": dict(FOCAL, dtype="fp32"),
             "rel_err_vs_fp64": fl_err, "grad_err_of_largest": g_err,
             "tol": FOCAL_TOL, "fwd_ms": ffwd, "bwd_ms": fbwd,
             "fwd_bound_ms": bound(A * C * 8 + A * 8, 0, FP32_OPS_PER_S)[0],
             "bwd_bound_ms": bound(A * C * 8, 0, FP32_OPS_PER_S)[0],
             "library_ms": None,
             "library_note": "no one PyTorch call computes the focal loss"}
    del fl_x, xg, floss, truth
    torch.cuda.empty_cache()
    return {"softmax_cross_entropy_loss": xent, "focal_loss": focal}, launches


# --- the wide norms, FastLayerNorm, the RNN-T transducer and ASP ------------

#: the ln_wide leg's hidden sizes (every one from 4097, with a ragged tail,
#: to FastLayerNorm's 65536) and its row counts (a train step's and a
#: decode step's)
LN_WIDE_HIDDEN = (4097, 5000, 5120, 6144, 8192, 12288, 16384, 25600, 32768,
                  49152, 65536)
LN_WIDE_ROWS = (2048, 8)
#: the widths also checked, timed and driven with fp32 and fp16 x
LN_WIDE_DTYPE_HIDDEN = (8192, 65536)
#: the kernels line's shape: the wide GPT's norm call (its 1 x 2048 tokens)
LN_WIDE_TIMED = (2048, 8192)
#: GPT at Megatron's 39.1B widths (Narayanan et al. 2021, Table 1: hidden
#: 8192, 64 heads of 128, FFN 4 x 8192, 48 layers, sequence 2048, vocabulary
#: 51200), cut to 2 of the 48 layers (with Adam's state the whole model
#: needs ~625 GB; one card has 80)
WIDE_GPT = dict(vocab_size=51200, max_seq_len=2048, hidden_size=8192,
                num_layers=2, num_heads=64, attention_impl="flash",
                remat=False)
WIDE_BATCH, WIDE_SEQ = 1, 2048
WIDE_WARMUP, WIDE_STEPS = 2, 5
#: fresh targets drawn from the vocabulary's first WIDE_TARGETS ids, so the
#: loss has a unigram to fall to within the leg's few steps
WIDE_TARGETS = 4096
WIDE_DECODE = dict(batch=16, prompt=512, new=32, cache=640)
#: the MLPerf Training RNN-T reference's joint
#: (rnn_speech_recognition/pytorch/configs/baseline_v3-1023sp.yaml):
#: encoder output 1024 and predictor output 320 to a joint of 512, 1023
#: sentencepieces and the blank (V 1024, the blank last), utterances of at
#: most 16.7 s at 60 ms a joint frame (T <= 278)
RNNT = dict(batch=16, t_min=140, t_max=278, u_min=20, u_max=100, enc=1024,
            pred=320, joint=512, vocab=1024)
RNNT_LOSS_TOL = 1e-5   # each element's loss against the fp64 truth, relative
RNNT_GRAD_TOL = 2e-4   # the logits' gradient, of the truth's largest entry
ASP_WARMUP, ASP_STEPS, ASP_SWEEPS = 2, 5, 256


def ln_wide_check(torch, dev, rows, hidden, rms, dtype, seed):
    """The wide kernels against their plain versions on one call: y and dx
    by the bf16 rule (fp16: the fp16 rule; fp32: within 1e-5 of the
    largest entry), mean and rstd within 1e-5 of the truth's largest
    entry, dgamma/dbeta within one ulp of the parameters' dtype (fp32:
    1e-5) of the largest; every output bit-identical across two runs. One
    ``ln_wide_check`` line; returns the y and dx max abs errors."""
    from apex_tpu_torch.ops import layer_norm as LN

    sets, w, b = ln_case(torch, dev, rows, hidden, "w" if rms else "wb",
                         seed, dtype=dtype)
    x, dy = sets[0]
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    fwd = LN.ln_fwd_wide_cuda(x, w, b, LN_EPS, rms)
    fwd_again = LN.ln_fwd_wide_cuda(x, w, b, LN_EPS, rms)
    y, mean, rstd = fwd
    bwd = LN.ln_bwd_wide_cuda(dy, x, mean, rstd, w, rms)
    bwd_again = LN.ln_bwd_wide_cuda(dy, x, mean, rstd, w, rms)
    dx, dw, db = bwd
    yp, mp, rp = LN._torch_fwd(x, w, b, LN_EPS, rms)
    dxp, _, _ = LN._torch_bwd(dy, x, mp, rp, w, rms)
    yt, mt, rt = LN._torch_fwd(x.float(), f32(w), f32(b), LN_EPS, rms)
    dxt, dwt, dbt = LN._torch_bwd(dy.float(), x.float(), mt, rt, f32(w),
                                  rms)
    torch.cuda.synchronize()
    shape = {"rows": rows, "hidden": hidden, "rms": rms,
             "dtype": str(dtype)[6:]}
    out, errs = {}, {}
    for name, got, plain, truth in (("y", y, yp, yt), ("dx", dx, dxp, dxt)):
        if dtype == torch.bfloat16:
            ok, err, tol = rule_ok(got, plain, truth)
            out[name] = {"max_abs_err": err, "tol": tol}
        elif dtype == torch.float16:
            ok, out[name] = f16_rule(got, plain, truth)
            err = out[name]["max_abs_err"]
        else:
            err = (got - truth).abs().max().item()
            tol = 1e-5 * truth.abs().max().item()
            ok = err <= tol
            out[name] = {"max_abs_err": err, "tol": tol}
        errs[name] = err
        check(ok, f"ln_wide {name} at {shape}: {out[name]}")
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        dtype, 1e-5)
    for name, got, want, rel in (("mean", mean, mt, 1e-5),
                                 ("rstd", rstd, rt, 1e-5),
                                 ("dgamma", dw, dwt, ulp),
                                 ("dbeta", db, dbt, ulp)):
        if got is None or (rms and name == "mean"):
            continue
        err = (got.float() - want).abs().max().item()
        tol = rel * want.abs().max().item()
        out[name] = {"max_abs_err": err, "tol": tol}
        check(err <= tol, f"ln_wide {name} at {shape}: {err} > {tol}")
    check(all(torch.equal(a, c) for a, c in zip(fwd + bwd,
                                                fwd_again + bwd_again)
              if a is not None),
          f"the wide norm kernels not bit-reproducible at {shape}")
    emit("ln_wide_check", {"shape": shape, "outputs": out,
                           "bit_identical_across_runs": True})
    return errs


def ln_wide_faults(torch, dev, hidden):
    """Both planted faults at ``hidden``, on fp32 rows whose last 16-byte
    chunk is large: each must move rstd past 1e-5 of the truth's largest
    entry and dx past 1e-5 relative norm error; the fault-free call passes
    both (the kernel's own errors are ~1e-7)."""
    from apex_tpu_torch.ops import layer_norm as LN

    sets, _, _ = ln_case(torch, dev, 64, hidden, "", hidden,
                         dtype=torch.float32)
    x, dy = sets[0]
    x[:, -4:] += 6
    dy[:, -4:] += 6
    _, mt, rt = LN._torch_fwd(x, None, None, LN_EPS, False)
    dxt, _, _ = LN._torch_bwd(dy, x, mt, rt, None, False)
    out = {}
    for fault in (None, *sorted(LN.WIDE_FAULTS)):
        _, _, r = LN.ln_fwd_wide_cuda(x, None, None, LN_EPS, False,
                                      planted_fault=fault)
        dx, _, _ = LN.ln_bwd_wide_cuda(dy, x, mt, rt, None, False,
                                       planted_fault=fault)
        r_err = (r - rt).abs().max().item() / rt.abs().max().item()
        dx_err = ((dx - dxt).norm() / dxt.norm()).item()
        passed = r_err <= 1e-5 and dx_err <= 1e-5
        out[fault or "none"] = {"rstd_err_of_largest": r_err,
                                "dx_rel_norm_err": dx_err,
                                "refused": r_err > 1e-5 and dx_err > 1e-5}
        if fault is None:
            check(passed, f"ln_wide at {hidden}: the fault-free call fails "
                  f"the fault rule: {out['none']}")
        else:
            check(out[fault]["refused"], f"ln_wide planted fault {fault} "
                  f"at {hidden} passed: {out[fault]}")
    return out


def ln_wide_times(torch, dev, rows, hidden, dtype, backward=True):
    """The wide kernels' device times at one call (LayerNorm, gamma and
    beta in x's dtype) beside the bound, the plain version and the
    library's F.layer_norm (the forward; its autograd backward for dx,
    dgamma and dbeta); copies of x and dy cycle through more than the 50
    MB L2. One ``ln_wide_times`` line."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops.matmul import _sm_count

    es = torch.tensor([], dtype=dtype).element_size()
    copies = min(6, max(2, -(-120_000_000 // (2 * rows * hidden * es))))
    sets, w, b = ln_case(torch, dev, rows, hidden, "wb", 9, copies=copies,
                         dtype=dtype)
    n = rows * hidden
    fb = bound(2 * n * es + 2 * hidden * es + 8 * rows, 8 * n,
               FP32_OPS_PER_S)
    out = {"rows": rows, "hidden": hidden, "dtype": str(dtype)[6:],
           "fwd_plan": LN._wide_fwd_plan(
               rows, hidden, dtype,
               _sm_count(torch.cuda.current_device()))._asdict(),
           "fwd_ms": time_ms(lambda x, _: LN.ln_fwd_wide_cuda(
               x, w, b, LN_EPS, False), sets, reps=10, trials=5),
           "library_fwd_ms": time_ms(lambda x, _: F.layer_norm(
               x, (hidden,), w, b, LN_EPS), sets, reps=10, trials=5),
           "plain_fwd_ms": time_ms(lambda x, _: LN._torch_fwd(
               x, w, b, LN_EPS, False), sets[:2], reps=3, trials=3),
           "fwd_bound_ms": fb[0], "fwd_bound_by": fb[1]}
    if backward:
        stats = [LN.ln_fwd_wide_cuda(x, w, b, LN_EPS, False)
                 for x, _ in sets]
        bwd_sets = [(dy, x, m, r) for (x, dy), (_, m, r)
                    in zip(sets, stats)]
        graphs = []
        for x, dy in sets:
            leaves = [t.detach().requires_grad_() for t in (x, w, b)]
            graphs.append((F.layer_norm(leaves[0], (hidden,), leaves[1],
                                        leaves[2], LN_EPS), leaves, dy))
        bb = bound(3 * n * es + 8 * rows + 3 * hidden * es, 12 * n,
                   FP32_OPS_PER_S)
        out.update({
            "bwd_plan": LN._wide_bwd_plan(rows, hidden, dtype)._asdict(),
            "bwd_ms": time_ms(lambda dy, x, m, r: LN.ln_bwd_wide_cuda(
                dy, x, m, r, w, False), bwd_sets, reps=10, trials=5),
            "library_bwd_ms": time_ms(
                lambda o, leaves, dy: torch.autograd.grad(
                    o, leaves, dy, retain_graph=True), graphs, reps=10,
                trials=5),
            "plain_bwd_ms": time_ms(lambda dy, x, m, r: LN._torch_bwd(
                dy, x, m, r, w, False), bwd_sets[:2], reps=3, trials=3),
            "bwd_bound_ms": bb[0], "bwd_bound_by": bb[1]})
        del stats, bwd_sets, graphs
    emit("ln_wide_times", out)
    del sets
    torch.cuda.empty_cache()
    return out


def phase_ln_wide(torch, dev):
    """The norms past hidden 4096 (csrc/layer_norm_wide.cu): at every
    LN_WIDE_HIDDEN the kernels against their plain versions at 2048 and 8
    rows in bf16 (LayerNorm with gamma and beta, RMSNorm with gamma), fp32
    and fp16 x at 8192 and 65536, both planted faults refused at every
    width, and each call timed (the forward also at 8 rows); then the path:
    contrib.layer_norm.FastLayerNorm and fused_rms_norm forward and
    backward at every width (bf16, 2048 rows; fp32 and fp16 at 8192 and
    65536), the counters zeroed just before and read just after: every
    norm on the wide instances, none on the register kernels. Returns the
    kernels line's wide entries and the path's launches."""
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm
    from apex_tpu_torch.ops import layer_norm as LN

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    errs = {bf16: {"y": 0.0, "dx": 0.0}, f16: {"y": 0.0, "dx": 0.0}}
    faults, times = {}, {}
    seed = 300
    many, few = LN_WIDE_ROWS
    for hidden in LN_WIDE_HIDDEN:
        cases = [(rows, rms, bf16) for rows in LN_WIDE_ROWS
                 for rms in (False, True)]
        if hidden in LN_WIDE_DTYPE_HIDDEN:
            cases += [(many, False, f32), (many, False, f16)]
        for rows, rms, dtype in cases:
            seed += 1
            e = ln_wide_check(torch, dev, rows, hidden, rms, dtype, seed)
            if dtype in errs:
                errs[dtype] = {k: max(errs[dtype][k], e[k]) for k in e}
        faults[hidden] = ln_wide_faults(torch, dev, hidden)
        torch.cuda.empty_cache()
        times[(many, hidden, bf16)] = ln_wide_times(torch, dev, many,
                                                    hidden, bf16)
        times[(few, hidden, bf16)] = ln_wide_times(torch, dev, few, hidden,
                                                   bf16, backward=False)
    times[(*LN_WIDE_TIMED, f16)] = ln_wide_times(torch, dev, *LN_WIDE_TIMED,
                                                 f16)
    emit("ln_wide_faults", faults)

    # the path: the entries a user calls, every norm counted
    def drive(mod_dtype, hidden, rows=many):
        g = torch.Generator(device=dev).manual_seed(hidden)
        x = (torch.randn((rows, hidden), generator=g, device=dev)
             .to(mod_dtype).requires_grad_())
        ln = FastLayerNorm(hidden, dtype=mod_dtype, device=dev)
        ln(x).float().square().mean().backward()
        w = torch.ones(hidden, dtype=mod_dtype, device=dev,
                       requires_grad=True)
        LN.fused_rms_norm(x, w).float().square().mean().backward()
        check(all(torch.isfinite(t.grad.float()).all().item()
                  for t in (x, ln.weight, ln.bias, w)),
              f"FastLayerNorm/fused_rms_norm at {hidden}: gradients not "
              f"finite")

    drive(bf16, LN_WIDE_HIDDEN[0])  # warm-up, outside the count
    torch.cuda.synchronize()
    zero_counters()
    for hidden in LN_WIDE_HIDDEN:
        drive(bf16, hidden)
    for hidden in LN_WIDE_DTYPE_HIDDEN:
        drive(f32, hidden)
        drive(f16, hidden)
    torch.cuda.synchronize()
    launches = read_counters()
    extra = 2 * len(LN_WIDE_DTYPE_HIDDEN)
    calls = 2 * len(LN_WIDE_HIDDEN) + 2 * extra
    check_launches(launches, {"ln_fwd_wide": calls, "ln_bwd_wide": calls,
                              "ln_fwd_wide_f16": extra,
                              "ln_bwd_wide_f16": extra},
                   1, "ln_wide path (FastLayerNorm, fused_rms_norm)")
    torch.cuda.empty_cache()

    rows, hidden = LN_WIDE_TIMED

    def entry(name, op, dtype, err):
        t = times[(rows, hidden, dtype)]
        return {"name": name, "route": "cuda",
                "source": "apex_tpu_torch/csrc/layer_norm_wide.cu",
                "replaces": ("apex_tpu/ops/pallas/layer_norm.py:102"
                             if op == "fwd" else
                             "apex_tpu/ops/pallas/layer_norm.py:186"),
                "max_abs_err": err, "ms": t[f"{op}_ms"],
                "plain_ms": t[f"plain_{op}_ms"],
                "bound_ms": t[f"{op}_bound_ms"],
                "bound_by": t[f"{op}_bound_by"],
                "library_ms": t[f"library_{op}_ms"],
                "library_note": ("F.layer_norm" if op == "fwd" else
                                 "F.layer_norm's autograd backward (dx, "
                                 "dgamma, dbeta)"),
                "kernel_note": "a row over a cluster of CTAs, its sums "
                               "merged in rank order through distributed "
                               "shared memory",
                "timed_shape": {"rows": rows, "hidden": hidden,
                                "dtype": str(dtype)[6:],
                                "affine": "gamma and beta"},
                "per_shape": {f"{r}x{h}": {k: v for k, v in t_.items()
                                           if op in k}
                              for (r, h, d), t_ in times.items()
                              if d == dtype and f"{op}_ms" in t_}}

    return [entry("ln_fwd_wide", "fwd", bf16, errs[bf16]["y"]),
            entry("ln_bwd_wide", "bwd", bf16, errs[bf16]["dx"]),
            entry("ln_fwd_wide_f16", "fwd", f16, errs[f16]["y"]),
            entry("ln_bwd_wide_f16", "bwd", f16, errs[f16]["dx"])], launches


def wide_gpt_counts():
    """Per wide GPT step (no remat): 2L + 1 norms forward and backward, all
    wide, and the packed flash trio per layer, all on wgmma, and one
    xent_stats."""
    L = WIDE_GPT["num_layers"]
    return {"ln_fwd_wide": 2 * L + 1, "ln_bwd_wide": 2 * L + 1,
            "flash_fwd": L, "flash_fwd_wgmma": L, "flash_bwd_dq": L,
            "flash_bwd_dq_wgmma": L, "flash_bwd_dkv": L,
            "flash_bwd_dkv_wgmma": L, "xent_stats": 1}


def phase_wide_gpt_train(torch, dev):
    """GPT at Megatron's 39.1B widths cut to 2 layers (WIDE_GPT), bf16,
    batch 1 x 2048: one step at the initial params against the plain path
    and an fp32 truth (compare_paths), then WIDE_WARMUP warm-up and
    WIDE_STEPS timed FusedAdam steps on fresh data, each with the launches
    of wide_gpt_counts and no other kernel; 2 profiled steps. Returns the
    info, the launches and (model, params) for the decode leg."""
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    V, H = WIDE_GPT["vocab_size"], WIDE_GPT["hidden_size"]
    model, params = gpt_model(torch, dev, WIDE_GPT, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)

    def batch():
        return (torch.randint(0, V, (WIDE_BATCH, WIDE_SEQ), generator=gen,
                              device=dev),
                torch.randint(0, WIDE_TARGETS, (WIDE_BATCH, WIDE_SEQ),
                              generator=gen, device=dev))

    tokens, targets = batch()
    model32, params32 = gpt_model(torch, dev, WIDE_GPT, torch.float32)
    upcast_copy(torch, params32, params)

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

    def step():
        return train_step(model, params, opt, *batch())

    for _ in range(WIDE_WARMUP - 1):  # timed_steps runs the last warm-up
        step()
    losses, wall, launches = timed_steps(torch, step, WIDE_STEPS,
                                         "wide GPT train")
    check_launches(launches, wide_gpt_counts(), WIDE_STEPS,
                   "wide GPT train")
    tok = WIDE_BATCH * WIDE_SEQ * WIDE_STEPS
    flops = model_flops_per_token(WIDE_GPT, WIDE_SEQ) * tok / wall
    n_params = sum(t.numel() for t in param_leaves(params))
    info = {"config": dict(WIDE_GPT, ffn=4 * H, head_dim=H //
                           WIDE_GPT["num_heads"]),
            "source": "Narayanan et al. 2021, Table 1 (39.1B: hidden 8192, "
                      "64 heads, 48 layers, seq 2048, vocab 51200); 2 of "
                      "48 layers",
            "params": n_params, "batch": WIDE_BATCH, "seq": WIDE_SEQ,
            "warmup": WIDE_WARMUP, "steps": WIDE_STEPS, "losses": losses,
            "wall_s": wall, "step_ms": 1e3 * wall / WIDE_STEPS,
            "tokens_per_s": tok / wall, "model_tflops_per_s": flops / 1e12,
            "mfu": flops / BF16_OPS_PER_S,
            "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "vs_plain_path": vs,
            "launches_per_step": {k: v / WIDE_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(torch, step,
                                          info["step_ms"] / 1e3)
    del opt
    for t in param_leaves(params):
        t.grad = None
    torch.cuda.empty_cache()
    return info, launches, (model, params)


def phase_wide_decode(torch, dev, model, params):
    """DecodeEngine.generate on the wide GPT's trained params: batch 16,
    prompt 512, 32 greedy tokens; a warm-up, then two counted passes that
    must be token-identical, each forward's 5 norms on the wide forward
    kernel (5 x 32 a pass), the prefill's 2 bshd flash forwards (wgmma) and
    each decode step's 2 decode_attn launches, nothing else; the prefill
    and a pass timed apart."""
    from apex_tpu_torch.inference import DecodeEngine
    from apex_tpu_torch.ops import decode_attention as D

    c = WIDE_DECODE
    L = WIDE_GPT["num_layers"]
    eng = DecodeEngine(model, max_seq_len=c["cache"], device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, WIDE_GPT["vocab_size"], (c["batch"],
                                                       c["prompt"]),
                           generator=g, device=dev, dtype=torch.int32)
    with torch.no_grad():
        eng.generate(params, prompt, c["new"])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        D.decode_attn_cuda.launches = 0
        runs, pass_s = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(eng.generate(params, prompt, c["new"]))
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        launches = read_counters()
        launches["decode_attn"] = D.decode_attn_cuda.launches
        cache = eng.init_cache(c["batch"])
        pre_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(params, prompt, cache=cache)
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
    steps = c["new"] - 1
    check_launches(launches, {"ln_fwd_wide": (2 * L + 1) * (1 + steps),
                              "flash_fwd_bshd": L,
                              "flash_fwd_bshd_wgmma": L,
                              "decode_attn": L * steps}, 2, "wide decode")
    check(torch.equal(runs[0], runs[1]),
          "wide decode: the two greedy passes differ")
    check(((runs[0] >= 0) & (runs[0] < WIDE_GPT["vocab_size"])).all()
          .item(), "wide decode: a token outside the vocabulary")
    decode_s = min(pass_s) - min(pre_s)
    info = {"batch": c["batch"], "prompt": c["prompt"],
            "new_tokens": c["new"], "token_identical_passes": True,
            "prefill_ms": 1e3 * min(pre_s),
            "pass_ms": [1e3 * t for t in pass_s],
            "decode_tokens_per_s": c["batch"] * steps / decode_s,
            "decode_step_ms": 1e3 * decode_s / steps,
            "decode_note": "decode time: the fastest pass less the "
                           "fastest prefill",
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_pass": {k: v / 2 for k, v in launches.items()
                                  if v}}
    return info, launches


def rnnt_inputs(torch, dev):
    """Seeded encoder and predictor outputs, lengths and labels at RNNT's
    widths, and the joint's three bf16 weights (U(+-1/sqrt(fan_in)))."""
    c = RNNT
    g = torch.Generator(device=dev).manual_seed(23)
    B = c["batch"]
    f_len = torch.randint(c["t_min"], c["t_max"] + 1, (B,), generator=g,
                          device=dev)
    y_len = torch.randint(c["u_min"], c["u_max"] + 1, (B,), generator=g,
                          device=dev)
    T, U = int(f_len.max()), int(y_len.max())
    enc = torch.randn((B, T, c["enc"]), generator=g, device=dev).bfloat16()
    pred = torch.randn((B, U + 1, c["pred"]), generator=g,
                       device=dev).bfloat16()
    labels = torch.randint(0, c["vocab"] - 1, (B, U), generator=g,
                           device=dev)

    def weight(out, fan_in):
        w = torch.rand((out, fan_in), generator=g, device=dev) * 2 - 1
        return (w / fan_in ** 0.5).bfloat16().requires_grad_()

    ws = (weight(c["joint"], c["enc"]), weight(c["joint"], c["pred"]),
          weight(c["vocab"], c["joint"]))
    return enc, pred, f_len, y_len, labels, ws


def phase_transducer_rnnt(torch, dev):
    """contrib.transducer at the MLPerf RNN-T joint's widths (RNNT) on
    seeded encoder and predictor outputs (the LSTMs are a later slice):
    the bf16 joint (two projections to 512, TransducerJoint with ReLU and
    the lengths' masking), F.linear to V, the loss in fp32
    (TransducerLoss, the blank last); loss and the logits' gradient against
    the fp64 truth on the same logits; forward and backward ms, the
    card's kernel launches of each (no kernel of the port runs) and the
    peak memory."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.contrib.transducer import (TransducerJoint,
                                                   TransducerLoss)

    enc, pred, f_len, y_len, labels, (w_enc, w_pred, w_out) = rnnt_inputs(
        torch, dev)
    joint, loss_fn = TransducerJoint(relu=True), TransducerLoss()
    blank = RNNT["vocab"] - 1

    def forward():
        h = joint(F.linear(enc, w_enc), F.linear(pred, w_pred), f_len,
                  y_len + 1)
        x = F.linear(h, w_out).float()
        x.retain_grad()
        return x, loss_fn(x, labels, f_len, y_len, blank)

    def backward(loss):
        loss.sum().backward()
        for w in (w_enc, w_pred, w_out):
            w.grad = None

    x, loss = forward()  # warm-up
    backward(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    fwd_s, bwd_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        x, loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.sum().backward()
        torch.cuda.synchronize()
        fwd_s.append(t1 - t0)
        bwd_s.append(time.perf_counter() - t1)
        grad = x.grad
        for w in (w_enc, w_pred, w_out):
            w.grad = None
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_launches(launches, {}, 1, "transducer_rnnt")
    x64 = x.detach().double().requires_grad_()
    loss64 = loss_fn(x64, labels, f_len, y_len, blank)
    loss64.sum().backward()
    loss_err = ((loss.detach().double() - loss64.detach()).abs()
                / loss64.detach().abs()).max().item()
    grad_err = (grad.double() - x64.grad).abs().max().item()
    grad_scale = x64.grad.abs().max().item()
    del x64
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        x, loss = forward()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof_b:
        backward(loss)
        torch.cuda.synchronize()
    kernels = [sum(e.count for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA)
               for p in (prof, prof_b)]
    B, T, U1, V = x.shape
    info = {"config": dict(RNNT),
            "source": "MLPerf Training RNN-T reference, rnn_speech_"
                      "recognition/pytorch/configs/baseline_v3-1023sp.yaml",
            "shape": {"B": B, "T": T, "U+1": U1, "V": V},
            "f_len": f_len.tolist(), "y_len": y_len.tolist(),
            "loss_mean": loss.mean().item(),
            "loss_rel_err_vs_fp64": loss_err, "loss_tol": RNNT_LOSS_TOL,
            "grad_max_abs_err_vs_fp64": grad_err,
            "grad_tol": RNNT_GRAD_TOL * grad_scale,
            "forward_ms": 1e3 * min(fwd_s), "backward_ms": 1e3 * min(bwd_s),
            "lattice_steps": T + U1 - 1,
            "cuda_kernels_forward": kernels[0],
            "cuda_kernels_backward": kernels[1],
            "peak_memory_gb": peak}
    check(loss_err <= RNNT_LOSS_TOL, f"transducer loss vs fp64: {loss_err}")
    check(grad_err <= RNNT_GRAD_TOL * grad_scale,
          f"transducer gradient vs fp64: {grad_err} > "
          f"{RNNT_GRAD_TOL} x {grad_scale}")
    check(all(np.isfinite(v) for v in (info["loss_mean"], grad_err)),
          "transducer loss or gradient not finite")
    del x, loss, grad
    torch.cuda.empty_cache()
    return info, launches


def phase_asp_gpt(torch, dev, dense):
    """ASP on GPT-medium, the train leg's configuration and batch: the
    permutation search on layer 0's dense qkv and mlp_down weights at
    ASP_SWEEPS (seconds, retained magnitude before and after), then
    compute_sparse_masks and apply_masks, and ASP_WARMUP warm-up and
    ASP_STEPS timed steps of wrap_optimizer(FusedAdam): after every step
    each pruned entry exactly 0 and no group of 4 with more than 2 nonzero
    entries (flags kept on the card, read once), the train leg's own
    launches, the loss finite and falling; step ms beside the dense
    leg's."""
    from apex_tpu_torch.contrib.sparsity import (ASP, apply_permutation,
                                                 sum_after_2_to_4)
    from apex_tpu_torch.models.gpt import param_leaves
    from apex_tpu_torch.optimizers import FusedAdam

    model, params = gpt_model(torch, dev, TRAIN, torch.bfloat16)
    asp = ASP()
    search = {}
    for name in ("qkv", "mlp_down"):
        w = params["layers"][0][name]["weight"].detach()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perm = asp.search_permutations({"w": w})["w"]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        before = float(sum_after_2_to_4(w.float()))
        after = float(sum_after_2_to_4(apply_permutation(w.float(), perm)))
        search[name] = {"shape": list(w.shape), "seconds": secs,
                        "max_sweeps": ASP_SWEEPS,
                        "retained_before": before, "retained_after": after,
                        "gain_rel": (after - before) / before}
        check(after >= before, f"ASP search on {name} lost magnitude")
    with torch.no_grad():
        masks = asp.compute_sparse_masks(params)
        params = asp.apply_masks(params, masks)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    pairs = [(p, m) for p, m in zip(leaves, param_leaves(masks)) if m.ndim]
    check(all((m.reshape(-1, 4).sum(-1) == 2).all().item()
              for _, m in pairs), "ASP: a mask group without 2 of 4")
    opt = asp.wrap_optimizer(FusedAdam(leaves, lr=1e-4), masks)
    tokens, targets = gpt_batch(torch, dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        loss = train_step(model, params, opt, tokens, targets)
        with torch.no_grad():
            for p, m in pairs:
                nz = p != 0
                bad.logical_or_((nz & ~m).any())
                bad.logical_or_((nz.reshape(-1, 4).sum(-1) > 2).any())
        return loss

    for _ in range(ASP_WARMUP - 1):
        step()
    losses, wall, launches = timed_steps(torch, step, ASP_STEPS, "asp_gpt")
    L = TRAIN["num_layers"]
    check_launches(launches, {"flash_fwd": L, "flash_fwd_wgmma": L,
                              "flash_bwd_dkv": L, "flash_bwd_dq": L,
                              "flash_bwd_dkv_wgmma": L,
                              "flash_bwd_dq_wgmma": L, "xent_stats": 1,
                              "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + 1},
                   ASP_STEPS, "asp_gpt")
    check(not bad.item(), "ASP: a pruned entry nonzero, or a group with "
          "more than 2 nonzero entries, after a step")
    info = {"search": search, "masked_weights": len(pairs),
            "pruned_share": sum(int((~m).sum()) for _, m in pairs)
            / sum(m.numel() for _, m in pairs),
            "steps": ASP_STEPS, "warmup": ASP_WARMUP, "losses": losses,
            "step_ms": 1e3 * wall / ASP_STEPS,
            "dense_train_step_ms": dense["step_ms"],
            "step_note": "each step also reads every masked weight to "
                         "flag a nonzero pruned entry (on the card)",
            "pruned_entries_zero_after_every_step": True,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: v / ASP_STEPS
                                  for k, v in launches.items() if v}}
    del opt, params, model
    torch.cuda.empty_cache()
    return info, launches


# --- ResNet-50 with the batch-norm kernel; the whole RNN-T step -------------

#: the reference example's defaults (examples/imagenet/main_amp.py:34-54):
#: ResNet-50 v1.5, 224², 1000 classes, global batch 256 on the one card,
#: O2, SGD (lr 0.1, momentum 0.9, weight decay 1e-4), the dynamic loss
#: scale; its --deterministic data (:114-127): a fresh seeded batch a step,
#: each class's images shifted by the class's colour template (N(0, 2²))
RESNET = dict(batch=256, image=224, classes=1000, lr=0.1, momentum=0.9,
              weight_decay=1e-4)
#: warm-up and timed steps: at lr 0.1 the loss climbs above ln 1000 over
#: the first 5-10 steps and falls below it after about 30
RESNET_WARMUP, RESNET_STEPS = 2, 48
#: the batch of the kernel-vs-plain step (the plain path's fp32 copies of
#: every activation would not fit at 256)
RESNET_CHECK_BATCH = 32
#: per step: 53 batch norms forward and backward (bn1 and 32 bn_a/bn_b
#: with the ReLU, 16 bn_c with the residual and the ReLU, 4 bn_proj with
#: neither) and the loss's xent_stats
RESNET_LAUNCHES = {f"bn_{d}{k}": n for d in ("fwd", "bwd")
                   for k, n in (("", 53), ("_res_relu", 16), ("_relu", 33),
                                ("_bare", 4))}
RESNET_LAUNCHES["xent_stats"] = 1
RESNET_EVAL_TOL = 1e-2   # eval logits, kernel vs plain: relative norm
#: the images' scales of the plain path's extra losses (the O2 step's loss
#: rule): the two bf16 paths' batch norms round to bf16 after fp32 sums in
#: other orders, and 53 of them grow those 1-ulp differences into ~5e-4 of
#: the loss (the fp32 paths agree within 1e-6)
RESNET_SCALES = (1 + 2 ** -6, 1 - 2 ** -6, 1 + 2 ** -5, 1 - 2 ** -5)
BN_STAT_TOL = 1e-5       # mean and rstd, of the truth's largest entry
BN_W_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7, "float16": 2 ** -10}
#: the bn_kernel phase's extra dtypes (x, y, scale and bias) at one call
BN_EXTRA = (("float32", "float32", "float32"),
            ("float16", "float16", "float32"))
#: the whole MLPerf RNN-T step (rnn_speech_recognition/pytorch/configs/
#: baseline_v3-1023sp.yaml): 80 filterbanks stacked 3 (240 features), 2
#: LSTM layers of 1024, time stacking x 2, 3 more; a predictor of 2 LSTM
#: layers of 320 over a 320-wide embedding; RNNT's joint and loss; bf16
#: weights, the loss in fp32; FusedSGD on one seeded batch
RNNT_STEP = dict(features=240, pre_layers=2, stack=2, post_layers=3,
                 embed=320, pred_layers=2, lr=1e-3, steps=3)


def resnet50_flops(batch, image, classes):
    """One forward's model FLOPs: 2·MACs of every convolution (from its
    output's size and its weight's shape) and of the fc."""
    from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig

    hw = image // 2
    flops = 2 * batch * hw * hw * 64 * 3 * 49
    hw //= 2
    for _, stride, cin, ch, cout in ResNet50(ResNetConfig()).blocks():
        flops += 2 * batch * hw * hw * cin * ch          # conv_a
        out = hw // stride
        flops += 2 * batch * out * out * ch * ch * 9     # conv_b
        flops += 2 * batch * out * out * ch * cout       # conv_c
        if cin != cout or stride != 1:
            flops += 2 * batch * out * out * cin * cout  # conv_proj
        hw = out
    return flops + 2 * batch * 2048 * classes


def bn_case(torch, dev, M, C, dtypes, residual, seed):
    """Activations like a step's: per-channel offsets and scales and
    per-image shifts (so a left-out chunk moves the statistics), dy
    correlated with x̂ (so dx's x̂ term is large), running statistics."""
    dt, ot, wt = (getattr(torch, n) for n in dtypes)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.rand(C, generator=g, device=dev) * 4 - 2
    s = torch.rand(C, generator=g, device=dev) * 1.5 + 0.5
    img = torch.arange(M, device=dev) * 32 // M
    a = torch.randn((32, C), generator=g, device=dev) * 0.5
    x = (m + s * (torch.randn((M, C), generator=g, device=dev)
                  + a[img])).to(dt)
    xh = (x.float() - m) / s
    dy = (0.5 * torch.randn((M, C), generator=g, device=dev) + 0.5 * xh
          + 0.25).to(ot)
    del xh
    res = (torch.randn((M, C), generator=g, device=dev).to(ot)
           if residual else None)
    sc = (torch.rand(C, generator=g, device=dev) + 0.5).to(wt)
    bi = (torch.randn(C, generator=g, device=dev) * 0.2).to(wt)
    return x, dy, res, sc, bi, (m + 0.1).float(), (s * s).float()


def bn_run(B, case, relu, training=True, fwd_fault=None, bwd_fault=None):
    x, dy, res, sc, bi, rm, rv = case
    y, st = B.bn_fwd_cuda(x, sc, bi, training=training, eps=1e-5,
                          running_mean=rm, running_var=rv, residual=res,
                          relu=relu, out_dtype=dy.dtype,
                          planted_fault=fwd_fault)
    return y, st, B.bn_bwd_cuda(dy, x, y, st, training=training,
                                residual=res is not None, relu=relu,
                                w_dtype=sc.dtype, planted_fault=bwd_fault)


def bn_plain_run(torch, B, case, relu, y_kernel, upcast, training=True):
    """The plain version on the same inputs (fp32 on the upcast ones: the
    truth); its backward given the kernel's y for the ReLU's mask."""
    x, dy, res, sc, bi, rm, rv = case
    f = (lambda t: None if t is None else t.float()) if upcast else (
        lambda t: t)
    y, mean, var = B.bn_plain(f(x), f(sc), f(bi), training=training,
                              eps=1e-5, running_mean=rm, running_var=rv,
                              residual=f(res), relu=relu,
                              out_dtype=torch.float32 if upcast
                              else dy.dtype)
    grads = B.bn_backward_plain(f(dy), f(x), f(y_kernel), f(sc), f(bi),
                                training=training, eps=1e-5,
                                running_mean=rm, running_var=rv,
                                residual=res is not None, relu=relu)
    return y, mean, torch.rsqrt(var + 1e-5), grads


def bn_checks(torch, got, plain, truth, dtypes):
    """{output: [passes, error, limit]}: y, dx and dresidual by the norm
    rule (bf16: 2× the plain version's max abs error + 1e-3; fp16: +
    2^-13 × max(1, the largest); fp32: 1e-5 of the largest), mean and rstd
    within BN_STAT_TOL, dscale and dbias within BN_W_TOL of the largest."""
    dt, ot, wt = dtypes
    y, st, (dx, dres, ds, db) = got
    yp, _, _, (dxp, dresp, _, _) = plain
    yt, mt, rt, (dxt, drest, dst, dbt) = truth

    def rule(a, p, t, dtype):
        err = (a.float() - t.float()).abs().max().item()
        top = t.abs().max().item()
        if dtype == "float32":
            return [err <= 1e-5 * top, err, 1e-5 * top]
        own = (p.float() - t.float()).abs().max().item()
        lim = 2 * own + (1e-3 if dtype == "bfloat16"
                         else 2 ** -13 * max(1.0, top))
        return [err <= lim, err, lim]

    out = {"y": rule(y, yp, yt, ot), "dx": rule(dx, dxp, dxt, dt)}
    if dres is not None:
        out["dres"] = rule(dres, dresp, drest, ot)
    for name, a, b, tol in (("mean", st[0], mt, BN_STAT_TOL),
                            ("rstd", st[2], rt, BN_STAT_TOL),
                            ("dscale", ds, dst, BN_W_TOL[wt]),
                            ("dbias", db, dbt, BN_W_TOL[wt])):
        err = (a.float() - b.float()).abs().max().item()
        lim = tol * b.float().abs().max().item()
        out[name] = [err <= lim, err, lim]
    return out


def bn_call(torch, dev, M, C, residual, relu, hw, dtypes, seed):
    """One call of the kernels against the plain version and the fp32
    truth, twice (bit-identical), and with each planted fault (refused);
    then timed beside the bytes bound, the plain version and F.batch_norm
    on the channels_last view (+ add_, relu_) and its autograd backward."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import batch_norm as B

    case = bn_case(torch, dev, M, C, dtypes, residual, seed)
    got = bn_run(B, case, relu)
    again = bn_run(B, case, relu)
    flat = lambda r: [r[0], r[1], *[t for t in r[2] if t is not None]]  # noqa: E731
    same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    del again
    plain = bn_plain_run(torch, B, case, relu, got[0], False)
    truth = bn_plain_run(torch, B, case, relu, got[0], True)
    checks = bn_checks(torch, got, plain, truth, dtypes)
    faults = {}
    for fwd, bwd in (("drop_last_chunk", None), (None, "drop_xhat_term")):
        bad = bn_run(B, case, relu, fwd_fault=fwd, bwd_fault=bwd)
        fc = bn_checks(torch, bad, plain, truth, dtypes)
        faults[fwd or bwd] = sorted(k for k, v in fc.items() if not v[0])
    del plain, truth, bad
    what = f"bn {M}x{C} res {residual} relu {relu} {dtypes}"
    check(all(v[0] for v in checks.values()),
          f"{what}: the kernels fail the rules: {checks}")
    check(same, f"{what}: the kernels are not bit-identical across runs")
    check(all(faults.values()), f"{what}: a planted fault passed: {faults}")
    x, dy, res, sc, bi, rm, rv = case
    y, st = got[0], got[1]
    del got
    n_img = M // (hw * hw)
    fwd = lambda: B.bn_fwd_cuda(x, sc, bi, training=True, residual=res,  # noqa: E731
                                relu=relu, out_dtype=dy.dtype)
    bwd = lambda: B.bn_bwd_cuda(dy, x, y, st, training=True,  # noqa: E731
                                residual=residual, relu=relu,
                                w_dtype=sc.dtype)
    ms_f = time_ms(fwd, [()], reps=10, trials=3)
    ms_b = time_ms(bwd, [()], reps=10, trials=3)
    plain_f = time_ms(lambda: B.bn_plain(x, sc, bi, training=True, eps=1e-5,
                                         residual=res, relu=relu),
                      [()], reps=2, trials=3)
    leaves = [t.detach().requires_grad_() for t in (x, sc, bi)]
    yp, _, _ = B.bn_plain(*leaves, training=True, eps=1e-5)
    gmask = dy * (y > 0) if relu else dy
    plain_b = time_ms(lambda: torch.autograd.grad(yp, leaves, gmask,
                                                  retain_graph=True),
                      [()], reps=2, trials=3)
    del yp, leaves
    view = lambda t: t.view(n_img, hw, hw, C).permute(0, 3, 1, 2)  # noqa: E731
    lib_in = [view(x).detach().requires_grad_(),
              sc.float().requires_grad_(), bi.float().requires_grad_()]
    if res is not None:
        lib_in.append(view(res).detach().requires_grad_())
    lrm, lrv = rm.clone(), rv.clone()

    def lib_fwd():
        out = F.batch_norm(lib_in[0], lrm, lrv, lib_in[1], lib_in[2],
                           training=True, momentum=0.1, eps=1e-5)
        if res is not None:
            out = out.add_(lib_in[3])
        return out.relu_() if relu else out

    lib_f = time_ms(lib_fwd, [()], reps=10, trials=3)
    yl = lib_fwd()
    lib_b = time_ms(lambda: torch.autograd.grad(yl, lib_in, view(dy),
                                                retain_graph=True), [()],
                    reps=10, trials=3)
    del yl, lib_in
    es = {"float32": 4, "bfloat16": 2, "float16": 2}
    xb, ob = es[dtypes[0]], es[dtypes[1]]
    by_f = M * C * (xb + ob * (2 if residual else 1))
    by_b = M * C * (ob + xb + (ob if relu else 0) + xb
                    + (ob if residual else 0))
    # about ten fp32 operations an element each way (Welford and the
    # apply; the two sums and dx)
    bound_f = bound(by_f, 10 * M * C, FP32_OPS_PER_S)
    bound_b = bound(by_b, 10 * M * C, FP32_OPS_PER_S)
    plan = B._bn_plan(M, C, getattr(torch, dtypes[0]))
    return {"rows": M, "channels": C, "residual": residual, "relu": relu,
            "dtypes": list(dtypes), "plan": plan._asdict(),
            "checks": checks, "faults_refused_by": faults,
            "bit_identical": same,
            "fwd": {"ms": ms_f, "plain_ms": plain_f, "library_ms": lib_f,
                    "bound_ms": bound_f[0], "bound_by": bound_f[1]},
            "bwd": {"ms": ms_b, "plain_ms": plain_b, "library_ms": lib_b,
                    "bound_ms": bound_b[0], "bound_by": bound_b[1]}}


def phase_bn_kernel(torch, dev):
    """``csrc/batch_norm.cu`` at each distinct call of ResNet-50's step at
    batch 256 (bf16 x, y and parameters, as the O2 step), and at one call
    in fp32 and in fp16 (fp32 parameters): see :func:`bn_call`. Returns
    the kernels line's two entries and the per-call info."""
    from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig

    c = RESNET
    calls = ResNet50(ResNetConfig()).bn_calls(c["batch"], c["image"])
    distinct = list(dict.fromkeys(calls))
    per_call = {}
    for i, (M, C, res, relu, hw) in enumerate(distinct):
        key = f"{M}x{C}{' res' if res else ''}{' relu' if relu else ''}"
        per_call[key] = bn_call(torch, dev, M, C, res, relu, hw,
                                ("bfloat16",) * 3, seed=i)
        per_call[key]["calls_a_step"] = calls.count((M, C, res, relu, hw))
        torch.cuda.empty_cache()
    M, C, res, relu, hw = distinct[2]  # stage 1's bn_c, 802816 x 256
    for dtypes in BN_EXTRA:
        per_call[f"{M}x{C} res relu {dtypes[0]}"] = bn_call(
            torch, dev, M, C, res, relu, hw, dtypes, seed=99)
        torch.cuda.empty_cache()
    first = next(iter(per_call.values()))  # bn1: 3,211,264 x 64
    entries = []
    for op, out in (("fwd", "y"), ("bwd", "dx")):
        t = first[op]
        entries.append({
            "name": f"bn_{op}", "route": "cuda",
            "source": "apex_tpu_torch/csrc/batch_norm.cu",
            "replaces": "apex_tpu/parallel/sync_batchnorm.py:52 "
                        "(sync_batch_norm; XLA in the reference, no Pallas "
                        "kernel)",
            "max_abs_err": max(v["checks"][out][1]
                               for v in per_call.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": "F.batch_norm on the channels_last view, + add_ "
                            "and relu_" + (" (autograd backward)"
                                           if op == "bwd" else ""),
            "timed_shape": "ResNet-50 bn1 at batch 256: 3211264 x 64, ReLU, "
                           "bf16",
            "per_shape": {k: dict(v[op], calls_a_step=v.get("calls_a_step"))
                          for k, v in per_call.items()}})
    step_ms = {op: sum(v[op]["ms"] * v.get("calls_a_step", 0)
                       for v in per_call.values()) for op in ("fwd", "bwd")}
    info = {"calls": {k: {kk: v[kk] for kk in ("checks", "faults_refused_by",
                                               "bit_identical", "plan")}
                      for k, v in per_call.items()},
            "step_kernel_ms": step_ms,
            "step_bound_ms": {op: sum(v[op]["bound_ms"]
                                      * v.get("calls_a_step", 0)
                                      for v in per_call.values())
                              for op in ("fwd", "bwd")},
            "step_library_ms": {op: sum(v[op]["library_ms"]
                                        * v.get("calls_a_step", 0)
                                        for v in per_call.values())
                                for op in ("fwd", "bwd")}}
    return entries, info


def resnet_data(torch, dev, classes, seed=1):
    """The example's --deterministic batches: (templates, draw(b, image))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    templates = torch.randn((classes, 1, 1, 3), generator=g,
                            device=dev) * 2.0

    def draw(b, image):
        y = torch.randint(0, classes, (b,), generator=g, device=dev)
        x = torch.randn((b, image, image, 3), generator=g,
                        device=dev) + templates[y]
        return x, y

    return draw


def phase_resnet50_train(torch, dev):
    """The example's ResNet-50 O2 step at its defaults (RESNET): 2 warm-up
    and 48 timed steps, each on a fresh batch, with every counter zeroed
    just before and read just after; the launches a step asserted
    (RESNET_LAUNCHES, nothing else); losses finite and falling; step ms,
    images/s, model TFLOP/s and MFU, peak memory, a profile. Returns (info,
    launches, (model, amp state, bn state, data))."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.utils.pytree import tree_leaves

    c = RESNET
    model = ResNet50(ResNetConfig(num_classes=c["classes"]))
    params, bn_state = model.init(torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    opt = FusedSGD([t for t in tree_leaves(params) if t.is_floating_point()],
                   lr=c["lr"], momentum=c["momentum"],
                   weight_decay=c["weight_decay"])
    st = amp.initialize(params, opt, "O2")
    draw = resnet_data(torch, dev, c["classes"])
    live = {"bn": bn_state}

    def loss_fn(mp, bs, x, y):
        logits, nb = model.apply(mp, bs, x, training=True)
        return softmax_cross_entropy_loss(logits, y, 0.0,
                                          half_to_float=True).mean(), nb

    grad = amp.scaled_value_and_grad(loss_fn, has_aux=True)

    def step():
        x, y = draw(c["batch"], c["image"])
        x = x.to(st.policy.param_dtype)
        with amp.with_policy(st.policy):
            (loss, nb), (grads, finite, st.scaler) = grad(
                st.scaler, st.params.model, live["bn"], x, y)
        amp.apply_updates_with_master(st.params, st.optimizer, grads,
                                      grads_finite=finite)
        live["bn"] = nb
        return loss.detach()

    for _ in range(RESNET_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    losses = [step() for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    check_launches(launches, RESNET_LAUNCHES, RESNET_STEPS, "resnet50_train")
    check(all(np.isfinite(losses)), f"resnet50_train: losses not finite: "
          f"{losses}")
    check(losses[-1] < losses[0]
          and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"resnet50_train: loss did not fall: {losses}")
    step_s = wall / RESNET_STEPS
    flops = 3 * resnet50_flops(c["batch"], c["image"], c["classes"])
    info = {"config": dict(RESNET), "source": "examples/imagenet/"
            "main_amp.py:34-54 (defaults), its --deterministic data "
            "(:114-127)", "reduced": [], "opt_level": "O2",
            "warmup_steps": RESNET_WARMUP, "steps": RESNET_STEPS,
            "losses": losses, "step_ms": 1e3 * step_s,
            "images_per_s": c["batch"] / step_s,
            "model_tflop_per_step": flops / 1e12,
            "model_tflops": flops / step_s / 1e12,
            "mfu": flops / step_s / BF16_OPS_PER_S,
            "peak_memory_gb": peak,
            "skipped_steps": int(st.scaler.skipped_steps),
            "loss_scale": float(st.scaler.loss_scale),
            "launches_per_step": {k: v / RESNET_STEPS
                                  for k, v in launches.items() if v}}
    info["profile"] = phase_train_profile(torch, step, step_s)
    return info, launches, (model, st, live, draw)


def phase_resnet50_checks(torch, dev, trained):
    """Beside the train leg: one step at batch 32 against the plain path
    and an fp32 truth (compare_paths' rules); an eval-mode forward at batch
    256 on the trained running statistics (53 eval launches of the forward
    kernel, none of the backward; logits within RESNET_EVAL_TOL relative
    norm of the plain path's); a stage-1 Bottleneck (256 → 128 → 512,
    stride 2, 56², batch 32) and the conv_bias_relu family at a stage-1
    shape against their plain versions and fp32 truths. Returns (info,
    eval launches)."""
    import torch.nn.functional as F
    from apex_tpu_torch.contrib import conv_bias_relu as cbr
    from apex_tpu_torch.contrib.bottleneck import Bottleneck
    from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.utils.pytree import tree_map

    c = RESNET
    info = {}
    model = ResNet50(ResNetConfig(num_classes=c["classes"]))
    p32, bn0 = model.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    params = tree_map(lambda t: t.bfloat16().requires_grad_(), p32)
    params32 = tree_map(lambda t: t.detach().float().requires_grad_(),
                        params)
    x, y = resnet_data(torch, dev, c["classes"], seed=7)(
        RESNET_CHECK_BATCH, c["image"])

    def run(p, impl, s=1.0):
        xh = (x * s).bfloat16()  # the truth reads the same bf16 images
        logits, _ = model.apply(p, bn0, xh if p is not params32
                                else xh.float(), training=True, impl=impl)
        return softmax_cross_entropy_loss(logits, y, 0.0, half_to_float=True,
                                          impl=impl).mean()

    cmp = compare_paths(torch, run, params, params32,
                        f"initial (seed 0), batch {RESNET_CHECK_BATCH}",
                        False, hold_loss=False)
    # the loss: the network is invariant to the images' scale (bn1
    # normalizes conv1's output), so the plain path's losses on the scaled
    # images are other roundings of the same loss; the kernel path's error
    # from the truth must lie within twice their spread + TRAIN_LOSS_TOL
    loss_t = cmp["loss_fp32_truth"]
    with torch.no_grad():
        spread = max([abs(cmp["loss_plain"] - loss_t)]
                     + [abs(run(params, "torch", s).item() - loss_t)
                        for s in RESNET_SCALES])
    lim = 2 * spread + TRAIN_LOSS_TOL * abs(loss_t)
    cmp["loss_rule"] = {"kernel_err_vs_truth": abs(cmp["loss_kernel"]
                                                   - loss_t),
                        "plain_spread_vs_truth": spread, "limit": lim,
                        "scales": list(RESNET_SCALES)}
    info["vs_plain_path"] = cmp
    check(abs(cmp["loss_kernel"] - loss_t) <= lim,
          f"resnet50 O2 step: the kernel path's loss is further from the "
          f"fp32 truth than the plain path's spread allows: "
          f"{cmp['loss_rule']}")
    del params, params32
    # the same step in fp32 (the kernels' fp32 instances, TF32 off): the
    # loss kernel vs plain within TRAIN_LOSS_TOL; the gradients are
    # reported, not held (at the initial params a 1e-6 change of the
    # images moves the plain path's own leaves by a median 1.8%: ReLU and
    # max-pool near-ties)
    losses, grads = [], []
    for impl in ("auto", "torch"):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), p32)
        logits, _ = model.apply(p, bn0, x, training=True, impl=impl)
        loss = softmax_cross_entropy_loss(logits, y, impl=impl).mean()
        loss.backward()
        losses.append(loss.item())
        grads.append({n: t.grad.float() for n, t in named_leaves(p)})
    errs = [((grads[0][n] - grads[1][n]).norm()
             / grads[1][n].norm().clamp_min(1e-30)).item() for n in grads[1]]
    info["fp32_vs_plain_path"] = {
        "loss_kernel": losses[0], "loss_plain": losses[1],
        "loss_rel_diff": abs(losses[0] - losses[1]) / abs(losses[1]),
        "loss_tol": TRAIN_LOSS_TOL,
        "grad_rel_norm_err_median": statistics.median(errs),
        "grad_rel_norm_err_max": max(errs)}
    check(info["fp32_vs_plain_path"]["loss_rel_diff"] <= TRAIN_LOSS_TOL,
          f"resnet50 fp32 step, kernel vs plain loss: "
          f"{info['fp32_vs_plain_path']}")
    del grads, p, p32, logits, loss
    torch.cuda.empty_cache()
    # eval on the trained running statistics
    model, st, live, draw = trained
    xe, ye = draw(c["batch"], c["image"])
    xe = xe.bfloat16()
    zero_counters()
    with torch.no_grad():
        logits = model.apply(st.params.model, live["bn"], xe,
                             training=False)[0].float()
        torch.cuda.synchronize()
        ev_launches = read_counters()
        plain = model.apply(st.params.model, live["bn"], xe, training=False,
                            impl="torch")[0].float()
    err = ((logits - plain).norm() / plain.norm()).item()
    info["eval"] = {"rel_norm_err_vs_plain": err, "tol": RESNET_EVAL_TOL,
                    "top1_on_a_fresh_batch": (logits.argmax(1) == ye)
                    .float().mean().item(),
                    "launches": {k: v for k, v in ev_launches.items() if v}}
    check(torch.isfinite(logits).all().item() and err <= RESNET_EVAL_TOL,
          f"resnet50 eval: kernel vs plain logits {err}")
    check_launches(ev_launches, {"bn_fwd": 53, "bn_fwd_eval": 53,
                                 "bn_fwd_res_relu": 16, "bn_fwd_relu": 33,
                                 "bn_fwd_bare": 4}, 1, "resnet50_eval")
    del logits, plain, xe
    torch.cuda.empty_cache()
    # a stage-1 bottleneck
    blk = Bottleneck(256, 128, 512, stride=2)
    bp, bs = blk.init(torch.Generator(device=dev).manual_seed(4), device=dev)
    bparams = tree_map(lambda t: t.bfloat16().requires_grad_(), bp)
    bparams32 = tree_map(lambda t: t.detach().float().requires_grad_(),
                         bparams)
    xb = torch.randn((RESNET_CHECK_BATCH, 56, 56, 256),
                     generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev)
    zero_counters()

    def brun(p, impl):
        half = p is bparams
        h, _ = blk(p, bs, xb.bfloat16() if half else xb, impl=impl)
        return (h.float() ** 2).mean()

    info["bottleneck"] = compare_paths(torch, brun, bparams, bparams32,
                                       "stage 1 block, batch 32", False)
    del bparams, bparams32, xb
    # the conv_bias_relu family, a stage-1 3x3 at stride 2 with XLA's SAME
    g = torch.Generator(device=dev).manual_seed(6)
    xc = torch.randn((RESNET_CHECK_BATCH, 56, 56, 128), generator=g,
                     device=dev)
    w = torch.randn((128, 128, 3, 3), generator=g, device=dev) / 34.0
    b = torch.randn((128,), generator=g, device=dev)
    mask = (torch.rand((RESNET_CHECK_BATCH, 28, 28, 128), generator=g,
                       device=dev) > 0.3).float()
    scale = torch.rand((128,), generator=g, device=dev) + 0.5

    def plain_conv(xx, ww, op):
        h = F.conv2d(F.pad(xx.permute(0, 3, 1, 2).contiguous(),
                           (0, 1, 0, 1)), ww, stride=2).permute(0, 2, 3, 1)
        if op == "conv_frozen_scale_bias_relu":
            return torch.relu(h * scale.to(h.dtype) + b.to(h.dtype))
        h = h + b.to(h.dtype)
        if op == "conv_bias_mask_relu":
            h = h * mask.to(h.dtype)
        return h if op == "conv_bias" else torch.relu(h)

    fam = {}
    for op in ("conv_bias", "conv_bias_relu", "conv_bias_mask_relu",
               "conv_frozen_scale_bias_relu"):
        fn = getattr(cbr, op)
        xh, wh, bh = xc.bfloat16(), w.bfloat16(), b.bfloat16()
        if op == "conv_frozen_scale_bias_relu":
            got = fn(xh, wh, scale.bfloat16(), bh, 2)
        elif op == "conv_bias_mask_relu":
            got = fn(xh, wh, bh, mask.bfloat16(), 2)
        else:
            got = fn(xh, wh, bh, 2)
        truth = plain_conv(xc, w, op)
        plain = plain_conv(xh, wh, op)
        e = (got.float() - truth).abs().max().item()
        own = (plain.float() - truth).abs().max().item()
        lim = 2 * own + 1e-3 * truth.abs().max().item()
        fam[op] = {"max_abs_err": e, "limit": lim}
        check(e <= lim, f"contrib {op} at a stage-1 shape: {e} > {lim}")
    info["conv_bias_relu"] = fam
    info["contrib_launches"] = {k: v for k, v in read_counters().items() if v}
    return info, ev_launches


def rnnt_step_model(torch, dev):
    """The RNN-T step's modules and bf16 weights (seeded): the encoder's
    two LSTM stacks, the predictor's embedding and LSTM, the joint's three
    projections."""
    import apex_tpu_torch.rnn as trnn

    c, j = RNNT_STEP, RNNT
    g = torch.Generator(device=dev).manual_seed(24)
    pre = trnn.LSTM(c["features"], j["enc"], num_layers=c["pre_layers"])
    post = trnn.LSTM(j["enc"] * c["stack"], j["enc"],
                     num_layers=c["post_layers"])
    pred = trnn.LSTM(c["embed"], j["pred"], num_layers=c["pred_layers"])
    bf = torch.bfloat16

    def weight(out, fan_in):
        w = torch.rand((out, fan_in), generator=g, device=dev) * 2 - 1
        return (w / fan_in ** 0.5).to(bf)

    params = {"pre": pre.init(g, bf, dev), "post": post.init(g, bf, dev),
              "pred": pred.init(g, bf, dev),
              "embed": torch.randn((j["vocab"], c["embed"]), generator=g,
                                   device=dev).to(bf),
              "w_enc": weight(j["joint"], j["enc"]),
              "w_pred": weight(j["joint"], j["pred"]),
              "w_out": weight(j["vocab"], j["joint"])}
    return (pre, post, pred), params


def phase_rnnt_train(torch, dev):
    """The whole MLPerf RNN-T step on the port's ``rnn.LSTM`` (RNNT_STEP,
    RNNT): seeded features of 2T frames (T and U as ``rnnt_inputs`` draws
    them), the encoder (2 LSTM layers, the frames stacked in pairs, 3
    more), the predictor (the blank as the start symbol, the embedding, 2
    LSTM layers), contrib's joint (ReLU) and TransducerLoss in fp32, the
    mean loss; a warm-up step, then 3 FusedSGD steps on the same batch:
    losses finite and falling, no kernel of the port launched; forward and
    backward ms, peak memory. (No profile: the step's ~77,000 launches
    take the profiler some 40 s to tabulate.)"""
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.transducer import (TransducerJoint,
                                                   TransducerLoss)
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.utils.pytree import tree_leaves

    c, j = RNNT_STEP, RNNT
    _, _, f_len, y_len, labels, _ = rnnt_inputs(torch, dev)
    B, T, U = j["batch"], int(f_len.max()), int(y_len.max())
    g = torch.Generator(device=dev).manual_seed(25)
    feats = torch.randn((B, c["stack"] * T, c["features"]), generator=g,
                        device=dev).bfloat16()
    (pre, post, pred), params = rnnt_step_model(torch, dev)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    opt = FusedSGD(leaves, lr=c["lr"])
    blank = j["vocab"] - 1
    joint, loss_fn = TransducerJoint(relu=True), TransducerLoss()
    start = torch.full((B, 1), blank, dtype=labels.dtype, device=dev)

    def forward():
        h, _ = pre(params["pre"], feats)
        h = h.reshape(B, T, c["stack"] * j["enc"])
        enc, _ = post(params["post"], h)
        emb = F.embedding(torch.cat([start, labels], 1), params["embed"])
        p, _ = pred(params["pred"], emb)
        hj = joint(F.linear(enc, params["w_enc"]),
                   F.linear(p, params["w_pred"]), f_len, y_len + 1)
        x = F.linear(hj, params["w_out"]).float()
        return loss_fn(x, labels, f_len, y_len, blank).mean()

    loss = forward()  # warm-up
    loss.backward()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    fwd_s, bwd_s, losses = [], [], []
    for _ in range(c["steps"]):
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        fwd_s.append(t1 - t0)
        bwd_s.append(time.perf_counter() - t1)
        losses.append(loss.item())
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_launches(launches, {}, 1, "rnnt_train")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"rnnt_train: losses not finite and falling: {losses}")
    n_params = sum(t.numel() for t in leaves)
    info = {"config": dict(RNNT_STEP, **{k: j[k] for k in (
                "batch", "enc", "pred", "joint", "vocab")}),
            "source": "MLPerf Training RNN-T reference, rnn_speech_"
                      "recognition/pytorch/configs/baseline_v3-1023sp.yaml",
            "assumed": {
                "embedding": "vocab 1024 x 320, N(0, 1), the blank as the "
                             "start symbol",
                "time_stacking": "consecutive frame pairs concatenated "
                                 "(2 x 1024 -> 2048)",
                "dropout": "none in the LSTMs",
                "weights": "U(+-1/sqrt(H)) LSTMs, U(+-1/sqrt(fan_in)) joint",
                "optimizer": f"FusedSGD lr {c['lr']}, one seeded batch"},
            "shape": {"B": B, "encoder_frames": c["stack"] * T, "T": T,
                      "U+1": U + 1, "V": j["vocab"]},
            "parameters": n_params, "losses": losses,
            "forward_ms": 1e3 * min(fwd_s),
            "backward_and_step_ms": 1e3 * min(bwd_s),
            "lstm_time_steps_forward": (c["pre_layers"] * c["stack"] * T
                                        + c["post_layers"] * T
                                        + c["pred_layers"] * (U + 1)),
            "port_launches": {k: v for k, v in launches.items() if v},
            "peak_memory_gb": peak}
    del loss, params, leaves, opt
    torch.cuda.empty_cache()
    return info, launches


def main(argv=None):
    global PARENT, PARENT_ADAM, PTXAS, EMPTY
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive apex_tpu_torch's main "
                                 "paths on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout (e.g. a git archive of the parent "
                    "commit) whose ln_fwd, ln_bwd, softmax_fwd, decode, "
                    "sampling and verify kernels, and whose FusedAdam, "
                    "are timed in turns with this tree's")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import apex_tpu_torch
    if args.parent:
        PARENT_ADAM = load_parent_adam(args.parent)
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

    section("kernels")
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

    section("serve")
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

    section("serve_outside")
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

    section("decode_slice")
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
    torch.cuda.empty_cache()

    section("quant_and_rel")
    # --- quantized pools and the decode bias ---------------------------------
    q_kernels = (phase_quant_decode_kernel(torch, dev)
                 + phase_rel_decode_kernel(torch, dev))
    for k in q_kernels:
        emit("kernel", k)
    kernels += q_kernels
    torch.cuda.empty_cache()
    qs_info, paths["quant_serve"] = phase_quant_serve(torch, model, params,
                                                      dev, greedy)
    emit("quant_serve", qs_info)
    torch.cuda.empty_cache()
    rd_info, paths["rel_decode"] = phase_rel_decode(torch, model, params,
                                                    dev)
    emit("rel_decode", rd_info)
    torch.cuda.empty_cache()

    section("telemetry_and_swap")
    # --- serving telemetry and weight hot-swap --------------------------------
    st_info, paths["serve_telemetry"] = phase_serve_telemetry(
        torch, model, params, dev)
    emit("serve_telemetry", st_info)
    torch.cuda.empty_cache()
    sw_info, paths["serve_swap"] = phase_serve_swap(torch, model, params, dev)
    emit("serve_swap", sw_info)
    del model, params
    torch.cuda.empty_cache()

    section("gpt_train")
    # --- the train path -------------------------------------------------------
    state, t_info, paths["gpt_train"] = phase_train(torch, dev)
    emit("train", t_info)
    phase_train_plain(torch, *state[:2], *state[3:])
    emit("train_profile", phase_train_profile(
        torch, lambda: train_step(*state), t_info["step_ms"] / 1e3))
    del state
    torch.cuda.empty_cache()

    section("dropout")
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

    section("amp")
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
    fo_info, paths["gpt_fp16_optimizer_train"] = \
        phase_gpt_fp16_optimizer_train(torch, dev, a2_info)
    emit("gpt_fp16_optimizer_train", fo_info)

    section("t5")
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

    section("bert")
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
    # the BERT step under LAMB: NVIDIA's recipe, then mixed precision
    bl_info, paths["bert_lamb_train"] = phase_bert_lamb_train(
        torch, dev, False, {"bert_train (FusedAdam)": b_info})
    emit("bert_lamb_train", bl_info)
    bm_info, paths["bert_mp_lamb_train"] = phase_bert_lamb_train(
        torch, dev, True, {"bert_train (FusedAdam)": b_info,
                           "bert_lamb_train": bl_info})
    emit("bert_mp_lamb_train", bm_info)
    torch.cuda.empty_cache()
    # the bucketed bias on the seq-major kernels, at BERT's call
    br_kernels, paths["bshd_rel_attention"] = phase_bshd_rel_kernels(torch,
                                                                     dev)
    for k in br_kernels:
        emit("kernel", k)
    kernels += br_kernels
    torch.cuda.empty_cache()
    # the encoder-serving entry on BERT-large
    en_info, paths["encoder"] = phase_encoder(torch, dev)
    emit("encoder", en_info)
    torch.cuda.empty_cache()

    section("array_bias")
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

    section("softmax_routes")
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

    section("dense_mlp")
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

    section("optimizers")
    # --- the optimizers: LARC + SGD on the MLP leg, each optimizer's step --
    ml_info, paths["mlp_larc_sgd"] = phase_mlp_larc_sgd(torch, dev, m_info)
    emit("mlp_larc_sgd", ml_info)
    os_info, paths["optimizer_steps"] = phase_optimizer_steps(torch, dev)
    emit("optimizer_steps", os_info)
    torch.cuda.empty_cache()

    section("contrib_losses")
    # --- dropout beside the array bias; the loss ops, contrib's attention --
    bd_by_kernel, bd_errs = phase_bias_dropout_kernels(torch, dev)
    by_name = {k["name"]: k for k in kernels}
    for kname, calls in bd_by_kernel.items():
        by_name[kname]["bias_dropout"] = calls
        op = ("fwd" if "fwd" in kname else "dbias" if "dbias" in kname
              else "dq" if kname.endswith("_dq") else "dkv")
        by_name[kname]["max_abs_err"] = max(by_name[kname]["max_abs_err"],
                                            bd_errs[op])
    torch.cuda.empty_cache()
    tb_info, paths["transformer_big_train"] = phase_transformer_big_train(
        torch, dev)
    emit("transformer_big_train", tb_info)
    fv_info, paths["fmha_varlen"] = phase_fmha_varlen(torch, dev)
    emit("fmha_varlen", fv_info)
    lo_info, paths["loss_ops"] = phase_loss_ops(torch, dev)
    emit("loss_ops", lo_info)
    torch.cuda.empty_cache()

    section("wide_norms_transducer_asp")
    # --- the wide norms, FastLayerNorm, the RNN-T transducer, ASP ----------
    lw_kernels, paths["ln_wide"] = phase_ln_wide(torch, dev)
    for k in lw_kernels:
        emit("kernel", k)
    kernels += lw_kernels
    torch.cuda.empty_cache()
    wg_info, paths["wide_gpt_train"], wide = phase_wide_gpt_train(torch, dev)
    emit("wide_gpt_train", wg_info)
    wd_info, paths["wide_decode"] = phase_wide_decode(torch, dev, *wide)
    emit("wide_decode", wd_info)
    del wide
    torch.cuda.empty_cache()
    tr_info, paths["transducer_rnnt"] = phase_transducer_rnnt(torch, dev)
    emit("transducer_rnnt", tr_info)
    as_info, paths["asp_gpt"] = phase_asp_gpt(torch, dev, t_info)
    emit("asp_gpt", as_info)
    torch.cuda.empty_cache()

    section("resnet_rnnt")
    # --- ResNet-50 and its batch-norm kernel, contrib's conv blocks, the
    # whole RNN-T step on rnn/'s LSTMs -----------------------------------
    bn_entries, bn_info = phase_bn_kernel(torch, dev)
    emit("bn_kernel_check", bn_info)
    for k in bn_entries:
        emit("kernel", k)
    kernels += bn_entries
    torch.cuda.empty_cache()
    rn_info, paths["resnet50_train"], trained = phase_resnet50_train(torch,
                                                                     dev)
    emit("resnet50_train", rn_info)
    rc_info, paths["resnet50_eval"] = phase_resnet50_checks(torch, dev,
                                                            trained)
    emit("resnet50_checks", rc_info)
    del trained
    torch.cuda.empty_cache()
    rt_info, paths["rnnt_train"] = phase_rnnt_train(torch, dev)
    emit("rnnt_train", rt_info)

    section(None)
    emit("section_seconds", dict(SECTION_SECONDS, build=build_s,
                                 total=time.perf_counter() - t_main))
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
