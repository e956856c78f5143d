"""Fused speculative-decoding verification: target logit rows + drafted
tokens → (longest accepted prefix or path, corrected next token).

Port of ``apex_tpu/ops/fused_verify.py`` (``:53-223``) and the acceptance
helpers of ``apex_tpu/ops/pallas/verify.py`` (``:66-242``), which are the
plain version here. Dispatch follows :mod:`apex_tpu_torch.ops._backend`: a
CUDA tensor launches :func:`fused_verify_cuda` or
:func:`fused_verify_tree_cuda` (the hand-written kernels of
``apex_tpu_torch/csrc/fused_verify.cu``, replacing the Pallas
``fused_verify_fwd`` and ``fused_verify_tree_fwd``), a CPU tensor runs the
helpers.

The kernels put every verify row on its own thread-block cluster (b × N1
clusters in one launch; :func:`_verify_plan` picks the cluster size, the
threads and the values a thread from the shapes and the card's SM count
alone), run the sampler's cluster code (``csrc/sample_cluster.cuh``:
radix-select top-k, fixed-point masses, rank-ordered merges) on each row,
and resolve the tree in the same launch: each row publishes its candidate
and its children's verdicts into fixed slots of a workspace the wrapper
owns (:func:`_workspace`), and the last row of a batch row to arrive
takes the deepest accepted path.

Acceptance is exact. Greedy (temperature 0): a draft is accepted iff it
equals the argmax of its target row (ties to the lowest index), so the
spec stream is token-identical to greedy decoding. Sampled: point-mass
rejection sampling under the temperature → top-k distribution of
:mod:`apex_tpu_torch.ops.sampling` (its plain filter here, its kernel's
radix select on the card): a draft d is accepted iff ``u_acc < p(d)``, and
the correction is a Gumbel-argmax draw on ``u_gum`` with the rejected
drafts filtered out. ``top_p < 1`` (the serve's sampled spec rounds) adds
the nucleus filter after top-k: a drafted token outside the nucleus has
p = 0 and is never accepted.

The noise is drawn from the caller's ``torch.Generator``, or passed as
``u_acc``/``u_gum`` (the tests pass JAX's draws): both uniform in
(tiny, 1]. torch cannot reproduce JAX's threefry bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _backend, _build
from apex_tpu_torch.ops.matmul import _sm_count
from apex_tpu_torch.ops.sampling import (FILTERED, KERNEL_MAX_VOCAB,
                                         SAMPLE_MIN_SHARE, SAMPLE_SMEM,
                                         SAMPLE_SPLITS, _fit, _share,
                                         filtered_scaled, gumbel_argmax,
                                         uniform_noise)

#: sentinel drafted id for the bonus row (``verify.py:56``): never equals a
#: candidate, so its accept flag is always False
NO_DRAFT = -1

#: the most verify rows (k+1 or N+1) one kernel launch takes
KERNEL_MAX_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: a CTA's threads and values a thread where a share does not fit the
#: registers (greedy mode only, V > 131072: it walks its share in a loop)
VERIFY_LOOP_FIT = (512, 32)
#: the verify's own shared state in ``VerifyShared`` (``csrc/
#: fused_verify.cu``, bytes): the ranks' and the warps' masses, the row's
#: child tokens, the resolver's candidates, accept bits and the tree's
#: ancestor bits (128 nodes x 4 words)
_VERIFY_OWN_SMEM = 8 * 8 + 32 * 8 + 128 * 4 + 4 + 4 + 8 + 128 * 4 + 16 \
    + 128 * 4 * 4
#: a CTA's static shared memory without top-p: the sampler's row state
#: (two 256-bin u64 histograms, the scan's totals, the digit, the keys,
#: the ranks' and the warps' draws: 4640) and the verify's own
VERIFY_SMEM = 4640 + _VERIFY_OWN_SMEM
#: ... in the top-p instance: the sampler's with rank 0's gathered top-k
#: survivors (:data:`~apex_tpu_torch.ops.sampling.SAMPLE_SMEM`) and the
#: verify's own
VERIFY_TOP_P_SMEM = SAMPLE_SMEM + _VERIFY_OWN_SMEM
#: planted faults of the kernels' tests: the last rank of a cluster left
#: out of every merge; row 0's slots never published; top-p skipped
PLANTED_FAULTS = ("drop_last_rank", "no_publish", "no_top_p")


class VerifyPlan(NamedTuple):
    """One verify launch: each of the b × N1 rows over a cluster of
    ``splits`` CTAs of ``threads`` threads; rank r holds ``share`` values
    of its row (the last rank what is left), ``values`` a thread in
    registers in sampled mode; ``smem`` bytes of static shared memory a
    CTA of the instance without top-p (:data:`VERIFY_TOP_P_SMEM` that of
    the one with it)."""
    splits: int
    threads: int
    values: int
    share: int
    smem: int


@functools.lru_cache(maxsize=None)
def _verify_plan(b: int, n1: int, V: int, sms: int) -> VerifyPlan:
    """The verify launch from the shapes and the card's ``sms`` alone
    (never the logits), as :func:`~apex_tpu_torch.ops.sampling._sample_plan`
    plans a sampling launch: the least cluster size S whose shares fit a
    CTA's registers (V 32768 needs S 2), raised to the largest S that keeps
    the grid of b × N1 × S CTAs within one CTA an SM and each rank's share
    at least ``SAMPLE_MIN_SHARE`` values. Where b × N1 rows at the least S
    exceed the SMs (b 4 × N1 33 is 132 rows) the grid runs in waves. The
    spec leg's chain (1, 5) and tree (1, 9) take S 8."""
    if not 2 <= n1 <= KERNEL_MAX_ROWS:
        raise ValueError(f"the verify kernels take 2 to {KERNEL_MAX_ROWS} "
                         f"verify rows; got {n1}")
    if b < 1 or V < 1:
        raise ValueError(f"the verify kernels take b >= 1 and V >= 1; got "
                         f"b={b}, V={V}")
    rows = b * n1
    least = next((S for S in SAMPLE_SPLITS if _fit(_share(V, S))),
                 SAMPLE_SPLITS[0])
    splits = least
    for S in SAMPLE_SPLITS:
        if S > least and rows * S <= sms \
                and _share(V, S) >= SAMPLE_MIN_SHARE:
            splits = S
    share = _share(V, splits)
    threads, values = _fit(share) or VERIFY_LOOP_FIT
    return VerifyPlan(splits, threads, values, share, VERIFY_SMEM)


def _plan_for(logits: torch.Tensor) -> VerifyPlan:
    b, n1, V = logits.shape
    index = logits.device.index
    return _verify_plan(b, n1, V, _sm_count(
        torch.cuda.current_device() if index is None else index))


class _Workspace:
    """The verify kernels' scratch on one device and stream: one zeroed
    int32 buffer holding each batch row's arrival counter (``rows``
    entries, zero between calls: the last arriver resets its own) and two
    64-bit slots a node (the row's candidate, the node's accept flag),
    each tagged with its call's epoch, so a slot left from an earlier call
    is never read as this call's. Grown (a new zeroed buffer) when a call
    has more rows; never zeroed again."""

    def __init__(self, rows: int, device: torch.device):
        self.rows = -(-rows // 64) * 64
        self.buf = torch.zeros((5 * self.rows,), dtype=torch.int32,
                               device=device)
        self.epoch = 0

    def pointers(self) -> Tuple[int, int, int]:
        """(slots, arrivals, epoch) for the next launch."""
        self.epoch = self.epoch % (2 ** 31 - 1) + 1
        base = self.buf.data_ptr()
        return base + 4 * self.rows, base, self.epoch


_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(logits: torch.Tensor, stream: int) -> _Workspace:
    """The workspace of ``logits``' device and ``stream``, holding at least
    its b × N1 rows."""
    b, n1, _ = logits.shape
    key = (logits.device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.rows < b * n1:
        ws = _WORKSPACES[key] = _Workspace(b * n1, logits.device)
    return ws


def verify_occupancy(plan: VerifyPlan, dtype: torch.dtype, V: int,
                     tree: bool, top_p: bool = False) -> Tuple[int, int]:
    """(how many of ``plan``'s clusters the card holds at once, a CTA's
    static shared memory in bytes) for the chain or tree kernel, in its
    instance with or without top-p; 0 clusters: the card refuses the
    launch. Needs the card."""
    out = (ctypes.c_int * 2)()
    rc = _build.library().apex_fused_verify_occupancy(
        int(tree), int(top_p), _DTYPE_CODES[dtype], V, plan.splits,
        plan.threads, plan.values, plan.share, out)
    _build.check(rc, "fused_verify_occupancy")
    return out[0], out[1]


# --- plain version: the reference's helpers -----------------------------------

def row_argmax(s: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax with ties to the LOWEST index. (..., V) → (...,)
    int32."""
    m = s.amax(dim=-1, keepdim=True)
    V = s.shape[-1]
    idx = torch.arange(V, device=s.device)
    return torch.where(s == m, idx, V).amin(dim=-1).to(torch.int32)


def accepted_prefix_len(acc: torch.Tensor) -> torch.Tensor:
    """Length of the leading run of True flags: (..., k+1) → (...,) int32."""
    return torch.cumprod(acc.to(torch.int32), dim=-1).sum(dim=-1).to(
        torch.int32)


def select_row(vals: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``vals[..., a]`` at a per-batch index ``a`` (...,)."""
    return vals.gather(-1, a.long()[..., None])[..., 0]


def _token_mass(e: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``t[..., r, c] = e[..., r, tokens[c]]``, 0 where the token lies
    outside [0, V) (NO_DRAFT)."""
    V = e.shape[-1]
    ok = (tokens >= 0) & (tokens < V)
    idx = torch.where(ok, tokens, 0).long()
    idx = idx[..., None, :].expand(*e.shape[:-1], tokens.shape[-1])
    return torch.where(ok[..., None, :], e.gather(-1, idx), 0.0)


def verify_greedy(logits: torch.Tensor, drafted_pad: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy acceptance. ``logits`` (..., k+1, V); ``drafted_pad``
    (..., k+1) int32 with the bonus row :data:`NO_DRAFT`. Returns
    ``(accept_len, next_token)``, each (...,) int32."""
    cand = row_argmax(logits.float())
    a = accepted_prefix_len(cand == drafted_pad)
    return a, select_row(cand, a)


def verify_sampled(logits: torch.Tensor, drafted_pad: torch.Tensor,
                   u_acc: torch.Tensor, u_gum: torch.Tensor, *,
                   temperature: float, top_k: int, top_p: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampling acceptance for point-mass drafts under the
    temperature → top-k → top-p filtered target: row i accepts d_i iff
    ``u_acc_i < p(d_i)``; every row's correction candidate is a
    Gumbel-argmax draw on ``u_gum`` with its drafted token filtered, and
    the first rejected row's candidate is emitted."""
    s = filtered_scaled(logits, temperature=temperature, top_k=top_k,
                        top_p=top_p)
    V = s.shape[-1]
    cols = torch.arange(V, device=s.device)
    onehot = cols == drafted_pad[..., None]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p_d = torch.where(onehot, e, 0.0).sum(dim=-1) / e.sum(dim=-1)
    a = accepted_prefix_len(u_acc < p_d)
    cand = gumbel_argmax(torch.where(onehot, FILTERED, s), u_gum)
    return a, select_row(cand, a)


def tree_depths(anc: torch.Tensor) -> torch.Tensor:
    """Per-node depth from the ancestor-or-self closure (..., N1, N1) →
    (..., N1) int32 (the root has depth 0)."""
    return (anc.to(torch.int32).sum(dim=-1) - 1).to(torch.int32)


def tree_accepted_path(acc: torch.Tensor, anc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deepest fully-accepted root path: ``acc`` (..., N1) per-node
    flags (node 0 forced accepted), ``anc`` (..., N1, N1). Returns
    ``(accept_len, j_star)`` int32, ties to the LOWEST node index."""
    n1 = anc.shape[-1]
    acc_i = acc.to(torch.int32).clone()
    acc_i[..., 0] = 1
    bad = anc.to(torch.int32) * (1 - acc_i)[..., None, :]
    ok = bad.sum(dim=-1) == 0
    depth = tree_depths(anc)
    a = torch.where(ok, depth, -1).amax(dim=-1)
    idx = torch.arange(n1, device=anc.device)
    hit = ok & (depth == a[..., None])
    j_star = torch.where(hit, idx, n1).amin(dim=-1)
    return a.to(torch.int32), j_star.to(torch.int32)


def _parent_onehot(parents: torch.Tensor, n1: int) -> torch.Tensor:
    """``po[..., c, r] = (parents[..., c] == r)``."""
    return torch.arange(n1, device=parents.device) == parents[..., None]


def verify_tree_greedy(logits: torch.Tensor, tokens: torch.Tensor,
                       parents: torch.Tensor, anc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy tree acceptance: node j is accepted iff its parent's
    argmax candidate equals ``tokens[j]`` (row 0 pinned at
    :data:`NO_DRAFT`). Returns ``(accept_len, j_star, next_token)``."""
    cand = row_argmax(logits.float())
    pc = cand.gather(-1, parents.long())                  # cand[parent[c]]
    acc = (pc == tokens) & (tokens != NO_DRAFT)
    a, j_star = tree_accepted_path(acc, anc)
    return a, j_star, select_row(cand, j_star)


def verify_tree_sampled(logits: torch.Tensor, tokens: torch.Tensor,
                        parents: torch.Tensor, anc: torch.Tensor,
                        u_acc: torch.Tensor, u_gum: torch.Tensor, *,
                        temperature: float, top_k: int, top_p: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rejection-sampling tree acceptance under the temperature → top-k
    → top-p filtered target: node j accepts iff ``u_acc[j] <
    p_parent(tokens[j])``; each row's correction candidate filters ALL of
    that node's real drafted children."""
    s = filtered_scaled(logits, temperature=temperature, top_k=top_k,
                        top_p=top_p)                      # (..., N1, V)
    n1 = s.shape[-2]
    real = tokens != NO_DRAFT
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1)                                     # (..., N1)
    t = _token_mass(e, tokens)                            # (..., r, c)
    po = _parent_onehot(parents, n1)                      # (..., c, r)
    tt = t.transpose(-1, -2)                              # (..., c, r)
    p_num = torch.where(po, tt, 0.0).sum(dim=-1)
    p_den = torch.where(po, z[..., None, :], 0.0).sum(dim=-1)
    acc = (u_acc < p_num / p_den) & real
    a, j_star = tree_accepted_path(acc, anc)
    # child[..., r, c]: c is a real drafted child of r; row r filters the
    # tokens of every child it rejected
    child = po.transpose(-1, -2) & real[..., None, :]
    V = s.shape[-1]
    cols = torch.arange(V, device=s.device)
    tok_oh = cols == tokens[..., None]                    # (..., c, V)
    drop = (child.float() @ tok_oh.float()) > 0.5         # (..., r, V)
    cand = gumbel_argmax(torch.where(drop, FILTERED, s), u_gum)
    return a, j_star, select_row(cand, j_star)


# --- the CUDA kernels ---------------------------------------------------------

def _check_kernel(logits: torch.Tensor, ints, floats, name: str) -> None:
    b, n1, V = logits.shape
    if any(t.device != logits.device for t in (*ints, *floats)) \
            or logits.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 logits; got "
                         f"{logits.dtype}")
    if not 2 <= n1 <= KERNEL_MAX_ROWS:
        raise ValueError(f"{name} takes 2 to {KERNEL_MAX_ROWS} verify rows; "
                         f"got {n1}")
    if floats and V > KERNEL_MAX_VOCAB:
        raise ValueError(f"{name}'s sampled mode holds a row of at most "
                         f"{KERNEL_MAX_VOCAB} logits in its cluster's "
                         f"registers; got V={V}")
    if any(t.dtype != torch.int32 for t in ints) \
            or any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"{name}: token operands int32, noise float32")
    if not all(t.is_contiguous() for t in (logits, *ints, *floats)):
        raise ValueError(f"{name} takes contiguous tensors")


def _knobs(temperature: float, top_k: int, top_p: float):
    sampled = temperature > 0.0
    return (int(sampled), 1.0 / temperature if sampled else 1.0, int(top_k),
            int(sampled and top_p < 1.0), float(top_p))


def _launch_args(logits: torch.Tensor, planted_fault: Optional[str]):
    """A launch's arguments around its shapes and knobs: (the workspace's
    slots, counters and epoch, the dtype code), (the plan's splits,
    threads, values and share, the fault code, the stream)."""
    if planted_fault not in (None, *PLANTED_FAULTS):
        raise ValueError(f"no planted fault {planted_fault!r}")
    plan = _plan_for(logits)
    if planted_fault == "drop_last_rank" and plan.splits == 1:
        raise ValueError("drop_last_rank needs a plan of 2 or more ranks")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    fault = 0 if planted_fault is None else \
        1 + PLANTED_FAULTS.index(planted_fault)
    return (*_workspace(logits, stream).pointers(),
            _DTYPE_CODES[logits.dtype]), \
        (plan.splits, plan.threads, plan.values, plan.share, fault, stream)


def fused_verify_cuda(logits: torch.Tensor, drafted_pad: torch.Tensor,
                      u_acc: Optional[torch.Tensor],
                      u_gum: Optional[torch.Tensor], *, temperature: float,
                      top_k: int, top_p: float = 1.0,
                      planted_fault: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the chain verify kernel: logits (b, k+1, V), drafted_pad
    (b, k+1) int32 (bonus NO_DRAFT), and for temperature > 0 u_acc
    (b, k+1) and u_gum (b, k+1, V) fp32. Returns (accept_len, next) (b,)
    int32. ``planted_fault`` (tests only) is one of
    :data:`PLANTED_FAULTS`. Counts its launches in ``.launches``, and
    those with ``temperature > 0`` and ``top_p < 1`` also in
    ``.top_p_launches``."""
    b, k1, V = logits.shape
    floats = () if temperature <= 0 else (u_acc, u_gum)
    _check_kernel(logits, (drafted_pad,), floats, "fused_verify_cuda")
    if drafted_pad.shape != (b, k1) or (floats and (
            u_acc.shape != (b, k1) or u_gum.shape != logits.shape)):
        raise ValueError("fused_verify_cuda: operand shapes disagree")
    a = torch.empty((b,), dtype=torch.int32, device=logits.device)
    nxt = torch.empty_like(a)
    ws, plan = _launch_args(logits, planted_fault)
    rc = _build.library().apex_fused_verify(
        logits.data_ptr(), drafted_pad.data_ptr(),
        floats[0].data_ptr() if floats else None,
        floats[1].data_ptr() if floats else None, a.data_ptr(),
        nxt.data_ptr(), *ws, b, k1, V, *_knobs(temperature, top_k, top_p),
        *plan)
    _build.check(rc, "fused_verify")
    fused_verify_cuda.launches += 1
    fused_verify_cuda.top_p_launches += int(bool(floats) and top_p < 1.0)
    return a, nxt


fused_verify_cuda.launches = 0
fused_verify_cuda.top_p_launches = 0


def fused_verify_tree_cuda(logits: torch.Tensor, tokens: torch.Tensor,
                           parents: torch.Tensor, anc: torch.Tensor,
                           u_acc: Optional[torch.Tensor],
                           u_gum: Optional[torch.Tensor], *,
                           temperature: float, top_k: int,
                           top_p: float = 1.0,
                           planted_fault: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch the tree verify kernel: logits (b, N1, V), tokens/parents
    (b, N1) and anc (b, N1, N1) int32, and for temperature > 0 u_acc
    (b, N1) and u_gum (b, N1, V) fp32. Returns (accept_len, j_star, next)
    (b,) int32. ``planted_fault`` as :func:`fused_verify_cuda`'s. Counts
    its launches as :func:`fused_verify_cuda` does."""
    b, n1, V = logits.shape
    floats = () if temperature <= 0 else (u_acc, u_gum)
    _check_kernel(logits, (tokens, parents, anc), floats,
                  "fused_verify_tree_cuda")
    if tokens.shape != (b, n1) or parents.shape != (b, n1) \
            or anc.shape != (b, n1, n1) or (floats and (
                u_acc.shape != (b, n1) or u_gum.shape != logits.shape)):
        raise ValueError("fused_verify_tree_cuda: operand shapes disagree")
    a = torch.empty((b,), dtype=torch.int32, device=logits.device)
    j_star, nxt = torch.empty_like(a), torch.empty_like(a)
    ws, plan = _launch_args(logits, planted_fault)
    rc = _build.library().apex_fused_verify_tree(
        logits.data_ptr(), tokens.data_ptr(), parents.data_ptr(),
        anc.data_ptr(), floats[0].data_ptr() if floats else None,
        floats[1].data_ptr() if floats else None, a.data_ptr(),
        j_star.data_ptr(), nxt.data_ptr(), *ws, b, n1, V,
        *_knobs(temperature, top_k, top_p), *plan)
    _build.check(rc, "fused_verify_tree")
    fused_verify_tree_cuda.launches += 1
    fused_verify_tree_cuda.top_p_launches += int(bool(floats)
                                                 and top_p < 1.0)
    return a, j_star, nxt


fused_verify_tree_cuda.launches = 0
fused_verify_tree_cuda.top_p_launches = 0


# --- the ops ------------------------------------------------------------------

def _check_knobs(temperature: float, top_k: int, top_p: float) -> None:
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _noise(logits: torch.Tensor, generator: Optional[torch.Generator],
           u_acc: Optional[torch.Tensor], u_gum: Optional[torch.Tensor],
           name: str):
    """(u_acc (b, rows), u_gum (b, rows, V)) fp32 in (tiny, 1]: given, or
    drawn from ``generator`` (acceptance draws first)."""
    b, rows, V = logits.shape
    if (u_acc is None) != (u_gum is None):
        raise ValueError(f"{name}: pass both u_acc and u_gum, or neither")
    if u_acc is None:
        if generator is None:
            raise ValueError(f"temperature > 0 {name} requires a generator "
                             f"(or u_acc and u_gum)")
        u_acc = uniform_noise((b, rows), generator, logits.device)
        u_gum = uniform_noise((b, rows, V), generator, logits.device)
    if u_acc.shape != (b, rows) or u_gum.shape != (b, rows, V) \
            or u_acc.dtype != torch.float32 or u_gum.dtype != torch.float32:
        raise ValueError(
            f"{name}: u_acc must be float32 ({b}, {rows}) and u_gum float32 "
            f"({b}, {rows}, {V}); got {u_acc.dtype} {tuple(u_acc.shape)}, "
            f"{u_gum.dtype} {tuple(u_gum.shape)}")
    return u_acc.contiguous(), u_gum.contiguous()


def fused_verify(logits: torch.Tensor, drafted: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0,
                 u_acc: Optional[torch.Tensor] = None,
                 u_gum: Optional[torch.Tensor] = None, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Verify ``k`` drafted tokens against ``k+1`` target logit rows.

    ``logits`` (b, k+1, V): row i is the target's distribution after the
    prefix plus i accepted drafts (row k is the bonus position).
    ``drafted`` (b, k). Returns ``(accept_len (b,), next_token (b,))``
    int32: one spec round emits ``drafted[:accept_len] + [next_token]``.
    ``temperature > 0`` needs ``generator`` or both ``u_acc`` (b, k+1) and
    ``u_gum`` (b, k+1, V); it filters the target by temperature, then
    ``top_k`` (0 = all), then ``top_p`` (1.0 = all)."""
    if logits.ndim != 3:
        raise ValueError(f"fused_verify takes (b, k+1, V) logits; got "
                         f"{tuple(logits.shape)}")
    b, k1, V = logits.shape
    if drafted.ndim != 2 or tuple(drafted.shape) != (b, k1 - 1):
        raise ValueError(
            f"drafted must be (b={b}, k={k1 - 1}) to match the (b, k+1, V) "
            f"logits; got {tuple(drafted.shape)}")
    if k1 < 2:
        raise ValueError(
            f"fused_verify needs k >= 1 drafted tokens (k+1 = {k1} logit "
            f"rows); a 1-row verify is just sampling — use fused_sample")
    _check_knobs(temperature, top_k, top_p)
    sampled = temperature > 0.0
    drafted_pad = torch.cat(
        [drafted.to(torch.int32),
         torch.full((b, 1), NO_DRAFT, dtype=torch.int32,
                    device=drafted.device)], dim=1)
    top_k = min(int(top_k), V)
    if sampled:
        u_acc, u_gum = _noise(logits, generator, u_acc, u_gum,
                              "fused_verify")
    if _backend.use_kernel(logits, impl):
        return fused_verify_cuda(
            logits.contiguous(), drafted_pad, u_acc, u_gum,
            temperature=float(temperature), top_k=top_k, top_p=float(top_p))
    if sampled:
        return verify_sampled(logits, drafted_pad, u_acc, u_gum,
                              temperature=float(temperature), top_k=top_k,
                              top_p=float(top_p))
    return verify_greedy(logits, drafted_pad)


def fused_verify_tree(logits: torch.Tensor, tokens: torch.Tensor,
                      parents: torch.Tensor, anc: torch.Tensor,
                      generator: Optional[torch.Generator] = None, *,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0,
                      u_acc: Optional[torch.Tensor] = None,
                      u_gum: Optional[torch.Tensor] = None,
                      impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verify a DRAFT TREE of N tokens against N+1 target logit rows.

    ``logits`` (b, N+1, V): row j is the target's distribution after node
    j's token (row 0 after the committed pending token, the root).
    ``tokens`` (b, N+1) node tokens (column 0 ignored: pinned to
    :data:`NO_DRAFT`); ``parents`` (b, N+1) parent pointers
    (``parents[:, j] < j``); ``anc`` (b, N+1, N+1) the ancestor-or-self
    closure. Returns ``(accept_len, j_star, next_token)`` (b,) int32: the
    deepest fully-accepted root path's length, its terminal node, and the
    token drawn from that node's row. The knobs are
    :func:`fused_verify`'s."""
    if logits.ndim != 3:
        raise ValueError(f"fused_verify_tree takes (b, N+1, V) logits; got "
                         f"{tuple(logits.shape)}")
    b, n1, V = logits.shape
    if tuple(tokens.shape) != (b, n1) or tuple(parents.shape) != (b, n1):
        raise ValueError(
            f"tokens/parents must be (b={b}, N+1={n1}) to match the "
            f"(b, N+1, V) logits; got {tuple(tokens.shape)} / "
            f"{tuple(parents.shape)}")
    if tuple(anc.shape) != (b, n1, n1):
        raise ValueError(
            f"anc must be the (b={b}, N+1={n1}, N+1={n1}) ancestor-or-self "
            f"closure; got {tuple(anc.shape)}")
    if n1 < 2:
        raise ValueError(
            f"fused_verify_tree needs N >= 1 drafted nodes (N+1 = {n1} "
            f"logit rows); a 1-row verify is just sampling — use "
            f"fused_sample")
    _check_knobs(temperature, top_k, top_p)
    sampled = temperature > 0.0
    tokens = tokens.to(torch.int32).clone()
    tokens[:, 0] = NO_DRAFT
    parents = parents.to(torch.int32).contiguous()
    anc = anc.to(torch.int32).contiguous()
    top_k = min(int(top_k), V)
    if sampled:
        u_acc, u_gum = _noise(logits, generator, u_acc, u_gum,
                              "fused_verify_tree")
    if _backend.use_kernel(logits, impl):
        return fused_verify_tree_cuda(
            logits.contiguous(), tokens, parents, anc, u_acc, u_gum,
            temperature=float(temperature), top_k=top_k, top_p=float(top_p))
    if sampled:
        return verify_tree_sampled(logits, tokens, parents, anc, u_acc,
                                   u_gum, temperature=float(temperature),
                                   top_k=top_k, top_p=float(top_p))
    return verify_tree_greedy(logits, tokens, parents, anc)
