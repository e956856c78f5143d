"""The softmax backward's skip, on the CPU: what ``softmax_bwd_kernel``
(``apex_tpu_torch/csrc/softmax.cu``) reads, emulated in numpy, against the
JAX package's ``softmax_bwd`` (``apex_tpu/ops/pallas/softmax.py``, in
interpret mode) and the port's plain ``_torch_bwd``; and the wiring that
tells the backward the forward's mask.

The emulation walks a row as the kernel does. The row is cut into chunks
of 16 bytes (8 bf16 or 4 fp32 elements), and lane l of the row's L lanes
holds chunks l, l + L, ...: 8 lanes where a row has at most 16 chunks
(four rows a warp), else 32. It reads the forward's mask through
``mask_view``'s byte strides. It loads dy and y only in chunks with a
live entry. It also loads the y of the guard's chunk: the guard is the
first masked entry of the first lane that has one. A row whose guard y
is not 0 is read whole. Otherwise its masked entries count 0 in the dot
and get dx 0. The dot is each lane's partial sum in chunk order, then
the lanes' xor shuffles in fp32. Rows longer than 64 elements a lane
(2048 bf16, 256 chunks) are read whole, as the kernel's long path does.

Tolerance: 2e-4 of the largest entry, as ``tests/test_torch_softmax.py``
states (fp32 sums in another order). y comes from the reference's
forward (Pallas in interpret mode) on the same seeded scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas import softmax as jk
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer import enums
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

SCALE = 0.125
GRAD_RTOL = 2e-4


def _lanes(n, es):
    """(V, L, C): elements a chunk, lanes a row, chunks a lane; C 0 for a
    row the kernel's long path takes."""
    v = 16 // es
    chunks = -(-n // v)
    if chunks <= 16:
        return v, 8, -(-chunks // 8)
    elems = -(-chunks // 32) * v
    e = next((e for e in (8, 16, 32, 64) if elems <= e), 0)
    return v, 32, e // v


def _chunks(n, es, count):
    """The elements of each of a row's first ``count`` chunks."""
    v = 16 // es
    return [np.arange(min(j * v, n), min(j * v + v, n))
            for j in range(count)]


def _masked(shape, mask, causal):
    """The forward's masked entries, (rows, sk), read as the kernel reads
    them: causal from the query index, a mask through ``mask_view``'s
    byte strides (row r is (r // (h q), r // q % h, r % q))."""
    sq, sk = shape[-2], shape[-1]
    rows = int(np.prod(shape[:-1]))
    if causal:
        q = np.arange(rows) % sq
        return np.arange(sk)[None, :] > q[:, None]
    if mask is None:
        return np.zeros((rows, sk), bool)
    v = tsm.mask_view(mask, shape)
    _, h, qn, _ = v.shape
    sb, sh, sq_, sk_ = v.stride()
    store = np.frombuffer(bytes(v.untyped_storage()), np.uint8)
    r = np.arange(rows)
    start = (v.storage_offset() + (r // (h * qn)) * sb
             + (r // qn % h) * sh + (r % qn) * sq_)
    return store[start[:, None] + np.arange(sk)[None, :] * sk_] != 0


def emulate_bwd(dy, y, scale, dead, es):
    """The kernel's dx on (rows, n) fp32 dy and y, with ``dead`` the
    forward's masked entries and ``es`` the element size it runs at:
    (dx, dy entries read, y entries read, rows read whole)."""
    rows, n = y.shape
    v, lanes, c_n = _lanes(n, es)
    dx = np.zeros_like(y)
    read_dy = np.zeros((rows, n), bool)
    read_y = np.zeros((rows, n), bool)
    whole = np.zeros(rows, bool)
    s = np.float32(scale)
    for r in range(rows):
        if c_n == 0:  # the long path: every entry
            read_dy[r] = read_y[r] = whole[r] = True
            dot = np.float32((dy[r] * y[r]).sum(dtype=np.float32))
            dx[r] = s * y[r] * (dy[r] - dot)
            continue
        chunk = _chunks(n, es, lanes * c_n)
        assert sum(len(idx) for idx in chunk) == n
        mk = [dead[r, idx] for idx in chunk]
        live = [len(idx) > 0 and not m.all() for idx, m in zip(chunk, mk)]
        own = [[lane + lanes * c for c in range(c_n)]
               for lane in range(lanes)]
        guard = None
        for lane in range(lanes):
            hit = [j for j in own[lane] if mk[j].any()]
            if hit:
                guard = (hit[0], chunk[hit[0]][np.argmax(mk[hit[0]])])
                break
        for j, idx in enumerate(chunk):
            if live[j]:
                read_dy[r, idx] = read_y[r, idx] = True
        if guard is not None:
            read_y[r, chunk[guard[0]]] = True
            guard = guard[1]
        whole[r] = guard is not None and y[r, guard] != 0
        if whole[r]:
            read_dy[r] = read_y[r] = True
        keep = read_dy[r] & (whole[r] | ~dead[r])
        part = np.zeros(lanes, np.float32)
        for lane in range(lanes):
            acc = np.float32(0)
            for j in own[lane]:
                for i in chunk[j]:
                    if keep[i]:
                        acc = np.float32(acc + dy[r, i] * y[r, i])
            part[lane] = acc
        o = lanes // 2
        while o:
            part = (part + part[np.arange(lanes) ^ o]).astype(np.float32)
            o //= 2
        dx[r] = np.where(keep, s * y[r] * (dy[r] - part[0]), 0)
    return dx, read_dy, read_y, whole


def _case(shape, kind, seed):
    """Seeded fp32 scores and dy at ``shape``, and the call's mask (True =
    masked): "causal" (none: the triangle), "key" ((b, 1, 1, sk), lengths
    3/4 of sk, 0 and sk), "tril" (T5's (1, 1, sq, sk) triangle) or
    "strided" (a key mask read through a key stride of 2)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    b, _, sq, sk = shape
    mask = None
    if kind == "key":
        lens = np.array([sk * 3 // 4, 0] + [sk] * (b - 2))
        mask = torch.tensor(np.arange(sk)[None, :]
                            >= lens[:, None])[:, None, None, :]
    elif kind == "tril":
        mask = ~torch.ones((sq, sk), dtype=torch.bool).tril()[None, None]
    elif kind == "strided":
        wide = torch.tensor(rng.random((b, 1, 1, 2 * sk)) < 0.4)
        wide[0, ..., :2 * sk // 3] = True
        wide[1] = True
        mask = wide[..., ::2]
        assert mask.stride()[-1] == 2
    return x, dy, mask


def _reference(x, dy, mask, causal):
    """y from the reference's Pallas forward (interpret mode) on the
    materialised mask, and its Pallas backward's dx: (rows, sk) each."""
    shape, sk = x.shape, x.shape[-1]
    x2 = jnp.asarray(x.reshape(-1, sk))
    m2 = None if mask is None else jnp.asarray(
        torch.broadcast_to(mask, shape).reshape(-1, sk).numpy()
        .astype(np.int8))
    y = jk.softmax_fwd(x2, m2, scale=SCALE, causal=causal, sq=shape[-2],
                       interpret=True)
    dx = jk.softmax_bwd(jnp.asarray(dy.reshape(-1, sk)), y, scale=SCALE,
                        interpret=True)
    return np.asarray(y), np.asarray(dx)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    tol = GRAD_RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


CASES = [pytest.param((2, 2, 40, 40), "causal", id="causal"),
         pytest.param((2, 2, 16, 300), "causal", id="causal-sq<sk"),
         pytest.param((3, 2, 16, 128), "key", id="key-full-row"),
         pytest.param((2, 2, 114, 114), "tril", id="t5-tril-114"),
         pytest.param((3, 2, 8, 96), "strided", id="strided")]


@pytest.mark.parametrize("es", [2, 4], ids=["bf16-chunks", "fp32-chunks"])
@pytest.mark.parametrize("shape,kind", CASES)
def test_emulated_skip_matches_the_reference(shape, kind, es):
    """The kernel's reads give the reference's dx: masked chunks never
    read on rows whose guard is 0 (y only at the guard's chunk), fully
    masked rows read whole, within 2e-4 of the largest entry of the JAX
    ``softmax_bwd`` (interpret mode) and ``_torch_bwd``."""
    x, dy, mask = _case(shape, kind, seed=shape[-1] + es)
    causal = kind == "causal"
    y, dx_ref = _reference(x, dy, mask, causal)
    dy2 = dy.reshape(y.shape)
    dead = _masked(shape, mask, causal)
    dx, read_dy, read_y, whole = emulate_bwd(dy2, y, SCALE, dead, es)
    _close(dx, dx_ref, "emulation vs the JAX softmax_bwd")
    plain = tsm._torch_bwd(torch.tensor(dy2), torch.tensor(y), SCALE)
    _close(dx, plain.numpy(), "emulation vs _torch_bwd")
    full = dead.all(-1)
    assert (whole == full).all()  # y 0 at every masked entry of live rows
    n = y.shape[-1]
    skipped = np.zeros_like(dead)
    for r in range(len(y)):
        for idx in _chunks(n, es, n):
            if len(idx) and dead[r, idx].all() and not whole[r]:
                skipped[r, idx] = True
    assert skipped.any()
    assert not (read_dy & skipped).any()
    # y beyond the live chunks: the guard's chunk alone, one a row
    assert ((read_y & skipped).sum(-1) <= 16 // es).all()
    assert (read_dy[full]).all() and (read_y[full]).all()
    assert (dx[dead & ~full[:, None]] == 0).all()


@pytest.mark.parametrize("shape,kind", CASES)
def test_emulated_skip_ignores_nan_dy_at_masked_entries(shape, kind):
    """NaN in dy at the masked entries of rows with a live entry changes
    nothing: the emulation on it equals itself on clean dy, bit for bit,
    and the plain version on clean dy within 2e-4 of the largest entry."""
    x, dy, mask = _case(shape, kind, seed=shape[-1] + 7)
    causal = kind == "causal"
    y, _ = _reference(x, dy, mask, causal)
    dy2 = dy.reshape(y.shape)
    dead = _masked(shape, mask, causal)
    poison = dead & ~dead.all(-1)[:, None]
    assert poison.any()
    bad = np.where(poison, np.float32(np.nan), dy2)
    dx_bad = emulate_bwd(bad, y, SCALE, dead, 2)[0]
    dx = emulate_bwd(dy2, y, SCALE, dead, 2)[0]
    assert np.isfinite(dx_bad).all()
    np.testing.assert_array_equal(dx_bad, dx)
    plain = tsm._torch_bwd(torch.tensor(dy2), torch.tensor(y), SCALE)
    _close(dx_bad, plain.numpy(), "poisoned emulation vs clean _torch_bwd")
    # the reference itself turns such a row to NaN: the divergence
    assert np.isnan(tsm._torch_bwd(torch.tensor(bad), torch.tensor(y),
                                   SCALE).numpy()).any()


@pytest.mark.parametrize("es", [2, 4], ids=["bf16-chunks", "fp32-chunks"])
def test_pathological_row_is_read_whole(es):
    """A row whose live scaled scores lie near -9950, 50 above MASK_FILL:
    its masked y is exp(-50)-small but not 0, so the guard sends it down
    the whole-row read, and dx equals the reference's there too."""
    shape = (1, 1, 6, 128)
    x, dy, mask = _case(shape, "key", seed=3)
    mask = torch.zeros((1, 1, 1, 128), dtype=torch.bool)
    mask[..., 100:] = True
    x[0, 0, 2] = x[0, 0, 2] / 40 - 9950 / SCALE
    y, dx_ref = _reference(x, dy, mask, False)
    dead = _masked(shape, mask, False)
    assert y[2, 100] > 0 and (y[[0, 1, 3], 100:] == 0).all()
    dx, read_dy, read_y, whole = emulate_bwd(dy.reshape(y.shape), y, SCALE,
                                             dead, es)
    assert whole.tolist() == [False, False, True, False, False, False]
    assert read_dy[2].all() and read_y[2].all()
    assert not read_dy[0, 104:].any()
    _close(dx, dx_ref, "pathological row vs the JAX softmax_bwd")
    assert (dx[2, 100:] != 0).any()


# --- the wiring: the autograd core tells the backward the forward's mask -----

class _Recorder:
    """Recording stand-ins for the two kernel wrappers that run the plain
    versions (the backward on dy with the masked entries of live rows
    zeroed, as the kernel reads it)."""

    def __init__(self):
        self.calls = []

    def fwd(self, x, mask, scale, causal):
        self.calls.append(("fwd", causal, mask, x.shape[-2]))
        return tsm._torch_fwd(x, mask, scale, causal)

    def bwd(self, dy, y, scale, *, causal=False, mask=None):
        self.calls.append(("bwd", causal, mask, y.shape[-2]))
        dead = torch.tensor(_masked(y.shape, mask, causal)).reshape(y.shape)
        dy = dy.masked_fill(dead & ~dead.all(-1, keepdim=True), 0)
        return tsm._torch_bwd(dy, y, scale)


def _ops():
    pad = FusedScaleMaskSoftmax(False, True, enums.AttnMaskType.padding,
                                True, None, True, None)
    causal = FusedScaleMaskSoftmax(False, True, enums.AttnMaskType.causal,
                                   True, None, True, None)
    return {
        "scaled_masked_softmax": (
            lambda x, m: tsm.scaled_masked_softmax(x, m, SCALE), True),
        "scaled_upper_triang_masked_softmax": (
            lambda x, m: tsm.scaled_upper_triang_masked_softmax(x, SCALE),
            False),
        "fused_padding": (lambda x, m: pad(x, m), True),
        "fused_causal": (lambda x, m: causal(x, None), False)}


@pytest.mark.parametrize("op", list(_ops()))
def test_the_backward_is_told_the_forwards_mask(monkeypatch, op):
    """On the kernel route, each public op and ``FusedScaleMaskSoftmax``
    hand the backward wrapper the forward's ``causal``, the very mask
    tensor and sq; the gradient equals the plain route's."""
    rec = _Recorder()
    monkeypatch.setattr(tsm, "softmax_fwd_cuda", rec.fwd)
    monkeypatch.setattr(tsm, "softmax_bwd_cuda", rec.bwd)
    fn, masked = _ops()[op]
    x, dy, mask = _case((2, 3, 128, 128), "key", seed=11)
    mask = mask if masked else None
    grads = []
    for kernel in (True, False):
        monkeypatch.setattr(tsm._backend, "use_kernel",
                            lambda t, impl="auto", k=kernel: k)
        leaf = torch.tensor(x).bfloat16().float().requires_grad_()
        fn(leaf, mask).backward(torch.tensor(dy))
        grads.append(leaf.grad)
    (f, fc, fm, fsq), (b, bc, bm, bsq) = rec.calls
    assert (f, b) == ("fwd", "bwd")
    assert (fc, fsq) == (bc, bsq) == (not masked, 128)
    assert fm is mask and bm is mask
    _close(grads[0].numpy(), grads[1].numpy(), "kernel route vs plain")


def test_an_inplace_edit_of_the_mask_is_caught(monkeypatch):
    """The saved mask is checked by autograd: flipping it between the
    forward and the backward raises, rather than skipping other entries
    than the forward masked."""
    rec = _Recorder()
    monkeypatch.setattr(tsm, "softmax_fwd_cuda", rec.fwd)
    monkeypatch.setattr(tsm, "softmax_bwd_cuda", rec.bwd)
    monkeypatch.setattr(tsm._backend, "use_kernel",
                        lambda t, impl="auto": True)
    x, dy, mask = _case((2, 2, 8, 64), "key", seed=2)
    leaf = torch.tensor(x).requires_grad_()
    y = tsm.scaled_masked_softmax(leaf, mask, SCALE)
    mask[0, ..., :4] = True
    with pytest.raises(RuntimeError, match="inplace"):
        y.backward(torch.tensor(dy))
