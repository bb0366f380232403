"""K2, the encode wavefront (``libavif_tpu_torch/csrc/encode_wavefront.cu``),
without a card.

There is no nvcc here, so the CUDA source is held to the plain version
(``wavefront._search`` and ``encode_wavefront_reference``, themselves held
to the JAX package by ``tests/test_torch_encode_step.py``) through numpy
models of its arithmetic, fed the tables and parameters the wrapper hands
the kernel:

- the passes: for a DCT dimension the partial butterfly on the table's
  words (``wavefront.butterfly_words`` / ``butterfly_product``), forward
  and inverse, for the column and the row pass, equal to the direct
  product mod 2^32 on int32 inputs with INT32_MIN and INT32_MAX; IDTX's
  diagonal; and the host's symmetry check refusing a perturbed basis;
- the quantizer's division, a multiply-high by ``division_magic`` with one
  correction (``floor_div``), equal to floor division for the DC and AC
  steps of every qindex at depths 8, 10 and 12, on dense and extreme
  dividends, the wrapped |c| + bias among them;
- the directional prediction from the extended edges and the table words
  of ``ext_word``, equal to the plain predictor;
- the candidate schedule: slots of n threads walking candidates s, s + S,
  ... in index order, each keeping its strict improvements, merged by the
  least cost * 128 + index, which is the first index on ties, for K = 1 ..
  65 at each n;
- a whole block's search in the kernel's arithmetic and order equal to
  ``_search`` (modes, transform symbols, levels, reconstruction);
- the ``StepParams`` layout against its ctypes mirror, and the constants
  the Python side mirrors.

The card tests (``tests/test_torch_cuda.py``) hold the kernel itself to the
plain version on the card.
"""

import re

import numpy as np
import pytest
import torch

from libavif_tpu_torch import tables
from libavif_tpu_torch.codec import recon
from libavif_tpu_torch.ops import _build, wavefront as wf
from libavif_tpu_torch.ops.cuda_kernels import _wrap32
from libavif_tpu_torch.ops.intra import predict_all_modes

SOURCE = (_build.CSRC / "encode_wavefront.cu").read_text()
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
DCT, IDTX = 0, 4
# The kernel's block: at most MAX_THREADS threads, the last warp its helper,
# the others slots of n threads (kMaxThreads, slots_for, threads_for).
MAX_THREADS = 256


def _slots(n: int, k: int) -> int:
    return min(k, (MAX_THREADS - 32) // n)


def _threads(n: int, k: int) -> int:
    return -(-_slots(n, k) * n // 32) * 32 + 32


def _direct(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """M @ v over v's last axis, each product and sum wrapped to int32."""
    acc = np.zeros(v.shape, np.int64)
    for k in range(m.shape[1]):
        acc = _wrap32(acc + _wrap32(v[..., k:k + 1] * np.asarray(m, np.int64)[:, k]))
    return acc


def _vectors(seed: int, n: int, count: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(INT32_MIN, INT32_MAX, (count, n), endpoint=True)
    v[0], v[1], v[2] = INT32_MIN, INT32_MAX, 0
    v[3, ::2], v[3, 1::2] = INT32_MIN, INT32_MAX
    v[4:12] = rng.integers(-(1 << 14), 1 << 14, (8, n))
    return v


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("which", range(4), ids=["fwd-column", "fwd-row", "inv-column", "inv-row"])
def test_butterfly_equals_direct_product(n, which):
    m = wf.pass_matrices(DCT, n)[which]
    inverse = which >= 2
    words = wf.butterfly_words(m, inverse)
    assert words.size == wf.pass_multiply_adds(n, wf.PASS_INVERSE_BUTTERFLY if inverse else wf.PASS_FORWARD_BUTTERFLY)
    v = _vectors(17 * n + which, n)
    np.testing.assert_array_equal(wf.butterfly_product(words, v, inverse), _direct(m, v))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("which", range(4), ids=["fwd-column", "fwd-row", "inv-column", "inv-row"])
def test_idtx_diagonal_equals_direct_product(n, which):
    m = wf.pass_matrices(IDTX, n)[which]
    words = wf.pass_words(m, wf.PASS_DIAGONAL)
    v = _vectors(5 * n + which, n)
    np.testing.assert_array_equal(_wrap32(v * words[:n]), _direct(m, v))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_symmetry_check_refuses_a_perturbed_basis(n, monkeypatch):
    rng = np.random.default_rng(n)
    for which in range(4):
        m = np.array(wf.pass_matrices(DCT, n)[which], np.int64)
        for _ in range(4):  # entries at every depth of the butterfly
            bad = m.copy()
            bad[tuple(rng.integers(0, n, 2))] += 1
            with pytest.raises(ValueError, match="butterfly"):
                wf.pass_words(bad, wf.PASS_INVERSE_BUTTERFLY if which >= 2 else wf.PASS_FORWARD_BUTTERFLY)
    bad_idtx = np.array(wf.pass_matrices(IDTX, n)[0], np.int64)
    bad_idtx[0, n - 1] = 1
    with pytest.raises(ValueError, match="diagonal"):
        wf.pass_words(bad_idtx, wf.PASS_DIAGONAL)
    # the host raises while it lays out the table, not the kernel: a DCT whose basis fails
    real = wf.pass_matrices

    def perturbed(t, size):
        mats = [np.array(x, np.int64) for x in real(t, size)]
        if t == DCT:
            mats[1][3, 0] += 1
        return tuple(mats)

    monkeypatch.setattr(wf, "pass_matrices", perturbed)
    with pytest.raises(ValueError, match="forward butterfly"):
        wf.pass_plan.__wrapped__(n, (DCT,))


def test_pass_plan_kinds():
    kinds, words = wf.pass_plan(16, wf.TX_SET_ALL)
    fwd, inv, dense, diag = (wf.PASS_FORWARD_BUTTERFLY, wf.PASS_INVERSE_BUTTERFLY, wf.PASS_DENSE,
                             wf.PASS_DIAGONAL)
    assert kinds == (fwd, fwd, inv, inv,  # DCT_DCT
                     dense, fwd, dense, inv,  # ADST_DCT: ADST columns, DCT rows
                     fwd, dense, inv, dense,  # DCT_ADST
                     dense, dense, dense, dense,  # ADST_ADST
                     diag, diag, diag, diag)  # IDTX
    assert all(w.size == 256 for w in words)
    assert wf.pass_plan(8, (tables.WHT_WHT,))[0] == (dense,) * 4


def _floor_div_model(a: np.ndarray, d, magic) -> np.ndarray:
    """``floor_div`` in csrc/encode_wavefront.cu, in uint32 arithmetic
    (elementwise; d and magic scalars or arrays like a)."""
    a = np.asarray(a, np.int64)
    d, magic = np.asarray(d, np.int64), np.asarray(magic, np.int64)
    s = np.where(a < 0, -1, 0)
    u = (a ^ s) & 0xFFFFFFFF
    q = (u * magic) >> 32
    r = (u + q * ((1 << 32) - d)) & 0xFFFFFFFF
    q = q + (r >= d)
    return (q ^ s).astype(np.int64)


def _dividends(step: int) -> np.ndarray:
    span = min(8 * step, 1 << 15)
    dense = np.arange(-span - 3, span + 4)
    multiples = np.array([k * step + e for k in (-(INT32_MAX // step), -3, 3, INT32_MAX // step) for e in (-1, 0, 1)])
    multiples = multiples[(multiples >= INT32_MIN) & (multiples <= INT32_MAX)]
    extremes = np.array([INT32_MIN, INT32_MIN + 1, INT32_MIN + step, -step - 1, -step, -1, 0, 1, step - 1, step,
                         INT32_MAX - step, INT32_MAX - 1, INT32_MAX])
    coefs = np.array([INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 3, -(1 << 30), 1 << 30])
    wrapped = [_wrap32(np.abs(coefs) + bias) for bias in (wf.quant_bias(step, True), wf.quant_bias(step, False))]
    rng = np.random.default_rng(step)
    return np.concatenate([dense, multiples, extremes, *wrapped,
                           rng.integers(INT32_MIN, INT32_MAX, 2000, endpoint=True)])


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_quantizer_magic_equals_floor_division(depth):
    steps = sorted({s for q in range(256) for s in tables.step_sizes(q, depth)})
    for step in steps:
        magic = wf.division_magic(step)
        a = _dividends(step)
        np.testing.assert_array_equal(_floor_div_model(a, step, magic), np.floor_divide(a, step), err_msg=str(step))


def test_division_magic_edges():
    for d in (1, 2, 3, 7, 29248, (1 << 31) - 1):
        a = _dividends(d)
        np.testing.assert_array_equal(_floor_div_model(a, d, wf.division_magic(d)), np.floor_divide(a, d))
    assert wf.division_magic(1) == (1 << 32) - 1
    for bad in (0, 1 << 31):
        with pytest.raises(ValueError):
            wf.division_magic(bad)


def _ext_edges(top, left, tl, n):
    """[left ext | top ext] as the helper warp lays them out."""
    def ext(edge):
        return np.concatenate([[tl], edge, np.full(n + 1, edge[-1])])
    return np.concatenate([ext(left), ext(top)]).astype(np.int64)


def _predict_column_model(mode, n, ext, dc):
    """predict_column's directional and other formulas for the whole block."""
    left, top, tl = ext[1:n + 1], ext[2 * n + 3:3 * n + 3], ext[0]
    i, j = np.mgrid[0:n, 0:n]
    w = np.asarray(tables.smooth_weights(n), np.int64)
    if mode == 0:
        return np.full((n, n), dc)
    if mode == 1:
        return top[j]
    if mode == 2:
        return left[i]
    if mode == 9:
        return (w[i] * top[j] + (256 - w[i]) * left[n - 1] + w[j] * left[i] + (256 - w[j]) * top[n - 1] + 256) >> 9
    if mode == 10:
        return (w[i] * top[j] + (256 - w[i]) * left[n - 1] + 128) >> 8
    if mode == 11:
        return (w[j] * left[i] + (256 - w[j]) * top[n - 1] + 128) >> 8
    if mode == 12:
        t, lft = top[j], left[i]
        base = t + lft - tl
        pt, pl, ptl = np.abs(base - t), np.abs(base - lft), np.abs(base - tl)
        return np.where((pl <= pt) & (pl <= ptl), lft, np.where(pt <= ptl, t, tl))
    use_top, idx, frac = (np.asarray(a, np.int64) for a in tables.dir_tables(mode, n))
    word = np.where(use_top != 0, 2 * n + 2, 0) + np.minimum(idx, 2 * n) + (frac << 8)
    off, f = word & 0xFF, word >> 8
    return (ext[off] * (32 - f) + ext[off + 1] * f + 16) >> 5


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("depth", [8, 12])
def test_extended_edge_prediction_equals_plain_predictor(n, depth):
    rng = np.random.default_rng(n * depth)
    maxv = (1 << depth) - 1
    top, left = rng.integers(0, maxv + 1, (2, 6, n))
    tl = rng.integers(0, maxv + 1, 6)
    want = predict_all_modes(torch.from_numpy(top.astype(np.int32)), torch.from_numpy(left.astype(np.int32)),
                             torch.from_numpy(tl.astype(np.int32)), n).numpy()
    for b in range(6):
        ext = _ext_edges(top[b], left[b], tl[b], n)
        dc = (int(top[b].sum() + left[b].sum()) + n) >> (n.bit_length())
        for mode in range(13):
            np.testing.assert_array_equal(_predict_column_model(mode, n, ext, dc), want[b, mode], err_msg=f"mode {mode}")


def _schedule_winner(costs: list, n: int) -> int:
    """The kernel's schedule: slots walk their candidates in index order,
    keep strict improvements, and merge by the least cost * 128 + index."""
    k_all = len(costs)
    slots = _slots(n, k_all)
    visited, keys = [], []
    for s in range(slots):
        best_cost, best_k = None, None
        for k in range(s, k_all, slots):
            visited.append(k)
            if best_cost is None or costs[k] < best_cost:
                best_cost, best_k = costs[k], k
        keys.append(best_cost * 128 + best_k)
    assert sorted(visited) == list(range(k_all))  # every candidate once
    return min(keys) & 127


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_candidate_schedule_visits_each_once_and_keeps_the_first_index(n):
    rng = np.random.default_rng(n)
    for k_all in range(1, 66):
        assert _threads(n, k_all) <= MAX_THREADS
        for draw in range(6):
            span = (1, 3, 1 << 20, 1 << 40, 1 << 55, 1 << 55)[draw]
            costs = [int(c) for c in rng.integers(-span if draw == 5 else 0, span, k_all)]
            want = min(range(k_all), key=lambda k: (costs[k], k))
            assert _schedule_winner(costs, n) == want
            first = torch.tensor(costs, dtype=torch.int64)[None]
            assert int(wf.first_argmin(first)[0]) == want


def test_schedule_mirror_matches_the_source():
    assert int(re.search(r"constexpr int kMaxThreads = (\d+);", SOURCE).group(1)) == MAX_THREADS
    assert "(kMaxThreads - 32) / N" in SOURCE and "(slots * N + 31) / 32 * 32 + 32" in SOURCE
    assert _slots(16, 13) == 13 and _threads(16, 13) == 256
    assert _slots(16, 65) == 14 and _slots(32, 26) == 7


def _pass_model(kind, words, v, n):
    if kind == wf.PASS_FORWARD_BUTTERFLY:
        return wf.butterfly_product(words, v, False)
    if kind == wf.PASS_INVERSE_BUTTERFLY:
        return wf.butterfly_product(words, v, True)
    if kind == wf.PASS_DIAGONAL:
        return _wrap32(v * words[:n])
    return _direct(words[:n * n].reshape(n, n), v)


def _round(v, bits):
    return v if bits == 0 else _wrap32(v + (1 << (bits - 1))) >> bits


def _kernel_search(src, top, left, tl, cfg):
    """One block's search in the kernel's arithmetic and order: the passes
    of ``pass_plan`` a vector at a time, the magic quantizer, int64 costs,
    the slot schedule. Returns (mode symbol, transform symbol, levels,
    reconstruction)."""
    n = cfg.n
    kinds, words = wf.pass_plan(n, cfg.txs)
    maxv = (1 << cfg.depth) - 1
    ext = _ext_edges(top, left, tl, n)
    dc = (int(top.sum() + left.sum()) + n) >> (n.bit_length())
    shifts = (0, 0, 0, 0) if cfg.lossless else (10, 11, 12, 15)
    params = wf._params(cfg, 1, 1, 1)
    steps = np.full((n, n), cfg.ac_step, np.int64)
    steps[0, 0] = cfg.dc_step
    bias = np.full((n, n), params.ac_bias, np.int64)
    bias[0, 0] = params.dc_bias
    magic = np.full((n, n), params.ac_magic, np.int64)
    magic[0, 0] = params.dc_magic
    results = []
    for k in range(len(cfg.mode_set) * len(cfg.txs)):
        word = wf.candidate_word(cfg, k)
        t = (word >> 4) & 15
        kw = [words[4 * t + p] for p in range(4)]
        kd = kinds[4 * t: 4 * t + 4]
        pred = _predict_column_model(word & 15, n, ext, dc)
        x = _wrap32(src - pred)
        x = _round(_pass_model(kd[0], kw[0], x.T, n), shifts[0]).T  # columns
        coef = _round(_pass_model(kd[1], kw[1], x, n), shifts[1])  # rows
        if cfg.lossless:
            level, deq = coef, coef
        else:
            neg = np.where(coef < 0, -1, 0)
            mag = _floor_div_model(_wrap32((coef ^ neg) - neg + bias), steps, magic)
            level = np.where(coef == 0, 0, _wrap32((mag ^ neg) - neg))
            deq = _wrap32(level * steps)
        x = _round(_pass_model(kd[2], kw[2], deq.T, n), shifts[2]).T
        res = _round(_pass_model(kd[3], kw[3], x, n), shifts[3])
        if cfg.lossless:
            res = res >> (2 * (n.bit_length() - 1))
        rec = np.clip(_wrap32(pred + res), 0, maxv)
        err = _wrap32(src - rec) >> (cfg.depth - 8)
        sse = int(_wrap32(err * err).sum())
        a = np.where(level < 0, _wrap32(-level), level)
        bitlen = np.frexp(np.maximum(a, 1).astype(np.float64))[1]  # 32 - clz(a), exact below 2^53
        bits = int(np.where(a > 0, 3 + 2 * np.minimum(bitlen, 16), 0).sum())
        results.append((sse + cfg.lam * bits, (word >> 8) & 15, (word >> 12) & 15, level, rec))
    win = _schedule_winner([r[0] for r in results], n)
    return results[win][1:]


_SEARCHES = [  # (n, depth, lossless, speed, search)
    (4, 8, False, 0, (None, None)),
    (8, 10, False, 0, (None, None)),
    (16, 8, False, 6, (None, None)),
    (16, 12, False, 3, (None, None)),
    (16, 8, False, 0, (13, 5)),
    (32, 8, False, 0, (None, None)),
    (4, 12, True, 6, (None, None)),
    (32, 10, True, 6, (None, None)),
]


@pytest.mark.parametrize("n,depth,lossless,speed,search", _SEARCHES)
def test_kernel_model_search_equals_plain_search(n, depth, lossless, speed, search):
    rng = np.random.default_rng(n + depth + speed)
    maxv = (1 << depth) - 1
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    cfg = recon.search_config(n, depth, lossless, dc, ac, speed, search)
    blocks = [rng.integers(0, maxv + 1, (n, n)), np.full((n, n), maxv // 3),  # noise; flat: ties
              np.clip(np.add.outer(np.arange(n), np.arange(n)) * (maxv // (2 * n)), 0, maxv)]
    if not lossless:
        blocks.append(rng.integers(INT32_MIN, INT32_MAX, (n, n), endpoint=True))  # wraps everywhere
    for b, src in enumerate(blocks):
        top, left = (rng.integers(0, maxv + 1, n), rng.integers(0, maxv + 1, n)) if b != 1 else (
            np.full(n, maxv // 3), np.full(n, maxv // 3))
        tl = int(rng.integers(0, maxv + 1)) if b != 1 else maxv // 3
        want = wf._search(torch.from_numpy(src.astype(np.int32))[None], torch.from_numpy(top.astype(np.int32))[None],
                          torch.from_numpy(left.astype(np.int32))[None], torch.tensor([tl], dtype=torch.int32), cfg)
        mode, tx, level, rec = _kernel_search(src.astype(np.int64), top.astype(np.int64), left.astype(np.int64),
                                              tl, cfg)
        assert (mode, tx) == (int(want[0][0]), int(want[1][0])), f"block {b}"
        np.testing.assert_array_equal(level, want[2][0].numpy(), err_msg=f"block {b} levels")
        np.testing.assert_array_equal(rec, want[3][0].numpy(), err_msg=f"block {b} reconstruction")


def _c_struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            ctype, names = line.rstrip(";").split(None, 1)
            for field in names.split(","):
                field = field.strip()
                fields.append((field.split("[")[0], ctype, re.findall(r"\[(\w+(?: \* \w+)?)\]", field)))
    return fields


def test_step_params_mirror_matches_the_source():
    fields = _c_struct_fields("StepParams")
    assert [f[0] for f in fields] == [f[0] for f in wf._StepParams._fields_]
    sizes = {"kMaxCand": wf.MAX_CAND, "4 * kMaxTx": 4 * wf.MAX_TX}
    for (name, ctype, dims), (_, ptype) in zip(fields, wf._StepParams._fields_):
        base = ptype
        for dim in dims:
            assert base._length_ == sizes[dim], name
            base = base._type_
        assert base.__name__ == {"int": "c_int", "unsigned": "c_uint"}[ctype], name
    assert int(re.search(r"constexpr int kMaxModes = (\d+);", SOURCE).group(1)) * 5 == wf.MAX_CAND


def test_step_params_carry_the_search():
    cfg = recon.search_config(16, 8, False, 40, 60, 6)
    p = wf._params(cfg, 2, 3, 4)
    assert list(p.pass_kind[:4]) == list(wf.pass_plan(16, cfg.txs)[0])
    assert (p.dc_magic, p.ac_magic, p.rb_magic) == (wf.division_magic(40), wf.division_magic(60), wf.division_magic(3))
    assert (p.dc_bias, p.ac_bias) == (20, 60 * 3 // 8)
    assert [p.cand[k] & 15 for k in range(13)] == list(cfg.predicted_modes)
    narrow = recon.search_config(16, 8, False, 40, 60, 0, (5, 3))
    q = wf._params(narrow, 1, 1, 1)
    assert [(q.cand[k] >> 8) & 15 for k in range(15)] == [m for m in narrow.mode_set for _ in narrow.txs]
    assert [(q.cand[k] >> 12) & 15 for k in range(15)] == list(narrow.tx_syms) * 5


def test_quant_bias_wraps_as_the_plain_version():
    for step in (1, 2, 3, 8, 29248, 715827883, (1 << 31) - 1):
        steps = torch.tensor([step], dtype=torch.int32)
        assert wf.quant_bias(step, False) == int((steps * 3 // 8)[0])
        assert wf.quant_bias(step, True) == int((steps // 2)[0])
