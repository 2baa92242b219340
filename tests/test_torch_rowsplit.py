"""The row-segment work list (``repro_torch.kernels.rowsplit``) and torch
emulations of the two kernels built on it.

* Invariants of the list at K ∈ {1, 4, 32} on R-MAT graphs with
  zero-in-degree rows and one hub row of in-degree ≫ K: every edge is
  covered once, no segment exceeds K edges, a split row's segments own
  consecutive partial slots in edge order, and the list is built once per
  (graph, K).
* ``emulate_spmm`` mirrors B1's split-and-combine (``spmm_csr.cu``): a
  raw sum per segment, a whole row scaled by its degree, a split row's
  partials summed in slot order and scaled by its FULL degree.
  ``emulate_attention`` mirrors B2's flash-decoding merge
  (``fused_attention_csr.cu``): (m_i, l_i, acc_i) per segment and head,
  merged in slot order. ``emulate_softmax`` mirrors B5
  (``edge_softmax_csr.cu``): an online (max, sum) per segment, lane group
  and head, the groups merged, a whole row written at once and a split
  row's slots folded in slot order. ``emulate_binary_reduce`` mirrors B4
  (``binary_reduce_csr.cu``): lane groups taking a segment's edges in a
  fixed stride, combined by the shuffle tree, a whole row divided by its
  degree, a split row's slots summed in slot order and divided by its
  FULL degree. All four are held against the port's plain versions and
  the JAX package (``gspmm(strategy="segment")``; ``fused_attention`` on
  its canonical jnp pipeline, ``strategy="fused"``;
  ``edge_softmax_fused``) on the same numpy inputs at 1e-5 (fp32 sums in
  another order). The CUDA kernels themselves run on the card
  (``chip_smoke.py``).
* The same four emulations on a sampled fan-out block graph, whose dummy
  destination row (every pad edge) is the heaviest row and is split.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gspmm as jax_gspmm
from repro.core.edge_softmax import edge_softmax_fused as jax_es_fused
from repro.core.edge_softmax import fused_attention as jax_fused_attention
from repro.core.graph import from_coo as jax_from_coo
from repro_torch.core import from_coo
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.binary_reduce.ops import binary_reduce_plain
from repro_torch.kernels.edge_softmax.ops import (MAX_F, edge_softmax_plain,
                                                  fused_attention_plain,
                                                  heads_per_warp)
from repro_torch.kernels.rowsplit import build_row_split, row_split
from repro_torch.kernels.spmm.ops import spmm_plain
from repro_torch.substrate.nn import leaky_relu
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
KS = (1, 4, 32)
HUB = 5


def _edges(seed=3):
    """R-MAT (no self-loops, so zero-in-degree rows) plus every node →
    ``HUB``, a row of in-degree ≈ n ≫ 32."""
    src, dst, n = rmat_graph(8, 1500, seed=seed)
    src = np.concatenate([src, np.arange(n)])
    dst = np.concatenate([dst, np.full(n, HUB)])
    pairs = np.unique(src * n + dst)
    return pairs // n, pairs % n, n


SRC, DST, N = _edges()


def _graphs():
    jg = jax_from_coo(SRC, DST, n_src=N, n_dst=N)
    tg = from_coo(SRC, DST, n_src=N, n_dst=N, device="cpu")
    return jg, tg


def test_graph_has_what_the_invariants_need():
    deg = np.bincount(DST, minlength=N)
    assert (deg == 0).sum() > 10
    assert deg[HUB] >= N - 1 and deg[HUB] > 4 * max(KS)


@pytest.mark.parametrize("K", KS)
def test_work_list_invariants(K):
    _, tg = _graphs()
    rs = row_split(tg, K)
    seg = rs.seg.numpy().astype(np.int64)
    split = rs.split.numpy().astype(np.int64)
    indptr = tg.host.indptr_dst.astype(np.int64)
    deg = np.diff(indptr)
    row, beg, end, slot = seg.T
    assert rs.seg.dtype == rs.split.dtype == torch.int32
    assert rs.n_segments == len(seg) and rs.n_split == len(split)
    # every edge exactly once, each segment inside its row, at most K
    covered = np.zeros(tg.n_edges, np.int64)
    for b, e in zip(beg, end):
        covered[b:e] += 1
    assert (covered == 1).all()
    assert (indptr[row] <= beg).all() and (end <= indptr[row + 1]).all()
    assert (end - beg <= K).all() and (end >= beg).all()
    assert rs.max_segment == (end - beg).max()
    # longest first, ties in (row, edge) order
    length = end - beg
    assert (np.diff(length) <= 0).all()
    for L in np.unique(length):
        tie = length == L
        assert (np.diff(row[tie]) >= 0).all()
        assert (np.diff(beg[tie]) >= 0).all()
    # a row of in-degree <= K (empty ones too) is one whole-row segment
    whole = slot < 0
    assert sorted(row[whole]) == sorted(np.flatnonzero(deg <= K))
    assert (beg[whole] == indptr[row[whole]]).all()
    assert (end[whole] == indptr[row[whole] + 1]).all()
    # a heavier row: ceil(deg / K) segments, consecutive slots in edge order
    assert (split[:, 0] == np.flatnonzero(deg > K)).all()
    assert (split[:, 2] == -(-deg[deg > K] // K)).all()
    assert (split[:, 1] == np.cumsum(split[:, 2]) - split[:, 2]).all()
    assert rs.n_partials == split[:, 2].sum() == whole.size - whole.sum()
    by_slot = {s: (r, b, e) for r, b, e, s in seg[~whole]}
    assert sorted(by_slot) == list(range(rs.n_partials))
    for r, first, count in split:
        parts = [by_slot[first + i] for i in range(count)]
        assert all(p[0] == r for p in parts)
        assert parts[0][1] == indptr[r] and parts[-1][2] == indptr[r + 1]
        assert all(a[2] == b[1] for a, b in zip(parts, parts[1:]))
        assert all(p[2] - p[1] == K for p in parts[:-1])
    if K == max(KS):
        assert HUB in split[:, 0]


def test_work_list_is_built_once_per_graph_and_k():
    _, tg = _graphs()
    a = row_split(tg, 4)
    assert row_split(tg, 4) is a
    assert row_split(tg, 32) is not a
    ref = weakref.ref(a)
    del a, tg
    gc.collect()
    assert ref() is None  # the cache does not keep a dead graph's list


def test_work_list_of_empty_graphs_and_bad_k():
    empty = build_row_split(torch.zeros(1, dtype=torch.int32), 4)
    assert empty.n_segments == empty.n_split == empty.n_partials == 0
    no_edges = build_row_split(torch.zeros(4, dtype=torch.int32), 4)
    assert no_edges.n_segments == 3 and no_edges.n_split == 0
    assert (no_edges.seg[:, 1] == no_edges.seg[:, 2]).all()
    with pytest.raises(ValueError, match="K must be"):
        build_row_split(torch.zeros(4, dtype=torch.int32), 0)


def _segment_edges(rs):
    """(segment id per edge, canonical edge ids) in list order."""
    seg = rs.seg.long()
    length = seg[:, 2] - seg[:, 1]
    sid = torch.repeat_interleave(torch.arange(len(seg)), length)
    eids = torch.cat([torch.arange(int(b), int(e)) for b, e in
                      zip(seg[:, 1], seg[:, 2])]) if len(sid) else sid
    return seg, sid, eids


def emulate_spmm(g, rs, B, weight, mean):
    """B1 as the CUDA source computes it, segment by segment."""
    seg, sid, eids = _segment_edges(rs)
    msg = B.index_select(0, g.long("src")[eids])
    if weight is not None:
        msg = msg * weight[eids, None]
    part = torch.zeros(len(seg), B.shape[1]).index_add_(0, sid, msg)
    out = torch.full((g.n_dst, B.shape[1]), float("nan"))
    whole = seg[:, 3] < 0
    scale = (1.0 / (seg[:, 2] - seg[:, 1]).clamp(min=1).float()
             if mean else torch.ones(len(seg)))
    out[seg[whole, 0]] = part[whole] * scale[whole, None]
    partial = torch.empty(rs.n_partials, B.shape[1])
    partial[seg[~whole, 3]] = part[~whole]
    deg = g.in_degrees.long()
    for row, first, count in rs.split.long().tolist():
        acc = torch.zeros(B.shape[1])
        for i in range(count):
            acc = acc + partial[first + i]
        out[row] = acc * (1.0 / max(int(deg[row]), 1) if mean else 1.0)
    return out


def emulate_attention(g, rs, el, er, z, slope=0.2):
    """B2 as the CUDA source computes it: (m_i, l_i, acc_i) per segment
    and head, a whole row divided by its l, a split row's segments merged
    in slot order."""
    seg, sid, eids = _segment_edges(rs)
    S, (H, F) = len(seg), z.shape[1:]
    src = g.long("src")[eids]
    x = leaky_relu(el[src] + er[seg[sid, 0]], slope)             # (E, H)
    m = torch.full((S, H), float("-inf")).scatter_reduce(
        0, sid[:, None].expand(-1, H), x, "amax")
    p = torch.exp(x - m[sid])
    l = torch.zeros(S, H).index_add_(0, sid, p)
    acc = torch.zeros(S, H, F).index_add_(0, sid, p[..., None] * z[src])
    out = torch.full((g.n_dst, H, F), float("nan"))
    whole = seg[:, 3] < 0
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    out[seg[whole, 0]] = acc[whole] * inv[whole, :, None]
    at = {int(s): i for i, s in enumerate(seg[:, 3]) if s >= 0}
    for row, first, count in rs.split.long().tolist():
        idx = torch.tensor([at[first + i] for i in range(count)])
        mx = m[idx].amax(0)
        w = torch.exp(m[idx] - mx)                              # (count, H)
        lsum = (l[idx] * w).sum(0)
        out[row] = (acc[idx] * w[..., None]).sum(0) / lsum[:, None]
    return out


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("op", ["u_copy_add_v", "u_copy_mean_v",
                                "u_mul_e_add_v", "u_mul_e_mean_v"])
def test_spmm_emulation_matches_plain_and_jax(op, K):
    jg, tg = _graphs()
    rng = np.random.default_rng(K)
    B = rng.normal(size=(N, 41)).astype(np.float32)
    w = rng.normal(size=(tg.n_edges,)).astype(np.float32)
    weighted = "_e_" in op
    mean = "mean" in op
    kw = dict(u=jnp.asarray(B))
    if weighted:
        kw["e"] = jnp.asarray(w)[:, None]
    ref = np.asarray(jax_gspmm(jg, op, strategy="segment", **kw))
    Bt = torch.from_numpy(B)
    wc = (torch.from_numpy(w)[tg.long("eid")] if weighted else None)
    got = emulate_spmm(tg, row_split(tg, K), Bt, wc, mean)
    plain = spmm_plain(tg, Bt, wc, mean)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    empty = tg.host.in_degrees == 0
    assert not got.numpy()[empty].any()


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("H,F", [(4, 32), (1, 41)])
def test_attention_emulation_matches_plain_and_jax(H, F, K):
    jg, tg = _graphs()
    rng = np.random.default_rng(100 + K)
    el = rng.normal(size=(N, H)).astype(np.float32)
    er = rng.normal(size=(N, H)).astype(np.float32)
    z = rng.normal(size=(N, H, F)).astype(np.float32)
    # the hub's edges run in src order: sources 64..127 lift their
    # segments' maxima by ~50 over the segments before and after them,
    # so the merge must rescale in both directions
    el[64:128] += 50.0
    rs = row_split(tg, K)
    hub = rs.split[rs.split[:, 0] == HUB]
    assert len(hub) == 1 and int(hub[0, 2]) >= 3
    got = emulate_attention(tg, rs, torch.from_numpy(el),
                            torch.from_numpy(er), torch.from_numpy(z))
    plain = fused_attention_plain(tg, torch.from_numpy(el),
                                  torch.from_numpy(er), torch.from_numpy(z))
    ref = np.asarray(jax_fused_attention(jg, jnp.asarray(el),
                                         jnp.asarray(er), jnp.asarray(z),
                                         strategy="fused"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    empty = tg.host.in_degrees == 0
    assert not got.numpy()[empty].any()


def test_attention_merge_rescales_segment_maxima():
    """On the hub row the segments' maxima differ by ~50: the merged row
    is the high segments' average, which a merge without the rescale
    (plain sums of l_i and acc_i) would not give."""
    _, tg = _graphs()
    H, F = 1, 8
    rng = np.random.default_rng(7)
    el = rng.normal(size=(N, H)).astype(np.float32)
    el[64:128] += 50.0
    er = np.zeros((N, H), np.float32)
    z = rng.normal(size=(N, H, F)).astype(np.float32)
    rs = row_split(tg, 32)
    m = [float(leaky_relu(torch.from_numpy(el[lo:lo + 32]), 0.2).max())
         for lo in (0, 64, 160)]
    assert m[1] - m[0] > 45 and m[1] - m[2] > 45
    got = emulate_attention(tg, rs, torch.from_numpy(el),
                            torch.from_numpy(er), torch.from_numpy(z))[HUB]
    hub_src = tg.host.src[tg.host.indptr_dst[HUB]:tg.host.indptr_dst[HUB + 1]]
    hi = hub_src[(hub_src >= 64) & (hub_src < 128)]
    x = el[hi, 0] - el[hi, 0].max()
    a = np.exp(x) / np.exp(x).sum()
    np.testing.assert_allclose(got[0].numpy(), a @ z[hi, 0], rtol=1e-4,
                               atol=1e-4)


def test_heads_per_warp_fills_at_most_128_floats():
    assert heads_per_warp(4, 32) == 4
    assert heads_per_warp(1, 41) == 1
    assert heads_per_warp(3, 41) == 3
    assert heads_per_warp(8, 64) == 2
    assert heads_per_warp(16, 4) == 8
    assert heads_per_warp(2, MAX_F) == 1
    for H in (1, 2, 3, 8, 13):
        for F in (1, 5, 32, 41, 100, MAX_F):
            hg = heads_per_warp(H, F)
            assert 1 <= hg <= min(H, 8) and hg * F <= MAX_F


def emulate_softmax(g, rs, x):
    """B5 as the CUDA source computes it. A segment has max(Hl, 16) lanes
    (Hl the power of two >= H, at most 32) in groups of Hl; group ``grp``
    of its max(Hl, 16) / Hl takes the edges at positions ≡ grp mod that
    count in edge order and folds each into
    its online (max m, sum s) from (−1e30, 0), the sum rescaled when the
    max grows; the groups merge (max, rescale, sum). A whole row writes
    exp(x − m) / max(s, 1e-38); a split row's slots are folded in slot
    order first."""
    H = x.shape[1]
    hl = 1
    while hl < H and hl < 32:
        hl *= 2
    ngrp = max(hl, 16) // hl
    seg, sid, eids = _segment_edges(rs)
    S = len(seg)
    xc = x[g.long("eid")[eids]]                       # (E, H), list order
    pos = eids - seg[sid, 1]
    gid, step = sid * ngrp + pos % ngrp, pos // ngrp
    m = torch.full((S * ngrp, H), -1e30)
    s = torch.zeros(S * ngrp, H)
    for t in range(int(step.max()) + 1 if len(step) else 0):
        at = step == t              # at most one edge per group and step
        i, v = gid[at], xc[at]
        up = v > m[i]
        s[i] = torch.where(up, s[i] * torch.exp(m[i] - v) + 1.0,
                           s[i] + torch.exp(v - m[i]))
        m[i] = torch.where(up, v, m[i])
    m, s = m.view(S, ngrp, H), s.view(S, ngrp, H)
    mx = m.amax(1)                                    # (S, H)
    sm = (s * torch.exp(m - mx[:, None])).sum(1)
    alpha = torch.full_like(x, float("nan"))
    out_at = g.long("eid")[eids]
    whole = (seg[:, 3] < 0)[sid]
    alpha[out_at[whole]] = (torch.exp(xc[whole] - mx[sid[whole]])
                            / sm[sid[whole]].clamp(min=1e-38))
    at_slot = {int(v): i for i, v in enumerate(seg[:, 3]) if v >= 0}
    indptr = g.long("indptr_dst")
    for row, first, count in rs.split.long().tolist():
        idx = [at_slot[first + i] for i in range(count)]
        m_row = mx[idx].amax(0)
        s_row = torch.zeros(H)
        for i in idx:                                 # slot order
            s_row = s_row + sm[i] * torch.exp(mx[i] - m_row)
        k = g.long("eid")[indptr[row]:indptr[row + 1]]
        alpha[k] = torch.exp(x[k] - m_row) / s_row.clamp(min=1e-38)
    return alpha


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("H", [4, 1, 3])
def test_softmax_emulation_matches_plain_and_jax(H, K):
    jg, tg = _graphs()
    rng = np.random.default_rng(200 + K + H)
    # spread over ±30: a segment's max moves a lot as its edges are
    # folded, and the hub's segments' maxima differ, so every rescale counts
    x = rng.uniform(-30.0, 30.0, size=(tg.n_edges, H)).astype(np.float32)
    rs = row_split(tg, K)
    hub = rs.split[rs.split[:, 0] == HUB]
    assert len(hub) == 1 and int(hub[0, 2]) >= 8
    got = emulate_softmax(tg, rs, torch.from_numpy(x))
    assert torch.isfinite(got).all()      # every edge written
    plain = edge_softmax_plain(tg, torch.from_numpy(x))
    ref = np.asarray(jax_es_fused(jg, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


def test_softmax_merge_rescales_segment_maxima():
    """On the hub row, split at K = 32 with the edges of sources 64..127
    lifted by 50, the other segments' share underflows: a merge without
    the rescale (plain sums of the slots' s) would not give the lifted
    edges' own softmax."""
    _, tg = _graphs()
    x = np.zeros((tg.n_edges, 1), np.float32)
    src_caller = tg.src_caller.numpy()
    dst_caller = tg.dst_caller.numpy()
    lifted = (dst_caller == HUB) & (src_caller >= 64) & (src_caller < 128)
    x[lifted, 0] = 50.0
    got = emulate_softmax(tg, row_split(tg, 32), torch.from_numpy(x))
    hub = dst_caller == HUB
    np.testing.assert_allclose(got.numpy()[lifted, 0],
                               1.0 / lifted.sum(), rtol=1e-5)
    assert float(got[hub & ~lifted].max()) < 1e-20


def emulate_binary_reduce(g, rs, B, E, binop, mean):
    """B4 as the CUDA source computes it at its default lanes. A segment
    has max(lpe, 16) lanes (lpe the power of two >= d, at most 32) in
    groups of lpe; group ``grp`` of its max(lpe, 16) / lpe takes the edges
    at positions ≡ grp mod that count and adds each message to its sum in
    edge order from 0. The groups combine by the shuffle tree (sum with
    the group ``grp ^ s`` for s = 1, 2, 4, …). A whole row is divided by
    its degree for mean; a split row's slots are summed in slot order and
    divided by the row's full degree."""
    d = E.shape[1] if B is None else B.shape[1]
    lpe = 1
    while lpe < d and lpe < 32:
        lpe *= 2
    ngrp = max(lpe, 16) // lpe
    seg, sid, eids = _segment_edges(rs)
    S = len(seg)
    e_val = E[g.long("eid")[eids]].expand(-1, d)        # list order
    b_val = None if B is None else B[g.long("src")[eids]]
    msg = {"add": lambda: b_val + e_val, "sub": lambda: b_val - e_val,
           "mul": lambda: b_val * e_val, "div": lambda: b_val / e_val,
           "copy_lhs": lambda: b_val, "copy_rhs": lambda: e_val}[binop]()
    pos = eids - seg[sid, 1]
    gid, step = sid * ngrp + pos % ngrp, pos // ngrp
    acc = torch.zeros(S * ngrp, d)
    for t in range(int(step.max()) + 1 if len(step) else 0):
        at = step == t              # at most one edge per group and step
        acc[gid[at]] = acc[gid[at]] + msg[at]
    acc = acc.view(S, ngrp, d)
    s = 1
    while s < ngrp:                 # the __shfl_xor tree
        acc = acc + acc[:, torch.arange(ngrp) ^ s]
        s *= 2
    part = acc[:, 0]                                    # group 0 writes
    out = torch.full((g.n_dst, d), float("nan"))
    whole = seg[:, 3] < 0
    length = (seg[:, 2] - seg[:, 1]).clamp(min=1).float()
    out[seg[whole, 0]] = (part[whole] / length[whole, None] if mean
                          else part[whole])
    partial = torch.empty(rs.n_partials, d)
    partial[seg[~whole, 3]] = part[~whole]
    deg = g.in_degrees.long()
    for row, first, count in rs.split.long().tolist():
        total = torch.zeros(d)
        for i in range(count):                          # slot order
            total = total + partial[first + i]
        out[row] = total / max(int(deg[row]), 1) if mean else total
    return out


# (JAX spec, binop, node width d, edge width de): the composed softmax's
# sums at H = 4 and 1, a vector-E mul, a scalar-E div mean at a width
# that is no power of two, a sub mean
BR_CASES = [("e_copy_add_v", "copy_rhs", 4, 4),
            ("e_copy_add_v", "copy_rhs", 1, 1),
            ("u_mul_e_add_v", "mul", 32, 32),
            ("u_div_e_mean_v", "div", 41, 1),
            ("u_sub_e_mean_v", "sub", 4, 4)]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("spec,binop,d,de", BR_CASES)
def test_binary_reduce_emulation_matches_plain_and_jax(spec, binop, d, de,
                                                        K):
    jg, tg = _graphs()
    rng = np.random.default_rng(300 + K + d)
    B = rng.normal(size=(N, d)).astype(np.float32)
    E = rng.normal(size=(tg.n_edges, de)).astype(np.float32)
    if binop == "div":   # keep divisors away from 0
        E = (np.sign(E) * (0.5 + np.abs(E))).astype(np.float32)
    kw = dict(e=jnp.asarray(E))
    if binop != "copy_rhs":
        kw["u"] = jnp.asarray(B)
    ref = np.asarray(jax_gspmm(jg, spec, strategy="segment", **kw))
    rs = row_split(tg, K)
    hub = rs.split[rs.split[:, 0] == HUB]
    assert len(hub) == 1 and int(hub[0, 2]) >= 8
    Bt = None if binop == "copy_rhs" else torch.from_numpy(B)
    Et = torch.from_numpy(E)
    mean = spec.endswith("mean_v")
    got = emulate_binary_reduce(tg, rs, Bt, Et, binop, mean)
    plain = binary_reduce_plain(tg, Bt, Et, binop, mean)
    assert got.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    empty = tg.host.in_degrees == 0
    assert not got.numpy()[empty].any()


@pytest.mark.parametrize("K", (4, 32))
def test_emulations_on_a_sampled_block(K):
    """A fan-out block is bipartite (n_src ≫ n_dst) and its dummy row
    holds every pad edge, so it is the block's heaviest row and goes
    through the split-row fold. The four emulations on the padded block
    graph match the plain versions; real rows with no real edge are 0."""
    from repro_torch.data import NeighborSampler

    _, tg = _graphs()
    seeds = np.array([HUB, 0, 1, 2, 3, 4, 6, 7, 9, 11])
    mb = NeighborSampler(tg, [12], 16, seed=0, device="cpu").sample(
        seeds, np.zeros(len(seeds), np.int64))
    bg = mb.blocks[0].bg
    g = bg.g
    deg = g.host.in_degrees
    assert g.n_src > 4 * g.n_dst and int(deg.argmax()) == bg.n_dst_real
    rs = row_split(g, K)
    assert bg.n_dst_real in rs.split[:, 0].tolist()
    empty = deg == 0
    rng = np.random.default_rng(K)
    B = torch.from_numpy(rng.normal(size=(g.n_src, 41)).astype(np.float32))
    w = mb.blocks[0].gcn_norm[g.long("eid")]
    for weight, mean in ((w, False), (None, True)):
        got = emulate_spmm(g, rs, B, weight, mean)
        np.testing.assert_allclose(got.numpy(),
                                   spmm_plain(g, B, weight, mean).numpy(),
                                   rtol=TOL, atol=TOL)
        assert not got.numpy()[empty].any()
    E = torch.from_numpy(rng.normal(size=(g.n_edges, 4)).astype(np.float32))
    got = emulate_binary_reduce(g, rs, None, E, "copy_rhs", False)
    np.testing.assert_allclose(
        got.numpy(), binary_reduce_plain(g, None, E, "copy_rhs").numpy(),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(emulate_softmax(g, rs, E).numpy(),
                               edge_softmax_plain(g, E).numpy(), rtol=TOL,
                               atol=TOL)
    el = torch.from_numpy(rng.normal(size=(g.n_src, 4)).astype(np.float32))
    er = torch.from_numpy(rng.normal(size=(g.n_dst, 4)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(g.n_src, 4, 8)).astype(np.float32))
    got = emulate_attention(g, rs, el, er, z)
    np.testing.assert_allclose(
        got.numpy(), fused_attention_plain(g, el, er, z).numpy(),
        rtol=TOL, atol=TOL)
    assert not got.numpy()[empty].any()
