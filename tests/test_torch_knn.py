"""The plain versions of kernels F (fused 2-NN) and H (fused top-k) and the
port's matching front end, held against the JAX package: the Pallas
kernels in interpret mode and the XLA scan path, on the same numpy
descriptors (the realistic-margin clusters of tests/test_knn_pallas.py).

Tolerances: indices are identical in f32 mode. Distances agree to 5e-5
absolute: ||q||^2 + ||t||^2 is ~128 for these descriptors, so one f32 ulp
of that sum is 1.5e-5 and the two packages' matmuls round in different
orders. bf16 mode is held by match identity (>= 0.99 of ratio-test matches
and top-1 neighbours), the consumer contract of tests/test_knn_pallas.py.
The emulation of the card's f32 mode (a 3xTF32 split product) is held by
the f32 parity rule its test states: indices identical except verified
near-ties, distances within 1e-5 relative plus an absolute part that
scales with ||q||^2 + ||t||^2 for descriptors with large norms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_dlco_tpu.ops import knn as jax_knn
from opencv_dlco_tpu.ops import knn_pallas as jax_kp

from opencv_dlco_tpu_torch.ops import knn as port_knn
from opencv_dlco_tpu_torch.ops.knn_fused import (
    knn2_fused,
    knn_plain,
    knnk_fused,
)

DIST = dict(rtol=1e-5, atol=5e-5)


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(500, 64)).astype(np.float32)
    q = centres[:300] + 0.05 * rng.normal(size=(300, 64)).astype(np.float32)
    t = np.concatenate([centres,
                        rng.normal(size=(900, 64)).astype(np.float32)])
    t = t[rng.permutation(len(t))].astype(np.float32)
    return q, t


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_kernel_f_plain_matches_pallas_f32(descs):
    q, t = descs
    d, i = knn2_fused(_t(q), _t(t), bf16=False)
    d_j, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                                 interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)


@pytest.mark.parametrize("k", [3, 10])
def test_kernel_h_plain_matches_pallas_f32(descs, k):
    q, t = descs
    d, i = knnk_fused(_t(q), _t(t), k, bf16=False)
    d_j, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), k,
                                 interpret=True, bf16=False)
    assert d.shape == i.shape == (q.shape[0], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)
    assert torch.all(d[:, 1:] >= d[:, :-1])


def test_kernel_f_plain_bf16_match_identity(descs):
    q, t = descs
    d, i = knn2_fused(_t(q), _t(t), bf16=True)
    m, _ = port_knn.ratio_test(d, i, ratio=0.9)
    for d_r, i_r in (
            jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t), interpret=True,
                              bf16=True),
            jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=2,
                              block=512, fused=False)):
        m_r, _ = jax_knn.ratio_test(d_r, i_r, ratio=0.9)
        assert np.mean(m.numpy() == np.asarray(m_r)) >= 0.99
        assert np.mean(i[:, 0].numpy() == np.asarray(i_r[:, 0])) >= 0.99


def test_kernel_f_plain_padding_edges():
    """Shapes off the tile grid: every query answered, no padding row
    selected (77 x 130 as tests/test_knn_pallas.py)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(77, 32)).astype(np.float32)
    t = rng.normal(size=(130, 32)).astype(np.float32)
    d, i = knn2_fused(_t(q), _t(t), bf16=False)
    d_j, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                                 interpret=True, bf16=False)
    assert d.shape == i.shape == (77, 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert int(i.max()) < 130


def test_kernel_h_plain_empty_slots():
    """Fewer train rows than k: the missing slots are (inf, -1)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    t = rng.normal(size=(5, 16)).astype(np.float32)
    d, i = knnk_fused(_t(q), _t(t), 8, bf16=False)
    d_j, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), 8,
                                 interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert np.all(i[:, 5:].numpy() == -1)
    assert np.all(np.isinf(d[:, 5:].numpy()))


@pytest.mark.parametrize("k", [2, 4])
def test_ties_go_to_the_lowest_train_index(k):
    """Equal distances (duplicate train rows) are ordered by train index,
    as the TPU kernels' masked-min and merge rule order them."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    t = np.concatenate([base, base, base])          # each row 3 times
    q = base + 0.01 * rng.normal(size=base.shape).astype(np.float32)
    d, i = knn_plain(_t(q), _t(t), k, bf16=False)
    call = jax_kp.knn2_fused if k == 2 else \
        (lambda a, b, **kw: jax_kp.knnk_fused(a, b, k, **kw))
    _, i_j = call(jnp.asarray(q), jnp.asarray(t), interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j)[:, :k])
    # the nearest row's three copies, lowest index first
    assert np.all(i[:, 0].numpy() == np.arange(6))
    assert np.all(i[:, 1].numpy() == np.arange(6) + 6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_knn_match_matches_jax(descs, fused, k):
    q, t = descs
    d, i = port_knn.knn_match(_t(q), _t(t), k=k, block=512, fused=fused,
                              precision="highest")
    d_j, i_j = jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=k,
                                 block=512, fused=False)
    assert d.shape == (q.shape[0], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)


def test_knn_match_auto_takes_the_scan_path_on_cpu(descs):
    q, t = descs
    before = (knn2_fused.launches, knnk_fused.launches)
    d, i = port_knn.knn_match(_t(q), _t(t), k=2)
    d_s, i_s = port_knn.knn_match_scan(_t(q), _t(t), k=2)
    np.testing.assert_array_equal(i.numpy(), i_s.numpy())
    assert (knn2_fused.launches, knnk_fused.launches) == before
    assert not port_knn._fused_eligible(_t(q), _t(t), 2)


def test_ratio_test_and_mutual_nearest_match_jax(descs):
    q, t = descs
    d, i = port_knn.knn_match(_t(q), _t(t), k=2, block=512)
    m, ok = port_knn.ratio_test(d, i, ratio=0.8)
    d_j, i_j = jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=2,
                                 block=512, fused=False)
    m_j, ok_j = jax_knn.ratio_test(d_j, i_j, ratio=0.8)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    for fused in (False, True):
        mm, mok = port_knn.mutual_nearest(_t(q), _t(t), block=512,
                                          fused=fused)
        mm_j, mok_j = jax_knn.mutual_nearest(jnp.asarray(q), jnp.asarray(t),
                                             block=512, fused=False)
        np.testing.assert_array_equal(mm.numpy(), np.asarray(mm_j))
        np.testing.assert_array_equal(mok.numpy(), np.asarray(mok_j))


def test_pairwise_sq_dists_matches_jax(descs):
    q, t = descs
    np.testing.assert_allclose(
        port_knn.pairwise_sq_dists(_t(q[:50]), _t(t[:70])).numpy(),
        np.asarray(jax_knn.pairwise_sq_dists(jnp.asarray(q[:50]),
                                             jnp.asarray(t[:70]))), **DIST)


# -- emulations of the Hopper kernels' selection (csrc/knn_topk.cu, kernel
# H, and csrc/knn_batched.cu, kernel G): the same tiling, lane ownership,
# thresholds, queues and merges, vectorised in PyTorch over warps and lanes,
# on the distances the kernels compute. They hold the selection logic, the
# part of each kernel that is not a product, against the plain version and
# the JAX kernels.

H_TILE, H_QUEUE = 64, 10     # queue capacity in column pairs


def _raw_dists(q, t):
    """Unclamped (|q|^2 + |t|^2) - 2 q.t in f32, as the kernels and
    knn_plain evaluate it (2 q.t is exact, so one rounding either way)."""
    q, t = q.to(torch.float32), t.to(torch.float32)
    return ((q * q).sum(-1)[:, None] + (t * t).sum(-1)[None, :]) \
        - 2.0 * (q @ t.T)


def _insert(ld, li, v, i, mask):
    """Insert (v, i) into the ascending lists (..., KMAX) where mask and v is
    below the tail; strict comparisons (every listed column precedes i)."""
    m = mask & (v < ld[..., -1])
    vv, ii = v[..., None], i[..., None].expand_as(v[..., None])
    lt_prev = vv < ld[..., :-1]
    lt_cur = vv < ld[..., 1:]
    rest_d = torch.where(lt_prev, ld[..., :-1],
                         torch.where(lt_cur, vv, ld[..., 1:]))
    rest_i = torch.where(lt_prev, li[..., :-1],
                         torch.where(lt_cur, ii, li[..., 1:]))
    first = vv < ld[..., :1]
    new_d = torch.cat([torch.where(first, vv, ld[..., :1]), rest_d], -1)
    new_i = torch.cat([torch.where(first, ii, li[..., :1]), rest_i], -1)
    return (torch.where(m[..., None], new_d, ld),
            torch.where(m[..., None], new_i, li))


def emulate_h_selection(raw, k):
    """Kernel H's selection over raw (N, M) distances: returns (dists (N, k),
    idx (N, k), admitted candidates per row, slow tiles per warp). Rows go in
    warps of 16 (lane quad g holds rows g and g + 8), columns in tiles of 64
    (lane q4 of a quad sees 8 j + 2 q4 + e); each lane keeps a KMAX-slot
    list per row with the first KMAX - k pinned at -1. A warp takes the slow
    path on a tile when any of its rows has a candidate below its threshold:
    it merges every lane's queues first if one holds more than 2 column
    pairs (refreshing each threshold to the minimum of the own tail, the
    quad's minimum tail and the quad's maximum ceil(k/4)-th entry), then
    queues every column pair (8 j + 2 q4, + 1) holding a candidate below
    the threshold."""
    n, m = raw.shape
    kmax = next(c for c in (2, 4, 8, 10, 12, 16) if k <= c)
    w = -(-n // 16)
    n_tiles = -(-m // H_TILE)
    pad = torch.full((w * 16, n_tiles * H_TILE), float("inf"))
    pad[:n, :m] = raw
    # d[w, g, q4, h, col]: row w * 16 + h * 8 + g
    rows = pad.view(w, 2, 8, -1).permute(0, 2, 1, 3)[:, :, None]
    rows = rows.expand(-1, -1, 4, -1, -1)
    shape = (w, 8, 4, 2)
    inf, imax = float("inf"), 2 ** 31 - 1
    ld = torch.full(shape + (kmax,), inf)
    ld[..., :kmax - k] = -1.0
    li = torch.full(shape + (kmax,), imax, dtype=torch.int64)
    qd = torch.zeros(shape + (2 * H_QUEUE,))
    qi = torch.zeros(shape + (2 * H_QUEUE,), dtype=torch.int64)
    cnt = torch.zeros(shape, dtype=torch.int64)      # queued entries
    pairs = torch.zeros(shape, dtype=torch.int64)    # queued column pairs
    thr = torch.full(shape, inf)
    admitted = torch.zeros(shape)
    slow_tiles = torch.zeros(w)
    quarter = kmax - k + (k + 3) // 4 - 1
    q4 = torch.arange(4)[None, None, :, None]

    def merge(sel):
        nonlocal ld, li, cnt, pairs, thr
        s4 = sel[:, None, None, None]
        for s in range(2 * H_QUEUE):
            ld, li = _insert(ld, li, qd[..., s], qi[..., s], s4 & (s < cnt))
        cnt = torch.where(s4, 0, cnt)
        pairs = torch.where(s4, 0, pairs)
        bound = ld[..., quarter].amax(2, keepdim=True)
        tmin = ld[..., -1].amin(2, keepdim=True)
        new = torch.minimum(torch.minimum(thr, ld[..., -1]),
                            torch.minimum(bound, tmin))
        thr = torch.where(s4, new, thr)

    for t in range(n_tiles):
        cols = [t * H_TILE + 8 * j + 2 * q4 + e
                for j in range(H_TILE // 8) for e in range(2)]
        ds = [torch.gather(rows, 4, c.expand(shape)[..., None])[..., 0]
              for c in cols]
        slow = torch.stack([(d < thr) for d in ds]).flatten(2).any(-1) \
            .any(0)
        slow_tiles += slow
        merge(slow & (pairs > H_QUEUE - 8).flatten(1).any(1))
        for idx, (c, d) in enumerate(zip(cols, ds)):
            ok = (d < thr) & slow[:, None, None, None]
            admitted += ok
            slot = torch.nn.functional.one_hot(
                cnt.clamp(max=2 * H_QUEUE - 1), 2 * H_QUEUE).bool() \
                & ok[..., None]
            qd = torch.where(slot, d.clamp(min=0.0)[..., None], qd)
            qi = torch.where(slot, c.expand(shape)[..., None], qi)
            cnt = cnt + ok
            if idx % 2:          # a column pair holding an admitted entry
                pairs = pairs + (ok | ((ds[idx - 1] < thr)
                                       & slow[:, None, None, None]))
        assert int(pairs.max()) <= H_QUEUE
    merge((cnt > 0).flatten(1).any(1))
    # the quad's four lists of each row, pins dropped, merged
    ld, li = ld[..., kmax - k:], li[..., kmax - k:]
    cand_d = ld.permute(0, 3, 1, 2, 4).reshape(w * 16, 4 * k)
    cand_i = li.permute(0, 3, 1, 2, 4).reshape(w * 16, 4 * k)
    key = cand_d.clone()
    key[cand_i == imax] = inf
    order = torch.argsort(cand_i, dim=1)                     # column order
    key, cand_i = torch.gather(key, 1, order), torch.gather(cand_i, 1, order)
    top = torch.sort(key, dim=1, stable=True)
    d_out = top.values[:n, :k]
    i_out = torch.gather(cand_i, 1, top.indices)[:n, :k].to(torch.int32)
    i_out = torch.where(torch.isfinite(d_out), i_out,
                        torch.full_like(i_out, -1))
    adm = admitted.permute(0, 3, 1, 2).reshape(w * 16, 4).sum(1)[:n]
    return d_out, i_out, adm, slow_tiles


def emulate_f_selection(raw, k):
    """Kernel F's pair selection (csrc/knn_topk.cu at k <= 2) over raw
    (N, M) distances: returns (dists (N, k), idx (N, k), candidates below
    the threshold per row, slow tiles per warp). The tiling and lane ownership are H's; each lane keeps a
    two-slot list per row (the first 2 - k pinned at -1) and no queues. A
    warp takes the slow path on a tile when any of its rows has a candidate
    below its threshold: for each row half (rows g, then g + 8) where some
    lane has one, every lane folds its 16 columns of that row into its
    list in column order (clamped at 0, strict comparisons), then the
    thresholds refresh to the minimum of the own tail, the quad's minimum
    tail and the quad's maximum ceil(k/4)-th entry."""
    n, m = raw.shape
    w = -(-n // 16)
    n_tiles = -(-m // H_TILE)
    pad = torch.full((w * 16, n_tiles * H_TILE), float("inf"))
    pad[:n, :m] = raw
    rows = pad.view(w, 2, 8, -1).permute(0, 2, 1, 3)[:, :, None]
    rows = rows.expand(-1, -1, 4, -1, -1)
    shape = (w, 8, 4, 2)
    inf, imax = float("inf"), 2 ** 31 - 1
    d0 = torch.full(shape, -1.0 if k == 1 else inf)
    d1 = torch.full(shape, inf)
    i0 = torch.full(shape, imax, dtype=torch.int64)
    i1 = i0.clone()
    thr = torch.full(shape, inf)
    admitted = torch.zeros(shape)
    slow_tiles = torch.zeros(w)
    quarter = 2 - k + (k + 3) // 4 - 1
    q4 = torch.arange(4)[None, None, :, None]
    for t in range(n_tiles):
        cols = [t * H_TILE + 8 * j + 2 * q4 + e
                for j in range(H_TILE // 8) for e in range(2)]
        ds = [torch.gather(rows, 4, c.expand(shape)[..., None])[..., 0]
              for c in cols]
        below = torch.stack([d < thr for d in ds]).any(0)    # (w, 8, 4, 2)
        half = below.flatten(1, 2).any(1)                    # (w, 2)
        slow = half.any(1)
        slow_tiles += slow
        fold = half[:, None, None, :].expand(shape)
        for c, d in zip(cols, ds):
            admitted += (d < thr) & fold
            v = d.clamp(min=0.0)
            lt0, lt1 = (v < d0) & fold, (v < d1) & fold
            d1, i1 = (torch.where(lt0, d0, torch.where(lt1, v, d1)),
                      torch.where(lt0, i0, torch.where(lt1, c, i1)))
            d0, i0 = torch.where(lt0, v, d0), torch.where(lt0, c, i0)
        ent = (d0, d1)[quarter]
        new = torch.minimum(torch.minimum(thr, d1),
                            torch.minimum(ent.amax(2, keepdim=True),
                                          d1.amin(2, keepdim=True)))
        thr = torch.where(slow[:, None, None, None], new, thr)
    ld = torch.stack([d0, d1], -1)[..., 2 - k:]
    li = torch.stack([i0, i1], -1)[..., 2 - k:]
    cand_d = ld.permute(0, 3, 1, 2, 4).reshape(w * 16, 4 * k)
    cand_i = li.permute(0, 3, 1, 2, 4).reshape(w * 16, 4 * k)
    key = cand_d.clone()
    key[cand_i == imax] = inf
    order = torch.argsort(cand_i, dim=1)                     # column order
    key, cand_i = torch.gather(key, 1, order), torch.gather(cand_i, 1, order)
    top = torch.sort(key, dim=1, stable=True)
    d_out = top.values[:n, :k]
    i_out = torch.gather(cand_i, 1, top.indices)[:n, :k].to(torch.int32)
    i_out = torch.where(torch.isfinite(d_out), i_out,
                        torch.full_like(i_out, -1))
    adm = admitted.permute(0, 3, 1, 2).reshape(w * 16, 4).sum(1)[:n]
    return d_out, i_out, adm, slow_tiles


def emulate_g_selection(dist):
    """Kernel G's selection over clamped (B, N, M) distances: tiles of 256
    columns, lane l of a warp owning columns 4 l + c and 128 + 4 l + c of
    each tile, a strict running top-2 per lane in column order, then five
    butterfly shuffles merging the 32 lanes' lists lexicographically."""
    b, n, m = dist.shape
    n_tiles = -(-m // 256)
    pad = torch.full((b, n, n_tiles * 256), float("inf"))
    pad[..., :m] = dist
    # lane l's columns in the order it visits them
    lane_cols = torch.stack([torch.cat([t * 256 + 4 * l + torch.arange(4),
                                        t * 256 + 128 + 4 * l
                                        + torch.arange(4)])
                             for l in range(32) for t in range(n_tiles)]) \
        .view(32, n_tiles * 8)
    inf, imax = float("inf"), 2 ** 31 - 1
    d1 = torch.full((b, n, 32), inf)
    d2 = torch.full((b, n, 32), inf)
    i1 = torch.full((b, n, 32), imax, dtype=torch.int64)
    i2 = i1.clone()
    for s in range(lane_cols.shape[1]):
        col = lane_cols[:, s]
        dd = pad[..., col]
        lt2, lt1 = dd < d2, dd < d1
        d2, i2 = (torch.where(lt1, d1, torch.where(lt2, dd, d2)),
                  torch.where(lt1, i1, torch.where(lt2, col, i2)))
        d1, i1 = torch.where(lt1, dd, d1), torch.where(lt1, col, i1)

    def lex_less(d, i, e, j):
        return (d < e) | ((d == e) & (i < j))

    lanes = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        p = lanes ^ off
        e1, j1, e2, j2 = d1[..., p], i1[..., p], d2[..., p], i2[..., p]
        other_first = lex_less(e1, j1, d1, i1)
        own = lex_less(d1, i1, e2, j2)
        sec_d = torch.where(other_first, torch.where(own, d1, e2),
                            torch.where(lex_less(e1, j1, d2, i2), e1, d2))
        sec_i = torch.where(other_first, torch.where(own, i1, j2),
                            torch.where(lex_less(e1, j1, d2, i2), j1, i2))
        d1, i1 = torch.where(other_first, e1, d1), \
            torch.where(other_first, j1, i1)
        d2, i2 = sec_d, sec_i
    d = torch.stack([d1[..., 0], d2[..., 0]], -1)
    i = torch.stack([i1[..., 0], i2[..., 0]], -1)
    real = torch.isfinite(d) & (i != imax)
    return (torch.where(real, d, torch.full_like(d, inf)),
            torch.where(real, i, torch.full_like(i, -1)).to(torch.int32))


@pytest.mark.parametrize("k", [3, 10, 16])
def test_h_selection_emulation_matches_plain_and_pallas(descs, k):
    """Ragged M (1,200 train rows: 18 full tiles and one of 48), f32
    distances, so the selection alone is held: indices identical to the
    plain version and the JAX kernel, distances identical to the plain
    version."""
    q, t = descs
    d, i, adm, _ = emulate_h_selection(_raw_dists(_t(q), _t(t)), k)
    d_p, i_p = knn_plain(_t(q), _t(t), k, bf16=False)
    _, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), k,
                               interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), i_p.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d.numpy(), d_p.numpy())
    # the thresholds prune: most candidates never reach a queue
    assert float(adm.mean()) < 0.5 * t.shape[0]


@pytest.mark.parametrize("k", [3, 10, 16])
def test_h_selection_emulation_ties_across_tiles_and_merges(k):
    """Exact ties that straddle a tile and a queue merge: each of 30 rows
    appears at 4 columns (c, c + 64, c + 67, c + 150), in other tiles or
    other lanes' slices; equal distances must still come out lowest index
    first."""
    rng = np.random.default_rng(k)
    base = rng.normal(size=(30, 24)).astype(np.float32)
    t = rng.normal(size=(230, 24)).astype(np.float32)
    first = np.arange(30) * 2
    for off in (0, 64, 67, 150):
        t[off + first] = base
    q = base + 0.01 * rng.normal(size=(30, 24)).astype(np.float32)
    d, i, _, _ = emulate_h_selection(_raw_dists(_t(q), _t(t)), k)
    d_p, i_p = knn_plain(_t(q), _t(t), k, bf16=False)
    _, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), k,
                               interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), i_p.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d.numpy(), d_p.numpy())
    np.testing.assert_array_equal(i[:, :3].numpy(),
                                  np.stack([first, first + 64, first + 67],
                                           1))


@pytest.mark.parametrize("k", [3, 10, 16])
def test_h_selection_emulation_fewer_train_rows_than_k(k):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(21, 16)).astype(np.float32)
    t = rng.normal(size=(2, 16)).astype(np.float32)
    d, i, _, _ = emulate_h_selection(_raw_dists(_t(q), _t(t)), k)
    _, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), k,
                               interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert np.all(i[:, 2:].numpy() == -1)
    assert np.all(np.isinf(d[:, 2:].numpy()))


@pytest.mark.parametrize("c,n,m", [(3, 80, 80), (2, 45, 300)])
def test_g_selection_emulation_matches_pallas_with_masked_rows(c, n, m):
    """Kernel G's tiling and merge on the pose chunk's masks (invalid
    queries at 1e6, invalid train rows at -1e6), against the JAX kernel in
    interpret mode and the plain version; (2, 45, 300) spans two tiles of
    256 train rows."""
    rng = np.random.default_rng(n + m)
    d = 64
    q = rng.standard_normal((c, n, d)).astype(np.float32)
    t = rng.standard_normal((c, m, d)).astype(np.float32)
    t[:, :40] = q[:, rng.permutation(n)[:40]] + 0.1 * rng.standard_normal(
        (c, 40, d))
    t[:, 260 % m] = t[:, 3]                  # an exact tie across tiles
    vq = rng.random((c, n)) < 0.8
    vt = rng.random((c, m)) < 0.8
    q = np.where(vq[..., None], q, 1e6).astype(np.float32)
    t = np.where(vt[..., None], t, -1e6).astype(np.float32)
    raw = torch.stack([_raw_dists(_t(q[b]), _t(t[b])) for b in range(c)])
    dist, idx = emulate_g_selection(raw.clamp(min=0.0))
    d_p, i_p = knn_plain(_t(q), _t(t), 2, bf16=False)
    _, i_j = jax_kp.knn2_fused_batched(jnp.asarray(q), jnp.asarray(t),
                                       interpret=True)
    np.testing.assert_array_equal(idx.numpy(), i_p.numpy())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(dist.numpy(), d_p.numpy())


@pytest.fixture(scope="module")
def f_ref(descs):
    """The JAX kernel F (interpret mode, f32) on the shared descriptors."""
    q, t = descs
    return jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t), interpret=True,
                             bf16=False)


@pytest.mark.parametrize("k", [1, 2])
def test_f_selection_emulation_matches_plain_and_pallas(descs, f_ref, k):
    """Kernel F's pair selection on ragged M (1,400 train rows: 21 full
    tiles and one of 56), f32 distances: indices identical to the plain
    version and to the JAX kernel (k = 1 as knn_match slices it),
    distances identical to the plain version; the thresholds prune most
    candidates (at this M a warp still takes the slow path on most tiles:
    16 rows x 4 lanes, each with a running bound)."""
    q, t = descs
    d, i, adm, _ = emulate_f_selection(_raw_dists(_t(q), _t(t)), k)
    d_p, i_p = knn_plain(_t(q), _t(t), k, bf16=False)
    np.testing.assert_array_equal(i.numpy(), i_p.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(f_ref[1])[:, :k])
    np.testing.assert_array_equal(d.numpy(), d_p.numpy())
    assert float(adm.mean()) < 0.1 * t.shape[0]


@pytest.mark.parametrize("k", [1, 2])
def test_f_selection_emulation_ties_across_tiles_and_merges(k):
    """Exact ties that straddle tiles and the quad merge (each of 30 rows at
    columns c, c + 64, c + 67, c + 150; M 230, not a multiple of 64): the
    lowest index first, as the plain version and the JAX kernel order
    them."""
    rng = np.random.default_rng(k)
    base = rng.normal(size=(30, 24)).astype(np.float32)
    t = rng.normal(size=(230, 24)).astype(np.float32)
    first = np.arange(30) * 2
    for off in (0, 64, 67, 150):
        t[off + first] = base
    q = base + 0.01 * rng.normal(size=(30, 24)).astype(np.float32)
    d, i, _, _ = emulate_f_selection(_raw_dists(_t(q), _t(t)), k)
    d_p, i_p = knn_plain(_t(q), _t(t), k, bf16=False)
    _, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                               interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), i_p.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j)[:, :k])
    np.testing.assert_array_equal(d.numpy(), d_p.numpy())
    np.testing.assert_array_equal(i.numpy(), np.stack([first, first + 64],
                                                      1)[:, :k])


def test_f_selection_emulation_fewer_than_two_train_rows():
    """M = 1: the second slot stays (inf, -1), as in the JAX kernel."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(21, 16)).astype(np.float32)
    t = rng.normal(size=(1, 16)).astype(np.float32)
    d, i, _, _ = emulate_f_selection(_raw_dists(_t(q), _t(t)), 2)
    d_j, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                                 interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert np.all(i[:, 1].numpy() == -1) and np.all(i[:, 0].numpy() == 0)
    assert np.all(np.isinf(d[:, 1].numpy()))
    np.testing.assert_allclose(d[:, 0].numpy(), np.asarray(d_j)[:, 0],
                               **DIST)


# -- the f32 mode on the card: a 3xTF32 split product ------------------------
# csrc/knn_topk.cu's f32 mode splits every element x into hi = rna_tf32(x)
# and lo = rna_tf32(x - hi) and forms q.t as hi_q.hi_t + (lo_q.hi_t +
# hi_q.lo_t), the norms summed in f64 from the unsplit x and rounded once.
# The emulation below repeats that arithmetic in plain PyTorch (products
# in f32, without the tensor cores' truncating accumulation) and feeds its
# raw distances to the selection emulations, held against the JAX kernels
# in f32.


def tf32_rna(x):
    """x (f32) rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, by bit operations on its int32 view: the value
    cvt.rna.tf32.f32 gives (inf and nan pass through)."""
    x = x.to(torch.float32).contiguous()
    u = x.view(torch.int32)
    r = ((u + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x):
    """(hi, lo) of the kernel's pre-pass."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _raw_dists_split(q, t):
    """Unclamped (|q|^2 + |t|^2) - 2 q.t with q.t as the kernel forms it
    from the split operands (hi.hi, plus the small products summed apart);
    norms from the unsplit rows, summed in f64 and rounded to f32."""
    q, t = q.to(torch.float32), t.to(torch.float32)
    (qh, ql), (th, tl) = split_tf32(q), split_tf32(t)
    g = qh @ th.T + (ql @ th.T + qh @ tl.T)
    nq = (q.double() ** 2).sum(-1).float()
    nt = (t.double() ** 2).sum(-1).float()
    return (nq[:, None] + nt[None, :]) - 2.0 * g


def test_tf32_rna_rounding():
    """Ties go away from zero on both signs, values below half a tf32 ulp
    round down, zero keeps its sign, and hi + lo gives x back within 2^-22
    of |x|."""
    one, half, eps = 1.0, 2.0 ** -11, 2.0 ** -23
    x = torch.tensor([one + half, -(one + half), one + half - eps,
                      -(one + half - eps), one + 3 * half, 0.0, -0.0,
                      float("inf"), 1.5 * 2.0 ** -130], dtype=torch.float32)
    r = tf32_rna(x)
    want = [one + 2 * half, -(one + 2 * half), one, -one, one + 4 * half,
            0.0, -0.0, float("inf"), 1.5 * 2.0 ** -130]
    np.testing.assert_array_equal(r.numpy(),
                                  np.array(want, dtype=np.float32))
    assert np.signbit(r[6].numpy()) and not np.signbit(r[5].numpy())
    assert bool(torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all())
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = split_tf32(v)
    for part in (hi, lo):             # tf32 values: the low 13 bits are 0
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())
    assert bool(((v - hi).abs() <= 2.0 ** -11 * v.abs()).all())


def _split_case(n, m, d, scale, seed):
    """Realistic-margin clusters (the module's descriptors at another size)
    with row norms near ``scale``."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(m, d)).astype(np.float32)
    q = centres[:n] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    t = centres[rng.permutation(m)]
    f = np.float32(scale / np.sqrt(d))
    return (q * f).astype(np.float32), (t * f).astype(np.float32)


def _hold_near_ties(q, t, d, i, d_ref, i_ref, atol_of_mag):
    """f32 parity rule: distances within 1e-5 relative plus an absolute
    part (1e-5, or 1e-5 x (|q|^2 + |t|^2) with ``atol_of_mag``) of the
    reference at the reference's index; indices identical except at
    near-ties, where the pick's distance (f64) is the reference's within
    the same tolerance, and no row repeats an index. Returns the number of
    near-tie swaps."""
    q64, t64 = torch.from_numpy(q).double(), torch.from_numpy(t).double()
    d_ref = torch.from_numpy(np.array(d_ref)).double()
    i_ref = torch.from_numpy(np.array(i_ref)).long()
    atol = 1e-5 * ((q64 * q64).sum(1)[:, None]
                   + (t64 * t64).sum(1)[i_ref.clamp(min=0)]) \
        if atol_of_mag else 1e-5
    tol = 1e-5 * d_ref.abs() + atol
    assert bool(((d.double() - d_ref).abs() <= tol).all())
    r, s = (i.long() != i_ref).nonzero(as_tuple=True)
    pick = i[r, s].long()
    d_pick = ((q64[r] - t64[pick]) ** 2).sum(1)
    assert bool(((d_pick - d_ref[r, s]).abs() <= tol[r, s]).all())
    srt = i.sort(dim=1).values
    assert not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any())
    return r.numel()


@pytest.fixture(scope="module")
def split_cases():
    """The JAX kernels (interpret mode, f32) on unit-scale descriptors and
    on descriptors with norms near 1e2, at d 64 and d 576."""
    out = {}
    for d in (64, 576):
        for scale in (1.0, 100.0):
            q, t = _split_case(160, 448, d, scale, seed=d + int(scale))
            jq, jt = jnp.asarray(q), jnp.asarray(t)
            out[d, scale] = (q, t, {
                2: jax_kp.knn2_fused(jq, jt, interpret=True, bf16=False),
                10: jax_kp.knnk_fused(jq, jt, 10, interpret=True,
                                      bf16=False)})
    return out


@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("d", [64, 576])
@pytest.mark.parametrize("k", [2, 10])
def test_split_product_selection_matches_pallas_f32(split_cases, k, d,
                                                    scale):
    """The f32 mode's arithmetic (the split product, then F's pair selection
    at k 2 and H's queued selection at k 10) against the JAX kernels in
    f32: distances within 1e-5 relative plus 1e-5 absolute at unit scale,
    plus 1e-5 x (|q|^2 + |t|^2) at norms near 1e2 (the magnitude the
    expanded form cancels, whose f32 rounding any two orders differ by);
    indices identical except verified near-ties (at most 2 here).
    knn_plain(bf16=False) meets the same rule against the same
    references."""
    q, t, ref = split_cases[d, scale]
    d_j, i_j = ref[k]
    emulate = emulate_f_selection if k == 2 else emulate_h_selection
    dist, idx, _, _ = emulate(_raw_dists_split(_t(q), _t(t)), k)
    assert _hold_near_ties(q, t, dist, idx, d_j, i_j, scale != 1.0) <= 2
    d_p, i_p = knn_plain(_t(q), _t(t), k, bf16=False)
    _hold_near_ties(q, t, d_p, i_p, d_j, i_j, scale != 1.0)
