"""The port's kernel modules on the CPU, held against the JAX package.

Every kernel wrapper of ``repro_torch.kernels`` runs its plain-PyTorch
version on CPU tensors.  Each is held, on the same numpy-made inputs,
against the ``repro.kernels.ref`` oracle and against the Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it), at that file's
shapes.  Tolerance: the repo's kernel tolerances (``tests/test_kernels.py``):
3e-4 absolute and relative in float32 — the two frameworks sum the same
products in different orders — and 6e-2 in bfloat16, where the two round
at different places.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attn as pallas_decode_attn
from repro.kernels.hstu_attn import hstu_attn as pallas_hstu_attn
from repro.kernels.paged_prefix_attn import (
    paged_prefix_rank_attn as pallas_paged_rank_attn)
from repro.kernels.paged_prefix_attn import (
    segment_rank_attn as pallas_segment_rank_attn)
from repro.kernels.prefix_rank_attn import (
    prefix_rank_attn as pallas_prefix_rank_attn)
from repro.kernels.ssd_chunk import ssd_chunk_intra as pallas_ssd_intra
from repro.kernels.ssd_chunk import ssd_chunk_state as pallas_ssd_state
from repro_torch.kernels import (cuda_lib, decode_attn, hstu_attn, ops,
                                 paged_prefix_attn, prefix_rank_attn, ref,
                                 ssd_chunk)

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

TOL = dict(atol=3e-4, rtol=3e-4)
TOL_BF16 = dict(atol=6e-2, rtol=6e-2)


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,bq,bk", [(128, 128, 128), (256, 128, 64),
                                     (512, 256, 256)])
@pytest.mark.parametrize("D", [64, 128])
def test_hstu_attn_matches_ref_and_pallas(S, bq, bk, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (_mk(rng, 2, 2, S, D) for _ in range(3))
    got = hstu_attn.hstu_attn(_t(q), _t(k), _t(v))
    _close(got, jref.hstu_attn_ref(q, k, v))
    _close(got, pallas_hstu_attn(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), bq=bq, bk=bk,
                                 interpret=True))


@pytest.mark.parametrize("n_prefix,n_incr,n_items",
                         [(128, 64, 64), (256, 64, 192), (512, 128, 384)])
def test_prefix_rank_attn_matches_ref_and_pallas(n_prefix, n_incr, n_items):
    rng = np.random.default_rng(n_prefix + n_items)
    B, H, D = 2, 2, 64
    Sq, Sk = n_incr + n_items, n_prefix + n_incr + n_items
    q, k, v = _mk(rng, B, H, Sq, D), _mk(rng, B, H, Sk, D), _mk(rng, B, H, Sk, D)
    got = prefix_rank_attn.prefix_rank_attn(_t(q), _t(k), _t(v),
                                            n_prefix=n_prefix, n_incr=n_incr)
    _close(got, jref.prefix_rank_attn_ref(q, k, v, n_prefix=n_prefix,
                                          n_incr=n_incr))
    _close(got, pallas_prefix_rank_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_prefix=n_prefix,
        n_incr=n_incr, bq=64, bk=64, interpret=True))
    # the split entry point (no concatenation) is the same function
    split = prefix_rank_attn.prefix_rank_attn_split(
        _t(q), _t(k[:, :, :n_prefix]), _t(v[:, :, :n_prefix]),
        _t(k[:, :, n_prefix:]), _t(v[:, :, n_prefix:]), n_incr=n_incr)
    assert torch.equal(split, got)


def _paged_case(plens, bucket, pt, n_incr, n_items, seed=3):
    """Dense psi zero-padded to the bucket and the same prefixes packed
    into pool pages (the reference's own packer), as numpy."""
    from repro.kernels.paged_prefix_attn import pack_pages
    rng = np.random.default_rng(seed)
    B, H, D = len(plens), 2, 64
    Sq = n_incr + n_items
    q, kn, vn = (_mk(rng, B, H, Sq, D) for _ in range(3))
    kp = np.zeros((B, H, bucket, D), np.float32)
    vp = np.zeros_like(kp)
    for b, p in enumerate(plens):
        kp[b, :, :p], vp[b, :, :p] = _mk(rng, H, p, D), _mk(rng, H, p, D)
    paged = pack_pages(kp, vp, plens, pt, n_pages=bucket // pt)
    return q, kp, vp, kn, vn, tuple(np.asarray(a) for a in paged)


@pytest.mark.parametrize("plens,bucket,pt,n_incr,n_items", [
    ([128, 128], 128, 64, 32, 32), ([256, 256], 256, 64, 32, 32),
    ([256, 256], 256, 128, 64, 64), ([100, 37, 128], 128, 64, 32, 32),
    ([1, 200, 64], 256, 64, 32, 32), ([90, 128], 128, 64, 16, 48)])
def test_paged_matches_pallas_with_equal_tables(plens, bucket, pt, n_incr,
                                                n_items):
    """Equal K and V tables give the reference kernel's interface: the
    plain paged version matches the Pallas paged kernel, the dense
    oracle on zero-padded psi, and the port's own dense version."""
    q, kp, vp, kn, vn, (kpg, vpg, table, pl_) = _paged_case(
        plens, bucket, pt, n_incr, n_items)
    nt = bucket + n_incr + n_items
    got = paged_prefix_attn.paged_prefix_rank_attn(
        _t(q), _t(kpg), _t(vpg), _t(table), _t(table), _t(pl_), _t(kn),
        _t(vn), n_incr=n_incr)
    want = pallas_paged_rank_attn(
        *map(jnp.asarray, (q, kpg, vpg, table, pl_, kn, vn)), n_incr=n_incr,
        bq=32, bk=pt, n_total=nt, interpret=True)
    _close(got, want)
    k, v = np.concatenate([kp, kn], 2), np.concatenate([vp, vn], 2)
    _close(got, jref.prefix_rank_attn_ref(q, k, v, n_prefix=bucket,
                                          n_incr=n_incr))
    dense = prefix_rank_attn.prefix_rank_attn(_t(q), _t(k), _t(v),
                                              n_prefix=bucket, n_incr=n_incr)
    _close(got, dense)


def _bf16_close(got, want):
    """A bf16 twin against a bf16 JAX result: ``tests/test_kernels.py``'s
    bf16 tolerance (6e-2), in float32."""
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


@pytest.mark.parametrize("S,bq,bk", [(128, 128, 128), (256, 128, 64),
                                     (512, 256, 256)])
@pytest.mark.parametrize("D", [64, 128])
def test_hstu_attn_bf16_matches_ref_and_pallas(S, bq, bk, D):
    """Row 1's twin on bf16 q, k, v (``tests/test_kernels.py:31`` sweeps
    the Pallas kernel in bf16): against the Pallas kernel in interpret
    mode and the JAX oracle on the same bf16 inputs, in bf16 out."""
    rng = np.random.default_rng(S + D + 1)
    (jq, tq), (jk, tk), (jv, tv) = (_jt(_mk(rng, 2, 2, S, D), "bfloat16")
                                    for _ in range(3))
    got = hstu_attn.hstu_attn(tq, tk, tv)
    _bf16_close(got, pallas_hstu_attn(jq, jk, jv, bq=bq, bk=bk,
                                      interpret=True))
    _bf16_close(got, jref.hstu_attn_ref(jq, jk, jv))


@pytest.mark.parametrize("n_prefix,n_incr,n_items",
                         [(128, 64, 64), (256, 64, 192), (512, 128, 384)])
def test_prefix_rank_attn_bf16_matches_ref_and_pallas(n_prefix, n_incr,
                                                      n_items):
    """Row 2's twin in bf16 (``tests/test_kernels.py:45``): against the
    Pallas kernel and the oracle; the split entry point equals the
    concatenating one bit for bit."""
    rng = np.random.default_rng(n_prefix + n_items + 1)
    B, H, D = 2, 2, 64
    Sq, Sk = n_incr + n_items, n_prefix + n_incr + n_items
    (jq, tq), (jk, tk), (jv, tv) = (
        _jt(_mk(rng, B, H, n, D), "bfloat16") for n in (Sq, Sk, Sk))
    got = prefix_rank_attn.prefix_rank_attn(tq, tk, tv, n_prefix=n_prefix,
                                            n_incr=n_incr)
    _bf16_close(got, pallas_prefix_rank_attn(
        jq, jk, jv, n_prefix=n_prefix, n_incr=n_incr, bq=64, bk=64,
        interpret=True))
    _bf16_close(got, jref.prefix_rank_attn_ref(jq, jk, jv, n_prefix=n_prefix,
                                               n_incr=n_incr))
    split = prefix_rank_attn.prefix_rank_attn_split(
        tq, tk[:, :, :n_prefix], tv[:, :, :n_prefix], tk[:, :, n_prefix:],
        tv[:, :, n_prefix:], n_incr=n_incr)
    assert torch.equal(split, got)


@pytest.mark.parametrize("plens,bucket,pt,n_incr,n_items", [
    ([128, 128], 128, 64, 32, 32), ([100, 37, 128], 128, 64, 32, 32),
    ([1, 200, 64], 256, 64, 32, 32), ([90, 128], 128, 32, 16, 48)])
def test_paged_bf16_matches_pallas_with_equal_tables(plens, bucket, pt,
                                                     n_incr, n_items):
    """Row 3's twin on a bf16 pool and bf16 q / new K/V
    (``tests/test_kernels.py:100``): against the Pallas paged kernel and
    the oracle on zero-padded dense psi; equal to the port's dense twin
    on the gathered prefix bit for bit."""
    q, kp, vp, kn, vn, (kpg, vpg, table, pl_) = _paged_case(
        plens, bucket, pt, n_incr, n_items)
    nt = bucket + n_incr + n_items
    (jq, tq), (jkn, tkn), (jvn, tvn), (jkp, tkp), (jvp, tvp) = (
        _jt(a, "bfloat16") for a in (q, kn, vn, kpg, vpg))
    got = paged_prefix_attn.paged_prefix_rank_attn(
        tq, tkp, tvp, _t(table), _t(table), _t(pl_), tkn, tvn, n_incr=n_incr)
    _bf16_close(got, pallas_paged_rank_attn(
        jq, jkp, jvp, *map(jnp.asarray, (table, pl_)), jkn, jvn,
        n_incr=n_incr, bq=32, bk=pt, n_total=nt, interpret=True))
    jk, jv = (jnp.asarray(np.concatenate([a, b], 2), jnp.bfloat16)
              for a, b in ((kp, kn), (vp, vn)))
    _bf16_close(got, jref.prefix_rank_attn_ref(jq, jk, jv, n_prefix=bucket,
                                               n_incr=n_incr))
    kg = ref.gather_pages(tkp, _t(table), _t(pl_))
    vg = ref.gather_pages(tvp, _t(table), _t(pl_))
    dense = prefix_rank_attn.prefix_rank_attn_split(tq, kg, vg, tkn, tvn,
                                                    n_incr=n_incr)
    assert torch.equal(dense, got)


def test_pack_pages_matches_reference_packer():
    from repro.kernels.paged_prefix_attn import pack_pages as jpack
    rng = np.random.default_rng(5)
    kd, vd = _mk(rng, 3, 2, 128, 64), _mk(rng, 3, 2, 128, 64)
    for a, b in zip(paged_prefix_attn.pack_pages(kd, vd, [100, 37, 128], 64),
                    jpack(kd, vd, [100, 37, 128], 64)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("page_tokens,lens", [(64, [128, 100, 7]),
                                              (32, [64, 33, 96])])
def test_paged_on_live_layout_matches_gather_psi(page_tokens, lens):
    """The live pool stores each layer's K and V as DISTINCT pages of one
    buffer with a (B, L, 2, np) table.  Per layer, the port's paged
    version with separate K / V tables equals the reference live path:
    ``executors._gather_psi`` then the dense oracle."""
    from repro.core.executors import _gather_psi
    rng = np.random.default_rng(page_tokens)
    L, H, D, n_incr, n_items = 2, 2, 32, 8, 16
    B, n_pages = len(lens), 128 // page_tokens
    Sq = n_incr + n_items
    n_pool = B * L * 2 * n_pages
    pool = np.zeros((n_pool + 1, page_tokens, H, D), np.float32)
    tables = np.full((B, L, 2, n_pages), n_pool, np.int32)
    ids = rng.permutation(n_pool)
    nxt = 0
    for b, ln in enumerate(lens):
        for layer in range(L):
            for kv in range(2):
                for j in range(-(-ln // page_tokens)):
                    valid = min(page_tokens, ln - j * page_tokens)
                    pid = int(ids[nxt])
                    nxt += 1
                    pool[pid, :valid] = _mk(rng, valid, H, D)
                    tables[b, layer, kv, j] = pid
    k_all, v_all = _gather_psi(jnp, jnp.asarray(pool), jnp.asarray(tables))
    P = n_pages * page_tokens
    for layer in range(L):
        q, kn, vn = (_mk(rng, B, H, Sq, D) for _ in range(3))
        kp = np.moveaxis(np.asarray(k_all[layer]), 1, 2)   # (B, H, P, D)
        vp = np.moveaxis(np.asarray(v_all[layer]), 1, 2)
        want = jref.prefix_rank_attn_ref(
            q, np.concatenate([kp, kn], 2), np.concatenate([vp, vn], 2),
            n_prefix=P, n_incr=n_incr)
        tt = torch.from_numpy(tables)
        got = paged_prefix_attn.paged_prefix_rank_attn(
            _t(q), _t(pool), _t(pool), tt[:, layer, 0], tt[:, layer, 1],
            torch.tensor(lens, dtype=torch.int32), _t(kn), _t(vn),
            n_incr=n_incr)
        _close(got, want)


def _segment_case(patterns, n_items, pt, seed=11, n_pages=None):
    """``tests/test_kernels.py``'s interleaved case, as numpy float32.

    ``patterns[b]`` is an ordered list of ('c', ln) cached-span / ('f',
    ln) fresh-token chunks with the same fresh count Sq in every row,
    the last ``n_items`` fresh tokens the items.  Returns the fresh-token
    q/k/v, the reference packer's span pool (k_pages, v_pages, table,
    page_pos, page_valid), q_pos, and the full dense interleaved
    sequence with its positions (padded rows at a sentinel position)."""
    from repro.kernels.paged_prefix_attn import pack_segments
    rng = np.random.default_rng(seed)
    B, H, D = len(patterns), 2, 64
    SENTINEL = 1 << 20
    Sq = sum(ln for kind, ln in patterns[0] if kind == "f")
    spans, fpos, totals = [], [], []
    for row in patterns:
        assert sum(ln for kind, ln in row if kind == "f") == Sq
        assert row[-1][0] == "f" and row[-1][1] >= n_items
        pos, sp, fp = 0, [], []
        for kind, ln in row:
            if kind == "c":
                sp.append((pos, ln))
            else:
                fp.extend(range(pos, pos + ln))
            pos += ln
        spans.append(sp)
        fpos.append(fp)
        totals.append(pos)
    S_max = max(totals)
    k_full, v_full = _mk(rng, B, H, S_max, D), _mk(rng, B, H, S_max, D)
    k_pos = np.full((B, S_max), SENTINEL, np.int32)
    for b, S_b in enumerate(totals):
        k_pos[b, :S_b] = np.arange(S_b)
    q = _mk(rng, B, H, Sq, D)
    q_pos = np.asarray(fpos, np.int32)
    idx = np.broadcast_to(q_pos[:, None, :, None], (B, H, Sq, D))
    kn = np.take_along_axis(k_full, idx, axis=2)
    vn = np.take_along_axis(v_full, idx, axis=2)
    C_max = max(sum(ln for _, ln in sp) for sp in spans)
    kc = np.zeros((B, H, C_max, D), np.float32)
    vc = np.zeros_like(kc)
    for b, sp in enumerate(spans):
        off = 0
        for start, ln in sp:
            kc[b, :, off:off + ln] = k_full[b, :, start:start + ln]
            vc[b, :, off:off + ln] = v_full[b, :, start:start + ln]
            off += ln
    pages = pack_segments(kc, vc, spans, pt, n_pages=n_pages)
    return q, kn, vn, pages, q_pos, k_full, v_full, k_pos


SEGMENT_PATTERNS = [
    [("c", 64), ("f", 32), ("c", 64), ("f", 32)],
    [("c", 30), ("f", 10), ("c", 50), ("f", 22), ("c", 17), ("f", 32)],
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_twin_matches_pallas_and_interleaved_oracle(dtype):
    """Cached interior spans interleaved with fresh tokens, a different
    layout in each row of one launch (``tests/test_kernels.py``'s case):
    the twin matches the Pallas segment kernel in interpret mode and the
    dense interleaved oracle, in both the reference's and the port's
    form — a fresh token between two spans must not see the later one."""
    pt, n_items = 64, 32
    q, kn, vn, (kp, vp, table, ppos, pval), q_pos, k_full, v_full, k_pos = \
        _segment_case(SEGMENT_PATTERNS, n_items, pt)
    nt = table.shape[1] * pt + q.shape[2]
    (jq, tq), (jkn, tkn), (jvn, tvn), (jkp, tkp), (jvp, tvp) = (
        _jt(a, dtype) for a in (q, kn, vn, kp, vp))
    got = paged_prefix_attn.segment_rank_attn(
        tq, tkp, tvp, _t(table), _t(table), _t(ppos), _t(pval), _t(q_pos),
        tkn, tvn, n_items=n_items)
    assert got.dtype == tq.dtype
    tol = TOL if dtype == "float32" else TOL_BF16
    want = pallas_segment_rank_attn(
        jq, jkp, jvp, *map(jnp.asarray, (table, ppos, pval, q_pos)), jkn,
        jvn, n_items=n_items, bq=32, bk=pt, n_total=nt, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    oracle = jref.segment_rank_attn_ref(q, k_full, v_full, q_pos=q_pos,
                                        k_pos=k_pos, n_items=n_items,
                                        n_total=nt)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle), **tol)
    dense = ref.segment_rank_attn_ref(
        _t(q), _t(k_full), _t(v_full), q_pos=_t(q_pos), k_pos=_t(k_pos),
        n_items=n_items, n_total=nt)
    _close(dense, oracle)


@pytest.mark.parametrize("plens,bucket,pt", [([128, 128], 128, 64),
                                             ([100, 37, 128], 128, 64),
                                             ([100, 37, 128], 128, 32)])
def test_segment_twin_degenerates_to_paged_bitwise(plens, bucket, pt):
    """One span at [0, prefix_len) with the fresh tokens after it: every
    mask bit is the paged kernel's, so the segment twin equals the
    port's paged twin bit for bit, and both the Pallas segment kernel
    within the f32 tolerance."""
    n_incr, n_items = 32, 32
    Sq = n_incr + n_items
    q, kp, vp, kn, vn, (kpg, vpg, table, pl_) = _paged_case(
        plens, bucket, pt, n_incr, n_items)
    paged = paged_prefix_attn.paged_prefix_rank_attn(
        _t(q), _t(kpg), _t(vpg), _t(table), _t(table), _t(pl_), _t(kn),
        _t(vn), n_incr=n_incr)
    spans = [[(0, int(p))] for p in plens]
    skp, svp, stab, ppos, pval = paged_prefix_attn.pack_segments(
        kp, vp, spans, pt, n_pages=bucket // pt)
    q_pos = np.asarray(plens, np.int32)[:, None] + np.arange(Sq,
                                                             dtype=np.int32)
    got = paged_prefix_attn.segment_rank_attn(
        _t(q), _t(skp), _t(svp), _t(stab), _t(stab), _t(ppos), _t(pval),
        _t(q_pos), _t(kn), _t(vn), n_items=n_items)
    assert got.numpy().tobytes() == paged.numpy().tobytes()
    want = pallas_segment_rank_attn(
        *map(jnp.asarray, (q, skp, svp, stab, ppos, pval, q_pos, kn, vn)),
        n_items=n_items, bq=32, bk=pt, n_total=bucket + Sq, interpret=True)
    _close(got, want)


def test_pack_segments_matches_reference_packer():
    from repro.kernels.paged_prefix_attn import pack_segments as jpack
    rng = np.random.default_rng(6)
    kc, vc = _mk(rng, 2, 2, 120, 64), _mk(rng, 2, 2, 120, 64)
    spans = [[(0, 50), (60, 30), (100, 40)], [(0, 7), (20, 64)]]
    for pt in (16, 64):
        for a, b in zip(paged_prefix_attn.pack_segments(kc, vc, spans, pt),
                        jpack(kc, vc, spans, pt)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_segment_ops_model_layout():
    """ops.segment_rank_attention takes the model layout (B, S, H, D)
    and one pool for K and V, as ``rank_with_segments`` calls it."""
    pt, n_items = 64, 32
    q, kn, vn, (kp, vp, table, ppos, pval), q_pos, _, _, _ = \
        _segment_case(SEGMENT_PATTERNS, n_items, pt)
    pool = np.concatenate([kp[:-1], vp])            # K pages, V pages, null
    n_k = kp.shape[0] - 1
    vt = np.where(table == n_k, pool.shape[0] - 1, table + n_k).astype(np.int32)
    got = ops.segment_rank_attention(
        *(_t(np.swapaxes(a, 1, 2)) for a in (q, kn, vn)), _t(pool),
        _t(table), _t(vt), _t(ppos), _t(pval), _t(q_pos), n_items=n_items)
    want = paged_prefix_attn.segment_rank_attn(
        _t(q), _t(kp), _t(vp), _t(table), _t(table), _t(ppos), _t(pval),
        _t(q_pos), _t(kn), _t(vn), n_items=n_items)
    assert torch.equal(got, want.transpose(1, 2))


def test_rank_mask_matches_reference_and_model():
    from repro.models.hstu import rank_mask as jmask
    from repro_torch.models.hstu import rank_mask
    for n_prefix, n_incr, n_items in ((8, 4, 6), (0, 3, 5), (5, 0, 4)):
        want = np.asarray(jref.rank_mask_ref(n_prefix, n_incr, n_items))
        assert np.array_equal(ref.rank_mask_ref(n_prefix, n_incr,
                                                n_items).numpy(), want)
        assert np.array_equal(rank_mask(n_prefix, n_incr, n_items)[0, 0]
                              .numpy(),
                              np.asarray(jmask(n_prefix, n_incr, n_items)[0, 0]))


@pytest.mark.parametrize("S", [256, 100])
def test_ops_model_layout(S):
    """Model layout (B, S, H, D) through views; a ragged S needs no
    fallback (the reference ops fell back to the oracle here)."""
    rng = np.random.default_rng(S)
    q, k, v = (_mk(rng, 2, S, 2, 64) for _ in range(3))
    got = ops.hstu_attention(_t(q), _t(k), _t(v))
    want = np.swapaxes(jref.hstu_attn_ref(
        *(np.swapaxes(t, 1, 2) for t in (q, k, v))), 1, 2)
    assert got.shape == (2, S, 2, 64)
    _close(got, want)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    """CPU tensors, and the dry-run's meta tensors (shapes only, nothing
    computed), take the plain version without counting a launch; the
    kernel launchers refuse any tensor that is not CUDA — there is no
    silent fallback."""
    before = (hstu_attn.launches, prefix_rank_attn.launches,
              paged_prefix_attn.launches, paged_prefix_attn.launches_segment)
    pool = torch.zeros(2, 4, 1, 32)
    rows = torch.zeros(1, 1, dtype=torch.int32)
    qpos = torch.arange(4, dtype=torch.int32)[None]
    for dev in ("cpu", "meta"):
        q = torch.zeros(1, 1, 4, 32, device=dev)
        p, r, qp = pool.to(dev), rows.to(dev), qpos.to(dev)
        outs = (hstu_attn.hstu_attn(q, q, q),
                prefix_rank_attn.prefix_rank_attn_split(q, q, q, q, q,
                                                        n_incr=2),
                paged_prefix_attn.segment_rank_attn(q, p, p, r, r, r, r, qp,
                                                    q, q, n_items=2))
        for o in outs:
            assert o.device.type == dev and tuple(o.shape) == (1, 1, 4, 32)
    assert (hstu_attn.launches, prefix_rank_attn.launches,
            paged_prefix_attn.launches,
            paged_prefix_attn.launches_segment) == before
    for dev in ("cpu", "meta"):
        q = torch.zeros(1, 1, 4, 32, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.rank_attn(q, q, q, n_incr=4, n_total=4.0)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.decode_attn(q[:, 0], q, q)
        x = torch.zeros(1, 1, 4, 1, 32, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.ssd_chunk("state", None, q, x, q, q)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises and leaves nothing in the build dir."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build()
    assert not (tmp_path / "kernels").exists()


def test_ctypes_params_mirror_the_cuda_struct():
    """The ctypes Structure must list the C struct's members in order
    (the library also checks sizeof at load time, on the card)."""
    src = Path(cuda_lib.SOURCES[0]).read_text()
    body = re.search(r"struct RankAttnParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"//.*", "", decl).strip()
        if not decl:
            continue
        names += [re.sub(r"\[.*\]", "", n.strip().lstrip("*")).split()[-1]
                  for n in decl.split(",")]
    assert names == [f[0] for f in cuda_lib.RankAttnParams._fields_]
    # the segment mode's tables, their row strides and its flag
    for name in ("page_pos", "pp_stride", "page_valid", "pv_stride",
                 "q_pos", "qp_stride", "segment"):
        assert name in names


# (n_prefix, Sq): the live rank (psi 2048, 16 incr + 64 items), the
# paper's 64 + 512, the causal prefill, one query, tile and warp edges
RANK_PLAN_CASES = [(2048, 80), (2048, 576), (0, 2048), (0, 933), (0, 1),
                   (0, 15), (0, 16), (0, 17), (100, 129), (130, 128),
                   (63, 80), (65, 64), (1 << 20, 80), (0, 1 << 16)]


@pytest.mark.parametrize("n_prefix,Sq", RANK_PLAN_CASES)
def test_rank_launch_plan_covers_every_tile_once(n_prefix, Sq):
    """The plan the rank kernel launches with, replayed as the kernel
    walks it: block r of a cluster takes key tiles r, r + cluster, ...
    of [prefix | new], so every tile goes to exactly one block, and the
    rows of the reduction to exactly one block too.  The cluster stays
    within the kernel's maximum; Sq <= 128 gives one q-tile and no warp
    wholly past Sq."""
    q_rows, cl = cuda_lib.rank_launch_plan(n_prefix, Sq)
    assert 16 <= q_rows <= cuda_lib.RANK_MAX_Q_ROWS and q_rows % 16 == 0
    assert 1 <= cl <= cuda_lib.RANK_MAX_CLUSTER
    if Sq <= cuda_lib.RANK_MAX_Q_ROWS:
        assert -(-Sq // q_rows) == 1 and q_rows - Sq < 16
    bk = cuda_lib.RANK_KEY_TILE
    n_tiles = -(-n_prefix // bk) + -(-Sq // bk)
    seen = np.zeros(n_tiles, np.int64)
    for r in range(cl):
        seen[r::cl] += 1
    assert (seen == 1).all()
    rows = np.zeros(q_rows, np.int64)
    per = -(-q_rows // cl)
    for r in range(cl):
        rows[r * per:min(q_rows, (r + 1) * per)] += 1
    assert (rows == 1).all()
    # the fewest blocks that keep each one's share of the tiles a q-tile
    # multiplies (a causal one of several sees about half the new tiles)
    # within RANK_TILES_PER_BLOCK, unless the plan's cap stops it
    assert cl <= cuda_lib.RANK_PLAN_CLUSTER <= cuda_lib.RANK_MAX_CLUSTER
    new = -(-Sq // bk)
    work = -(-n_prefix // bk) + (new if Sq <= cuda_lib.RANK_MAX_Q_ROWS
                                 else -(-new // 2))
    tpb = cuda_lib.RANK_TILES_PER_BLOCK
    assert cl == cuda_lib.RANK_PLAN_CLUSTER or -(-work // cl) <= tpb
    assert cl == 1 or -(-work // (cl - 1)) > tpb


def test_rank_launch_plan_reads_the_row_shape_only():
    """The plan takes (n_prefix, Sq) and nothing else -- not the batch,
    not the data -- so a row's bits cannot depend on its batch, and the
    dense and paged launches at equal padded length (n_prefix =
    n_pages * page_tokens) get the same plan; bad sizes raise."""
    import inspect
    assert list(inspect.signature(
        cuda_lib.rank_launch_plan).parameters) == ["n_prefix", "Sq"]
    for pt in (16, 32, 64):
        assert cuda_lib.rank_launch_plan((2048 // pt) * pt, 80) == \
            cuda_lib.rank_launch_plan(2048, 80)
    with pytest.raises(ValueError, match="Sq"):
        cuda_lib.rank_launch_plan(2048, 0)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_f32_accuracy_limit_fails_tf32(scale):
    """The card tests hold the rank kernel to 1e-5 of max |out| against
    float64.  That limit separates f32 from single-pass TF32: at B=1,
    H=4, S=1024, D=64 causal, inputs N(0, 1) times ``scale`` (x4 takes
    SiLU out of its linear range), the f32 plain twin passes it and the
    float64 version with q, k, v and P rounded to TF32 fails it, so a
    kernel that dropped the lo terms of 3xTF32 could not pass."""
    rng = np.random.default_rng(int(scale))
    q, k, v = (_t(scale * _mk(rng, 1, 4, 1024, 64)) for _ in range(3))
    mask = torch.ones(1024, 1024, dtype=torch.bool).tril()
    want = ref.silu_attn_f64(q, k, v, mask, n_total=1024)
    lim = 1e-5 * want.abs().max().item()
    f32 = hstu_attn.hstu_attn_plain(q, k, v).double()
    tf32 = ref.silu_attn_f64(q, k, v, mask, n_total=1024, tf32=True)
    assert (f32 - want).abs().max().item() < lim / 10
    assert (tf32 - want).abs().max().item() > 10 * lim
    # rounding is to nearest at 10 mantissa bits, ties away from zero
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -12], dtype=torch.float64)
    assert ref.round_tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                          1 + 2 ** -9, 1.0]


# --- the hybrid's kernels: decode_attn and the SSD chunk stages ------------------


def _jt(x, dtype):
    """numpy float32 -> (jax array, torch tensor) of ``dtype``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x.copy()).to(tdt)


@pytest.mark.parametrize("S,KV,H", [(1024, 2, 8), (2048, 4, 4),
                                    (4096, 1, 8), (512, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_matches_ref_and_pallas(S, KV, H, dtype):
    """The twin against the Pallas kernel in interpret mode and the JAX
    oracle, at ``tests/test_kernels.py``'s shapes.  The twin takes the
    cache in the model layout (B, S, KV, D), the reference (B, KV, S, D)."""
    rng = np.random.default_rng(S + KV + H)
    B, D = 2, 64
    q, k, v = _mk(rng, B, H, D), _mk(rng, B, KV, S, D), _mk(rng, B, KV, S, D)
    (jq, tq), (jk, tk), (jv, tv) = (_jt(a, dtype) for a in (q, k, v))
    got = decode_attn.decode_attn(tq, tk.transpose(1, 2), tv.transpose(1, 2))
    assert got.dtype == tq.dtype
    tol = TOL if dtype == "float32" else TOL_BF16
    want = pallas_decode_attn(jq, jk, jv, bk=256, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    oracle = jref.decode_attn_ref(*(np.asarray(a, np.float32)
                                    for a in (jq, jk, jv)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle), **tol)


def test_decode_attn_ref_keeps_float64():
    """Given float64, the oracle computes in float64 (the accuracy probe
    of ``chip_smoke.py``): within 1e-12 of a numpy float64 softmax, GQA
    head h on kv head h // 3; float32 in, float32 out."""
    rng = np.random.default_rng(9)
    q, k, v = _mk(rng, 2, 6, 32), _mk(rng, 2, 2, 50, 32), _mk(rng, 2, 2, 50, 32)
    t = [torch.from_numpy(a).double() for a in (q, k, v)]
    got = ref.decode_attn_ref(*t)
    assert got.dtype == torch.float64
    kk = np.repeat(k.astype(np.float64), 3, axis=1)
    vv = np.repeat(v.astype(np.float64), 3, axis=1)
    lg = np.einsum("bhd,bhsd->bhs", q.astype(np.float64), kk) / np.sqrt(32)
    w = np.exp(lg - lg.max(-1, keepdims=True))
    want = np.einsum("bhs,bhsd->bhd", w / w.sum(-1, keepdims=True), vv)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert ref.decode_attn_ref(*(a.float() for a in t)).dtype == torch.float32


@pytest.mark.parametrize("S", [8192, 100])
def test_cache_decode_attention_model_layout(S):
    """ops.cache_decode_attention on a ring in the model layout equals the
    reference wrapper (which transposes, and falls back to the oracle
    when a block does not divide S)."""
    from repro.kernels.ops import cache_decode_attention as jcache_decode
    rng = np.random.default_rng(S)
    q, k, v = _mk(rng, 2, 1, 4, 32), _mk(rng, 2, S, 2, 32), _mk(rng, 2, S, 2, 32)
    got = ops.cache_decode_attention(_t(q), _t(k), _t(v))
    assert got.shape == (2, 1, 4, 32)
    _close(got, jcache_decode(*map(jnp.asarray, (q, k, v))))


# (B, KV, S, n_sm, head_groups): the Zamba2 ring on an H100 and on a
# smaller card, rings shorter than a split, ragged and huge rings, rows
# enough that a (b, kv) gets one split, GQA head groups, tiny cards
PLAN_CASES = [(2, 32, 8192, 132, 1), (2, 32, 8192, 114, 1),
              (2, 32, 1, 132, 1), (2, 32, 63, 132, 1), (2, 32, 65, 132, 1),
              (2, 32, 8192 + 37, 132, 1), (16, 32, 1000, 132, 1),
              (25, 32, 1000, 132, 1), (2, 8, 8192, 132, 1),
              (2, 1, 777, 132, 8), (1, 1, 1 << 20, 132, 1),
              (2, 1, 100_000, 16, 1), (3, 2, 300, 8, 1), (1, 1, 129, 1, 1)]


@pytest.mark.parametrize("B,KV,S,n_sm,hg", PLAN_CASES)
def test_decode_split_plan_covers_every_key_once(B, KV, S, n_sm, hg):
    """The split plan the CUDA decode launches with: every key of every
    (b, kv) in exactly one split, no split empty, no more splits than a
    cluster (the partial buffer) holds, never more blocks than one wave
    of DECODE_BLOCKS_PER_SM per SM unless the rows alone exceed it, and
    enough blocks for the card unless the ring or the cluster caps them.
    It reads shapes and the SM count only, so it cannot depend on the
    data."""
    n, kps = cuda_lib.decode_split_plan(B, KV, S, n_sm, hg)
    assert 1 <= n <= cuda_lib.DECODE_MAX_SPLITS
    assert kps % cuda_lib.DECODE_KEY_ALIGN == 0
    seen = np.zeros(S, np.int64)
    for i in range(n):
        lo, hi = i * kps, min(S, (i + 1) * kps)
        assert hi > lo, f"split {i} of {n} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    rows = B * KV * hg
    cap = min(cuda_lib.DECODE_MAX_SPLITS, -(-S // cuda_lib.DECODE_KEY_ALIGN))
    target = cuda_lib.DECODE_BLOCKS_PER_SM * n_sm
    assert 2 * rows * n >= min(target, rows * cap)
    assert rows * n <= max(rows, target)
    assert cuda_lib.decode_split_plan(B, KV, S, n_sm, hg) == (n, kps)


def test_decode_split_plan_sizes_to_the_card():
    """At the Zamba2 decode shape a (b, kv) gets a handful of splits (not
    64 splits of 128 keys), more on a larger card, one when the rows
    alone fill the card; bad sizes raise.  Every G is covered by
    ceil(G / heads_per_block) head groups of 1, 2 or 4 heads."""
    n, kps = cuda_lib.decode_split_plan(2, 32, 8192, 132)
    assert 2 <= n <= 16 and n * kps >= 8192
    assert cuda_lib.decode_split_plan(2, 32, 8192, 264)[0] > n
    assert cuda_lib.decode_split_plan(64, 32, 8192, 132)[0] == 1
    with pytest.raises(ValueError, match="positive"):
        cuda_lib.decode_split_plan(2, 32, 0, 132)
    for G in range(1, 65):
        gh = cuda_lib.decode_heads_per_block(G)
        assert gh in (1, 2, 4) and gh <= max(G, 4)
        assert -(-G // gh) * gh - G < gh


def _ssd_case(rng, B, nc, Q, H, P, N):
    """``tests/test_kernels.py``'s SSD inputs: normal C, B, x; cum a
    negative cumulative sum; dt positive."""
    Cc, Bc = _mk(rng, B, nc, Q, N), _mk(rng, B, nc, Q, N)
    xc = _mk(rng, B, nc, Q, H, P)
    cum = (-np.abs(rng.normal(size=(B, nc, Q, H)))).cumsum(2).astype(np.float32)
    dtc = np.abs(rng.normal(size=(B, nc, Q, H))).astype(np.float32)
    return Cc, Bc, xc, cum, dtc


@pytest.mark.parametrize("H,P,N", [(4, 64, 64), (2, 128, 32), (8, 64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_intra_matches_ref_and_pallas(H, P, N, dtype):
    rng = np.random.default_rng(H * P + N)
    Cc, Bc, xc, cum, dtc = _ssd_case(rng, 2, 2, 128, H, P, N)
    (jC, tC), (jB, tB), (jx, tx) = (_jt(a, dtype) for a in (Cc, Bc, xc))
    got = ssd_chunk.ssd_chunk_intra(tC, tB, tx, _t(cum), _t(dtc))
    assert got.dtype == tx.dtype
    want = pallas_ssd_intra(jC, jB, jx, jnp.asarray(cum), jnp.asarray(dtc),
                            interpret=True)
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("H,P,N", [(4, 64, 64), (2, 128, 32)])
def test_ssd_chunk_state_matches_ref_and_pallas(H, P, N):
    from repro.kernels.ssd_chunk import ssd_chunk_state_ref as jstate_ref
    rng = np.random.default_rng(H * P + N + 1)
    _, Bc, xc, cum, dtc = _ssd_case(rng, 2, 2, 128, H, P, N)
    got = ssd_chunk.ssd_chunk_state(_t(Bc), _t(xc), _t(cum), _t(dtc))
    assert got.shape == (2, 2, H, N, P) and got.dtype == torch.float32
    _close(got, pallas_ssd_state(*map(jnp.asarray, (Bc, xc, cum, dtc)),
                                 interpret=True))
    _close(got, jstate_ref(Bc, xc, cum, dtc))


@pytest.mark.parametrize("H,P,N", [(4, 64, 64), (2, 128, 32)])
def test_ssd_chunk_state_bf16_matches_ref_and_pallas(H, P, N):
    """The state twin on bf16 B and x (float32 cum and dt), as the
    Pallas kernel takes them: float32 out, equal to the twin on the
    widened inputs bit for bit, and against the Pallas kernel in
    interpret mode and the JAX oracle on the same bf16 inputs at the
    float32 tolerance (all three widen on load and sum in float32)."""
    from repro.kernels.ssd_chunk import ssd_chunk_state_ref as jstate_ref
    rng = np.random.default_rng(H * P + N + 2)
    _, Bc, xc, cum, dtc = _ssd_case(rng, 2, 2, 128, H, P, N)
    (jB, tB), (jx, tx) = (_jt(a, "bfloat16") for a in (Bc, xc))
    got = ssd_chunk.ssd_chunk_state(tB, tx, _t(cum), _t(dtc))
    assert got.shape == (2, 2, H, N, P) and got.dtype == torch.float32
    assert torch.equal(got, ssd_chunk.ssd_chunk_state(
        tB.float(), tx.float(), _t(cum), _t(dtc)))
    _close(got, pallas_ssd_state(jB, jx, jnp.asarray(cum), jnp.asarray(dtc),
                                 interpret=True))
    _close(got, jstate_ref(jB, jx, jnp.asarray(cum), jnp.asarray(dtc)))


@pytest.mark.parametrize("H,P,N", [(4, 64, 64), (2, 128, 32)])
def test_ssd_chunk_intra_bf16_out_dtype(H, P, N):
    """On bf16 inputs the intra twin returns bf16 by default, as the
    Pallas kernel writes ``xc.dtype``, and float32 when asked (the
    model's route): that float32 result is the twin on widened inputs,
    bit for bit, and its bf16 rounding is the default result."""
    rng = np.random.default_rng(H * P + N + 3)
    Cc, Bc, xc, cum, dtc = _ssd_case(rng, 2, 2, 128, H, P, N)
    tC, tB, tx = (_jt(a, "bfloat16")[1] for a in (Cc, Bc, xc))
    wide = ssd_chunk.ssd_chunk_intra(tC, tB, tx, _t(cum), _t(dtc),
                                     out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    assert torch.equal(wide, ssd_chunk.ssd_chunk_intra(
        tC.float(), tB.float(), tx.float(), _t(cum), _t(dtc)))
    got = ssd_chunk.ssd_chunk_intra(tC, tB, tx, _t(cum), _t(dtc))
    assert got.dtype == torch.bfloat16 and torch.equal(got, wide.bfloat16())


@pytest.mark.parametrize("H", [1, 2, 7, 8, 9, 13, 16, 17, 20, 33, 64, 65,
                               128])
def test_ssd_intra_heads_per_block_takes_fewest_smallest_blocks(H):
    """The intra kernel's plan: as few blocks as blocks of at most
    SSD_INTRA_HEADS_PER_BLOCK heads allow, each as small as that count
    allows, every head in exactly one block."""
    cap = cuda_lib.SSD_INTRA_HEADS_PER_BLOCK
    hg = cuda_lib.ssd_intra_heads_per_block(H)
    groups = -(-H // hg)
    assert 1 <= hg <= min(H, cap)
    assert groups == -(-H // cap)
    assert hg == 1 or -(-H // (hg - 1)) > groups
    heads = [h for gi in range(groups) for h in range(gi * hg, min(H, (gi + 1) * hg))]
    assert heads == list(range(H))


def test_ssd_intra_plan_reads_the_head_count_only():
    """The plan never sees the batch or the data (a row of a batched call
    equals the B = 1 call bit for bit on the card); the Zamba2 layers'
    64 heads run as 4 blocks of 16; nonsense raises."""
    import inspect
    assert list(inspect.signature(
        cuda_lib.ssd_intra_heads_per_block).parameters) == ["H"]
    assert cuda_lib.ssd_intra_heads_per_block(64) == 16
    with pytest.raises(ValueError, match="H >= 1"):
        cuda_lib.ssd_intra_heads_per_block(0)


@pytest.mark.parametrize("rate", [0.5, 20.0])
def test_ssd_intra_f64_limit_fails_tf32(rate):
    """The card tests hold the intra kernel to 1e-5 of max |out| against
    float64.  That limit separates f32 from single-pass TF32: the f32
    plain twin passes it and the float64 version with C, B, x and M
    rounded to TF32 fails it, at gentle and steep decay (rate 20: the
    masked exp(cum[q] - cum[t]) overflows, and the oracle stays finite)."""
    rng = np.random.default_rng(int(rate))
    Cc, Bc, xc, cum, dtc = _ssd_case(rng, 2, 2, 128, 3, 32, 16)
    dtc = np.log1p(np.exp(rng.normal(size=dtc.shape))).astype(np.float32)
    cum = np.cumsum(-rate * dtc, axis=2).astype(np.float32)
    args = [_t(a) for a in (Cc, Bc, xc, cum, dtc)]
    want = ref.ssd_chunk_intra_f64(*args)
    assert torch.isfinite(want).all()
    lim = 1e-5 * want.abs().max().item()
    f32 = ssd_chunk.ssd_chunk_intra_ref(*args).double()
    tf32 = ref.ssd_chunk_intra_f64(*args, tf32=True)
    assert (f32 - want).abs().max().item() < lim / 10
    assert (tf32 - want).abs().max().item() > 10 * lim


def test_hybrid_wrappers_count_no_cpu_launch_and_other_devices_raise():
    """CPU tensors, and the dry-run's meta tensors, take the plain twins
    without counting a launch; the launchers refuse a tensor that is not
    CUDA — there is no silent fallback."""
    before = (decode_attn.launches, ssd_chunk.launches_intra,
              ssd_chunk.launches_state)
    for dev in ("cpu", "meta"):
        q, kv = torch.zeros(1, 4, 32, device=dev), \
            torch.zeros(1, 8, 2, 32, device=dev)
        c, x, h = torch.zeros(1, 1, 8, 16, device=dev), \
            torch.zeros(1, 1, 8, 2, 32, device=dev), \
            torch.zeros(1, 1, 8, 2, device=dev)
        outs = (decode_attn.decode_attn(q, kv, kv),
                ssd_chunk.ssd_chunk_intra(c, c, x, h, h),
                ssd_chunk.ssd_chunk_state(c, x, h, h))
        assert [tuple(o.shape) for o in outs] == [
            (1, 4, 32), (1, 1, 8, 2, 32), (1, 1, 2, 16, 32)]
        assert all(o.device.type == dev for o in outs)
    assert (decode_attn.launches, ssd_chunk.launches_intra,
            ssd_chunk.launches_state) == before
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.decode_attn(m(q), m(kv), m(kv))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.ssd_chunk("intra", m(c), m(c), m(x), m(h), m(h))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.ssd_chunk("state", None, m(c), m(x), m(h), m(h))


def _struct_members(src: str, struct: str):
    body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//.*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", n.strip().lstrip("*")).split()[-1]
                      for n in decl.split(",")]
    return names


@pytest.mark.parametrize("source,struct", [("ssd_chunk.cu", "SsdParams"),
                                           ("decode_attn.cu", "DecodeParams")])
def test_ctypes_params_mirror_the_new_cuda_structs(source, struct):
    """Each ctypes Structure lists its C struct's members in order (the
    library also checks sizeof at load time, on the card)."""
    src = (cuda_lib.CSRC / source).read_text()
    assert _struct_members(src, struct) == \
        [f[0] for f in getattr(cuda_lib, struct)._fields_]
