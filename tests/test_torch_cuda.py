"""The CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card (marker ``cuda``; every test skips without one):

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch only, so it also runs where JAX is absent.  It
sweeps the edges that ``chip_smoke.py`` does not: ragged lengths around
the 64-token tiles, every compiled head dim, short and empty prefixes,
pages smaller than the key tile, and the refusals of the wrapper; for
the segment mode, spans interleaved with fresh tokens at 16-, 32- and
64-token pages, partly held pages and null-padded slots; the rank
kernel's query tiling (Sq around 16-row warps, one block up to 128
queries, several q-tiles) in all four modes, repeat calls bit for bit,
and float32 accuracy against float64 (1e-5 of the largest |out|, a limit
single-pass TF32 fails); for
the hybrid's kernels, decode rings around the key tile, the ring and
the split, GQA with 1 to 32 kv heads, strided cache views, a batch that
gives each (b, kv) one split, repeat calls bit for bit, chunks shorter
than 128, state head groups around 32 heads and steep decays; for
``ssd_chunk_intra``, chunks of 1 to 128 at P 32 / 64 / 128 and N 16 to
128 with head groups that do not divide H, float64 accuracy (the limit
single-pass TF32 fails), repeat calls and rows of a batch bit for bit;
for training, ``HSTUAttnFunction``'s gradients against float64 autograd
(1e-5 of each gradient's largest |g|), a train step's ``hstu_attn``
launches (two a layer under remat) and its weights against the CPU's, a
refused launch failing the step, and HSTU ``decode_step`` replayed from
a graph equal to the eager step; the SSD Functions' gradients against
float64 autograd at the kernels' tiling edges (Q 1..128, P 32 / 64 /
128, N 16..128; 1e-5 of each input's largest |g|), their backward bit
for bit on a repeat, and one hybrid train step with every gradient
present and finite and two launches of each SSD kernel a Mamba2 layer; for the Transformer family,
``decode_attn`` at its GQA groups (G 1 to 12) and D 128 from one key to
32768, the ``head_pad`` launch on the real heads, and a full-width
decode step (dense, MoE, and the int8 cache) replayed from a graph
equal to the eager step; for the SSM stacks (RWKV6, Mamba2) and the
enc-dec, a full-width decode step replayed from a graph equal to the
eager step, and the cross-attention decode launching ``decode_attn``.
For bf16 inputs (rows 1-4, 6-7): each launch equal bit for bit to the
float32 launch on the widened inputs (bf16 outputs rounded), in all
four rank modes at Sq 1..576 x D 32 / 64 / 128 and at every SSD case of
the float32 sweep; against float64 within the output's rounding
(2**-8 of |out|) plus 1e-5 of the largest |out|; the rank kernels
against their bf16 twins within 2**-6 of the largest |out|; the SSD
Functions' outputs and gradients equal the float32-copy route bit for
bit; a bf16 smoke ``hstu-gr`` against the CPU (2**-4 of the largest
|score|) and served with graphs; the zamba2 smoke prefill and train step
equal the float32-copy route bit for bit.
Tolerance: 3e-4 absolute + 3e-4 relative, the repo's f32 kernel
tolerance.  The bfloat16 decode is held to 2**-6 of the largest
|plain| output, about two bf16 ulps of it: the plain twin also computes
in float32 and rounds once, and at S = 8192 the outputs are ~0.02, so
the 6e-2 of ``tests/test_kernels.py`` would pass a kernel writing zeros.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn as dk
from repro_torch.kernels import hstu_attn as hk
from repro_torch.kernels import paged_prefix_attn as pk
from repro_torch.kernels import prefix_rank_attn as rk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=g, device=dev)


def _close(got, want):
    torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_hstu_attn_kernel(dev, S, D):
    q, k, v = (_randn(dev, 2, 3, S, D, seed=i) for i in range(3))
    before = hk.launches
    got = hk.hstu_attn(q, k, v)
    assert hk.launches == before + 1
    _close(got, hk.hstu_attn_plain(q, k, v))


@pytest.mark.parametrize("n_prefix,n_incr,n_items", [
    (0, 16, 64), (1, 5, 7), (100, 16, 64), (128, 0, 70), (130, 64, 512),
    (2048, 1, 0)])
def test_prefix_rank_kernel(dev, n_prefix, n_incr, n_items):
    Sq = n_incr + n_items
    q = _randn(dev, 2, 4, Sq, 64, seed=1)
    k = _randn(dev, 2, 4, n_prefix + Sq, 64, seed=2)
    v = _randn(dev, 2, 4, n_prefix + Sq, 64, seed=3)
    got = rk.prefix_rank_attn(q, k, v, n_prefix=n_prefix, n_incr=n_incr)
    _close(got, rk.prefix_rank_attn_plain(q, k, v, n_prefix=n_prefix,
                                          n_incr=n_incr))


def _paged(dev, lens, pt, n_pages, Sq, H=4, D=64):
    B = len(lens)
    n_pool = 2 * B * n_pages
    pool = _randn(dev, n_pool + 1, pt, H, D, seed=4)
    pool[n_pool] = 0
    ids = torch.randperm(n_pool, device=dev).int()
    kt = torch.full((B, n_pages), n_pool, dtype=torch.int32, device=dev)
    vt = kt.clone()
    for b, ln in enumerate(lens):
        used = -(-ln // pt)
        kt[b, :used] = ids[2 * b * n_pages:2 * b * n_pages + used]
        vt[b, :used] = ids[(2 * b + 1) * n_pages:(2 * b + 1) * n_pages + used]
    plens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q, kn, vn = (_randn(dev, B, H, Sq, D, seed=5 + i) for i in range(3))
    return q, kn, vn, pool, kt, vt, plens


@pytest.mark.parametrize("pt", [16, 32, 64])
def test_paged_kernel_and_bitwise_properties(dev, pt):
    lens, n_incr, Sq = [256, 200, 1, 65], 16, 80
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, pt, 256 // pt, Sq)
    got = pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens, kn, vn,
                                    n_incr=n_incr)
    _close(got, pk.paged_prefix_rank_attn_plain(
        q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr))
    # paged == dense at the same padded length, bit for bit: the kernel's
    # 64-key tiles cover whole pages in the dense order
    kp, vp = ref.gather_pages(pool, kt, plens), ref.gather_pages(pool, vt, plens)
    dense = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n_incr)
    assert torch.equal(got, dense)
    # a row's result does not depend on the batch it rides in
    for b in range(len(lens)):
        s = slice(b, b + 1)
        one = pk.paged_prefix_rank_attn(q[s], pool, pool, kt[s], vt[s],
                                        plens[s], kn[s], vn[s], n_incr=n_incr)
        assert torch.equal(one[0], got[b])


# --- the 3xTF32 tensor-core tiling: query tiles sized to Sq, 16 rows a warp ------


@pytest.mark.parametrize("Sq", [1, 15, 16, 17, 80, 90, 129, 576])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_rank_kernel_tiling_edges_all_modes(dev, Sq, D):
    """Sq around the 16-row warp and the one-block rank (<= 128 queries;
    80 and 90 put five and six warps in a block), and several q-tiles
    (129, 576); a prefix that is no multiple of the
    64-key tile; every compiled head dim.  For the causal prefill and the
    dense, paged (32-token pages, ragged rows) and segment (one span)
    ranks: the plain twin within the f32 tolerance, two calls bit for bit,
    paged == dense at equal padded length and segment == paged."""
    B, H, n_incr, pt = 2, 2, Sq // 5, 32
    q, kn, vn = (_randn(dev, B, H, Sq, D, seed=20 + i) for i in range(3))
    got = hk.hstu_attn(q, kn, vn)
    _close(got, hk.hstu_attn_plain(q, kn, vn))
    assert torch.equal(hk.hstu_attn(q, kn, vn), got)

    kp, vp = (_randn(dev, B, H, 100, D, seed=30 + i) for i in range(2))
    dense = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n_incr)
    _close(dense, rk.prefix_rank_attn_plain(
        q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2), n_prefix=100,
        n_incr=n_incr))
    assert torch.equal(rk.prefix_rank_attn_split(q, kp, vp, kn, vn,
                                                 n_incr=n_incr), dense)

    lens, n_pages = [100, 37], 4
    _, _, _, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq, H, D)
    paged = pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens, kn, vn,
                                      n_incr=n_incr)
    _close(paged, pk.paged_prefix_rank_attn_plain(
        q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr))
    assert torch.equal(pk.paged_prefix_rank_attn(
        q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr), paged)
    kg, vg = ref.gather_pages(pool, kt, plens), ref.gather_pages(pool, vt, plens)
    assert torch.equal(rk.prefix_rank_attn_split(q, kg, vg, kn, vn,
                                                 n_incr=n_incr), paged)

    ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * pt
            ).expand(B, n_pages).contiguous()
    pval = (plens[:, None] - ppos).clamp(0, pt).int()
    qpos = (n_pages * pt + torch.arange(Sq, dtype=torch.int32, device=dev)
            ).expand(B, Sq)
    seg = pk.segment_rank_attn(q, pool, pool, kt, vt, ppos, pval, qpos, kn,
                               vn, n_items=Sq - n_incr)
    assert torch.equal(seg, paged)
    assert torch.equal(pk.segment_rank_attn(q, pool, pool, kt, vt, ppos, pval,
                                            qpos, kn, vn, n_items=Sq - n_incr),
                       seg)


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("kind", ["hstu", "rank"])
def test_rank_kernel_keeps_f32_accuracy(dev, kind, scale):
    """Against a float64 version within 1e-5 of the largest |out|, at
    inputs N(0, 1) x scale (x4 takes SiLU out of its linear range).  The
    same float64 version with q, k, v and P rounded to TF32 misses that
    limit, so a kernel that dropped the lo terms of 3xTF32 would fail.
    The 3e-4 + 3e-4|plain| limit above cannot tell f32 from TF32."""
    g = torch.Generator(device=dev).manual_seed(int(scale) + len(kind))
    randn = lambda *shape: scale * torch.randn(shape, generator=g, device=dev)
    if kind == "hstu":
        S = 1024
        q, k, v = (randn(1, 4, S, 64) for _ in range(3))
        got = hk.hstu_attn(q, k, v)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        qkv, n = (q, k, v), S
    else:
        P, n_incr, Sq = 2048, 16, 80
        q, kn, vn = (randn(2, 4, Sq, 64) for _ in range(3))
        kp, vp = (randn(2, 4, P, 64) for _ in range(2))
        got = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n_incr)
        mask = ref.rank_mask_ref(P, n_incr, Sq - n_incr, device=dev)
        qkv, n = (q, torch.cat([kp, kn], 2), torch.cat([vp, vn], 2)), P + Sq
    want = ref.silu_attn_f64(*qkv, mask, n_total=n)
    lim = 1e-5 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= lim
    tf32 = ref.silu_attn_f64(*qkv, mask, n_total=n, tf32=True)
    assert (tf32 - want).abs().max().item() > lim


# --- bfloat16 inputs: widened on load, the float32 kernel's arithmetic ----------

BF16_OUT = 2 ** -8     # a bf16 output's rounding, of its |value|
# kernel vs the bf16 plain twin, of the twin's largest |out|: the twin
# rounds its logits and scores to bf16 where the kernel keeps float32
# (~0.004-0.006 at the path shapes on the CPU, the twin against the
# float32 twin on widened inputs rounded to bf16); an all-zero output
# errs by 1
TWIN_BF16 = 2 ** -6


def _f64_close_bf16(got, want):
    """(b) for a bf16 output: within its rounding (2**-8 of |want|) plus
    the float32 kernels' 1e-5 of the largest |want| of float64."""
    top = want.abs().max().item()
    err = (got.double() - want).abs()
    lim = BF16_OUT * want.abs() + (1 + BF16_OUT) * 1e-5 * top
    assert bool((err <= lim).all()), (err - lim).max().item()


def _rank_modes(dev, Sq, D, n_incr, pt=32, B=2, H=2):
    """Inputs of the four rank modes at (Sq, D), and a call for each that
    takes them: (inputs, {mode: f(q, kn, vn, kp, vp, pool)}, tables)."""
    q, kn, vn = (_randn(dev, B, H, Sq, D, seed=20 + i) for i in range(3))
    kp, vp = (_randn(dev, B, H, 100, D, seed=30 + i) for i in range(2))
    lens, n_pages = [100, 37], 4
    _, _, _, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq, H, D)
    ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * pt
            ).expand(B, n_pages).contiguous()
    pval = (plens[:, None] - ppos).clamp(0, pt).int()
    qpos = (n_pages * pt + torch.arange(Sq, dtype=torch.int32, device=dev)
            ).expand(B, Sq)
    calls = {
        "hstu": lambda q, kn, vn, kp, vp, pool: hk.hstu_attn(q, kn, vn),
        "dense": lambda q, kn, vn, kp, vp, pool: rk.prefix_rank_attn_split(
            q, kp, vp, kn, vn, n_incr=n_incr),
        "paged": lambda q, kn, vn, kp, vp, pool: pk.paged_prefix_rank_attn(
            q, pool, pool, kt, vt, plens, kn, vn, n_incr=n_incr),
        "segment": lambda q, kn, vn, kp, vp, pool: pk.segment_rank_attn(
            q, pool, pool, kt, vt, ppos, pval, qpos, kn, vn,
            n_items=Sq - n_incr)}
    return (q, kn, vn, kp, vp, pool), calls, (kt, vt, plens)


@pytest.mark.parametrize("Sq", [1, 15, 16, 17, 80, 90, 129, 576])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_rank_kernel_bf16_tiling_edges_all_modes(dev, Sq, D):
    """The bf16 load path at the tiling edges of the float32 test above,
    in all four modes: (a) each bf16 launch equals the float32 launch on
    the widened inputs, rounded to bf16, bit for bit; two calls bit for
    bit; paged == dense at equal padded length and segment (one span) ==
    paged, in bf16."""
    n_incr = Sq // 5
    ins, calls, (kt, vt, plens) = _rank_modes(dev, Sq, D, n_incr)
    bf = tuple(t.bfloat16() for t in ins)
    wide = tuple(t.float() for t in bf)
    out = {}
    for mode, f in calls.items():
        before = (hk.launches, rk.launches, pk.launches, pk.launches_segment)
        got = f(*bf)
        assert sum(after - b for after, b in zip(
            (hk.launches, rk.launches, pk.launches, pk.launches_segment),
            before)) == 1, mode
        assert got.dtype == torch.bfloat16 and got.shape == bf[0].shape, mode
        assert torch.equal(got, f(*wide).bfloat16()), mode
        assert torch.equal(f(*bf), got), mode
        out[mode] = got
    q, kn, vn, _, _, pool = bf
    kg, vg = ref.gather_pages(pool, kt, plens), ref.gather_pages(pool, vt, plens)
    assert torch.equal(rk.prefix_rank_attn_split(q, kg, vg, kn, vn,
                                                 n_incr=n_incr), out["paged"])
    assert torch.equal(out["segment"], out["paged"])


@pytest.mark.parametrize("kind", ["hstu", "rank"])
def test_rank_kernel_bf16_against_float64_and_twin(dev, kind):
    """(b) at the path shapes: against float64 on the widened inputs, the
    float32 launch on them (the bf16 launch before its rounding) within
    1e-5 of the largest |out| and the bf16 launch within its rounding
    plus that; and against the bf16 plain twin (which rounds its logits and
    scores to bf16, as the reference's oracle does) within TWIN_BF16 of
    the twin's largest |out|."""
    g = torch.Generator(device=dev).manual_seed(len(kind))
    randn = lambda *shape: torch.randn(shape, generator=g,
                                       device=dev).bfloat16()
    if kind == "hstu":
        S = 1024
        q, k, v = (randn(1, 4, S, 64) for _ in range(3))
        got = hk.hstu_attn(q, k, v)
        plain = hk.hstu_attn_plain(q, k, v)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        qkv, n = (q, k, v), S
    else:
        P, n_incr, Sq = 2048, 16, 80
        q, kn, vn = (randn(2, 4, Sq, 64) for _ in range(3))
        kp, vp = (randn(2, 4, P, 64) for _ in range(2))
        got = rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n_incr)
        kk, vv = torch.cat([kp, kn], 2), torch.cat([vp, vn], 2)
        plain = rk.prefix_rank_attn_plain(q, kk, vv, n_prefix=P,
                                          n_incr=n_incr)
        mask = ref.rank_mask_ref(P, n_incr, Sq - n_incr, device=dev)
        qkv, n = (q, kk, vv), P + Sq
    want = ref.silu_attn_f64(*qkv, mask, n_total=n)
    _f64_close_bf16(got, want)
    # the float32 launch on the widened inputs (got before its rounding)
    # within the float32 kernels' 1e-5 of the largest |out|
    wide = tuple(t.float() for t in qkv)
    if kind == "hstu":
        f32 = hk.hstu_attn(*wide)
    else:
        f32 = rk.prefix_rank_attn_split(
            wide[0], *(t[:, :, :P] for t in wide[1:]),
            *(t[:, :, P:] for t in wide[1:]), n_incr=n_incr)
    assert torch.equal(f32.bfloat16(), got)
    lim = 1e-5 * want.abs().max().item()
    assert (f32.double() - want).abs().max().item() <= lim
    top = plain.float().abs().max().item()
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= TWIN_BF16 * top, (err / top)


# --- the segment mode: cached spans interleaved with fresh tokens -----------------

SEG_ROWS = [   # ('c', n) a cached span, ('f', n) fresh tokens; 80 fresh per row
    [("c", 200), ("f", 8), ("c", 37), ("f", 8), ("c", 70), ("f", 64)],
    [("c", 64), ("f", 16), ("f", 64)],
    [("f", 4), ("c", 100), ("f", 12), ("c", 1), ("f", 64)],
    [("c", 129), ("f", 8), ("c", 3), ("f", 8), ("c", 65), ("f", 64)],
]


def _segments(dev, pt, rows=SEG_ROWS, H=4, D=64):
    """Span tables over a pool of random pages whose K and V pages are
    distinct and shuffled; the tail of a partly held page is random too
    (the kernel must not read it), the null page last and zero, and the
    table one slot wider than the longest row (null-padded slots)."""
    from repro_torch.kernels.paged_prefix_attn import pack_segments
    B, Sq = len(rows), sum(n for kind, n in rows[0] if kind == "f")
    spans, q_pos = [], []
    for row in rows:
        pos, sp, fp = 0, [], []
        for kind, n in row:
            (sp.append((pos, n)) if kind == "c"
             else fp.extend(range(pos, pos + n)))
            pos += n
        spans.append(sp)
        q_pos.append(fp)
    C = max(sum(n for _, n in sp) for sp in spans)
    rng = np.random.default_rng(pt)
    kc, vc = (rng.normal(size=(B, H, C, D)).astype(np.float32) for _ in "kv")
    n_pages = max(sum(-(-n // pt) for _, n in sp) for sp in spans) + 1
    kp, vp, table, ppos, pval = pack_segments(kc, vc, spans, pt, n_pages)
    n = kp.shape[0] - 1
    for pages in (kp, vp):
        for pid in range(n):           # noise where a page holds nothing
            held = pval[table == pid].max()
            pages[pid, held:] = rng.normal(size=pages[pid, held:].shape)
    perm = rng.permutation(2 * n)
    pool = np.zeros((2 * n + 1, pt, H, D), np.float32)
    pool[perm[:n]], pool[perm[n:]] = kp[:n], vp[:n]
    kt = np.where(table == n, 2 * n, perm[np.minimum(table, n - 1)])
    vt = np.where(table == n, 2 * n, perm[n + np.minimum(table, n - 1)])
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    q, kn, vn = (_randn(dev, B, H, Sq, D, seed=9 + i) for i in range(3))
    return (q, kn, vn, on(pool), on(kt.astype(np.int32)),
            on(vt.astype(np.int32)), on(ppos), on(pval),
            on(np.asarray(q_pos, np.int32)))


@pytest.mark.parametrize("pt", [16, 32, 64])
def test_segment_kernel_and_batch_independence(dev, pt):
    """Ragged rows, interleaved spans, partly held pages and null-padded
    slots against the plain twin; a row's bits ignore its batch."""
    q, kn, vn, pool, kt, vt, ppos, pval, qpos = _segments(dev, pt)
    before = pk.launches_segment
    got = pk.segment_rank_attn(q, pool, pool, kt, vt, ppos, pval, qpos, kn,
                               vn, n_items=64)
    assert pk.launches_segment == before + 1
    _close(got, pk.segment_rank_attn_plain(q, pool, pool, kt, vt, ppos, pval,
                                           qpos, kn, vn, n_items=64))
    for b in range(q.shape[0]):
        s = slice(b, b + 1)
        one = pk.segment_rank_attn(q[s], pool, pool, kt[s], vt[s], ppos[s],
                                   pval[s], qpos[s], kn[s], vn[s], n_items=64)
        assert torch.equal(one[0], got[b])


@pytest.mark.parametrize("pt", [16, 32, 64])
def test_segment_kernel_degenerates_to_paged_bitwise(dev, pt):
    """One span at [0, prefix_len) with the fresh tokens after it is the
    paged launch, bit for bit (same tiles, values and split)."""
    lens, n_incr, Sq = [256, 200, 1, 65], 16, 80
    n_pages = 256 // pt
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq)
    ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * pt
            ).expand(len(lens), n_pages).contiguous()
    pval = (plens[:, None] - ppos).clamp(0, pt).int()
    qpos = (n_pages * pt + torch.arange(Sq, dtype=torch.int32, device=dev)
            ).expand(len(lens), Sq)
    paged = pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens, kn, vn,
                                      n_incr=n_incr)
    seg = pk.segment_rank_attn(q, pool, pool, kt, vt, ppos, pval, qpos, kn,
                               vn, n_items=Sq - n_incr)
    assert torch.equal(seg, paged)


def test_segment_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, kn, vn, pool, kt, vt, ppos, pval, qpos = _segments(dev, 64)
    call = lambda **kw: pk.segment_rank_attn(**{**dict(
        q=q, k_pages=pool, v_pages=pool, k_table=kt, v_table=vt,
        page_pos=ppos, page_valid=pval, q_pos=qpos, k_new=kn, v_new=vn,
        n_items=64), **kw})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(q=q.half(), k_new=kn.half(), v_new=vn.half())
    with pytest.raises(TypeError, match="k_pool"):
        call(q=q.bfloat16(), k_new=kn.bfloat16(), v_new=vn.bfloat16())
    with pytest.raises(ValueError, match="k_pool"):
        call(k_pages=pool.cpu(), v_pages=pool.cpu())
    with pytest.raises(ValueError, match="page_pos"):
        call(page_pos=ppos[:, :-1])
    with pytest.raises(ValueError, match="page_valid"):
        call(page_valid=pval.long())
    with pytest.raises(ValueError, match="q_pos"):
        call(q_pos=qpos[:, 1:])
    with pytest.raises(ValueError, match="v_table"):
        call(v_table=vt[:, :-1])


# --- the TMA loader of the paged and segment launches ------------------------------

NAN_LENS = [256, 200, 1, 65, 130, 64, 255, 17]    # ragged psi rows (B 8)


def _held_pool(pool, tables, held_tokens):
    """(N + 1, page_tokens) bool: the pool keys that some launch row holds,
    ``held_tokens[b, s]`` the keys of slot s of row b (a prefix: the page's
    first ones); a page named by several tables counts every naming."""
    n1, pt = pool.shape[:2]
    held = torch.zeros(n1, pt, dtype=torch.bool, device=pool.device)
    j = torch.arange(pt, device=pool.device)
    for table in tables:
        rows = (j[None, None, :] < held_tokens[:, :, None])      # (B, np, pt)
        for page, mask in zip(table.reshape(-1).tolist(),
                              rows.reshape(-1, pt)):
            held[page] |= mask
    return held


def _poisoned(pool, held):
    """The pool with every key no launch holds set to NaN, and the same
    pool with those keys 0."""
    keep = held[:, :, None, None]
    return (torch.where(keep, pool, torch.nan),
            torch.where(keep, pool, torch.zeros((), dtype=pool.dtype,
                                                device=pool.device)))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("pt", [2, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_and_segment_ignore_what_the_pool_does_not_hold(dev, dtype, pt,
                                                                B):
    """TMA copies whole pages, so the keys a launch does not hold reach
    shared memory: the tail of a row's last page past prefix_lens, a
    segment page's keys past page_valid, and pages no table names.  With
    all of them NaN, the paged and segment outputs are finite and equal
    the clean pool's bit for bit (the loader zeroes those rows)."""
    lens = NAN_LENS[:B] if B > 1 else [200]
    n_pages, Sq, n_incr = 256 // pt, 80, 16
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq)
    q, kn, vn, pool = (t.to(dtype) for t in (q, kn, vn, pool))
    slot = torch.arange(n_pages, device=dev) * pt
    held_tokens = (plens[:, None] - slot).clamp(0, pt)
    bad, clean = _poisoned(pool, _held_pool(pool, (kt, vt), held_tokens))
    paged = lambda p: pk.paged_prefix_rank_attn(q, p, p, kt, vt, plens, kn,
                                                vn, n_incr=n_incr)
    got, want = paged(bad), paged(clean)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # segments: spans with partly held pages, keys past page_valid NaN
    sq, skn, svn, spool, skt, svt, ppos, pval, qpos = _segments(dev, pt)
    if B == 1:
        sq, skn, svn, skt, svt, ppos, pval, qpos = (
            t[:1] for t in (sq, skn, svn, skt, svt, ppos, pval, qpos))
    sq, skn, svn, spool = (t.to(dtype) for t in (sq, skn, svn, spool))
    sbad, sclean = _poisoned(spool, _held_pool(spool, (skt, svt), pval))
    seg = lambda p: pk.segment_rank_attn(sq, p, p, skt, svt, ppos, pval, qpos,
                                         skn, svn, n_items=64)
    got, want = seg(sbad), seg(sclean)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # and the clean pool against the plain twins
    tol = dict(atol=3e-4, rtol=3e-4) if dtype == torch.float32 else \
        dict(atol=2 ** -6 * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(want.float(), pk.segment_rank_attn_plain(
        sq, sclean, sclean, skt, svt, ppos, pval, qpos, skn, svn,
        n_items=64).float(), **tol)


@pytest.mark.parametrize("pt", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_pages_load_through_the_swizzle(dev, dtype, D, pt):
    """Pages smaller than the swizzle's 1024-byte pattern (a box lands
    mid-pattern): paged == dense and one-span segment == paged, bit for
    bit; where a page's box cannot start on 128 bytes (bf16 at D 32, one
    token a page) the wrapper names the rule."""
    lens, Sq, n_incr = [100, 37], 80, 16
    n_pages = 128 // pt
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq, 2, D)
    q, kn, vn, pool = (t.to(dtype) for t in (q, kn, vn, pool))
    call = lambda: pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens,
                                             kn, vn, n_incr=n_incr)
    if pt * min(128, D * pool.element_size()) % 128:
        with pytest.raises(ValueError, match="128-byte aligned"):
            call()
        return
    paged = call()
    kg, vg = ref.gather_pages(pool, kt, plens), ref.gather_pages(pool, vt, plens)
    assert torch.equal(rk.prefix_rank_attn_split(q, kg, vg, kn, vn,
                                                 n_incr=n_incr), paged)
    ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * pt
            ).expand(2, n_pages).contiguous()
    pval = (plens[:, None] - ppos).clamp(0, pt).int()
    qpos = (n_pages * pt + torch.arange(Sq, dtype=torch.int32, device=dev)
            ).expand(2, Sq)
    assert torch.equal(pk.segment_rank_attn(
        q, pool, pool, kt, vt, ppos, pval, qpos, kn, vn, n_items=Sq - n_incr),
        paged)


def test_pool_address_follows_the_launch_and_the_graph(dev):
    """A tensor map holds its pool's address, and a CUDA graph holds the
    map by value: a graph captured on one pool replays that pool's
    result after an eager launch on another pool of the same shape, and
    the eager launch gives the other pool's own result."""
    lens, Sq, n_incr = [256, 130], 80, 16
    q, kn, vn, pool_a, kt, vt, plens = _paged(dev, lens, 64, 4, Sq)
    pool_b = _randn(dev, *pool_a.shape, seed=77)
    call = lambda pool: pk.paged_prefix_rank_attn(q, pool, pool, kt, vt,
                                                  plens, kn, vn, n_incr=n_incr)
    want_a, want_b = call(pool_a), call(pool_b)
    assert not torch.equal(want_a, want_b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(pool_a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_a = call(pool_a)
    graph.replay()
    eager_b = call(pool_b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out_a, want_a)
    assert torch.equal(eager_b, want_b)
    _close(eager_b, pk.paged_prefix_rank_attn_plain(
        q, pool_b, pool_b, kt, vt, plens, kn, vn, n_incr=n_incr))


def test_wrapper_names_the_tma_rule_a_pool_breaks(dev):
    """A pool that TMA cannot read raises a ValueError naming the rule,
    and nothing falls back: a misaligned pool, one whose strides are not
    multiples of 16 bytes, pages that do not tile the 64-key tile, an
    expanded pool or new-token view (stride 0 over its rows)."""
    lens, Sq, n_incr = [100, 37], 80, 16
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, 64, 2, Sq)
    call = lambda p: pk.paged_prefix_rank_attn(q, p, p, kt, vt, plens, kn,
                                               vn, n_incr=n_incr)
    before = pk.launches
    flat = torch.zeros(pool.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned global address"):
        call(flat[1:].view(pool.shape))
    wide = torch.zeros(*pool.shape[:3], 66, device=dev)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        call(wide[..., :64])
    q3, kn3, vn3, pool3, kt3, vt3, plens3 = _paged(dev, lens, 48, 3, Sq)
    with pytest.raises(ValueError, match="divide the 64-key tile"):
        pk.paged_prefix_rank_attn(q3, pool3, pool3, kt3, vt3, plens3, kn3,
                                  vn3, n_incr=n_incr)
    # the new K and V take tensor maps too: an expanded view is refused
    with pytest.raises(ValueError, match="k_new: TMA strides must be positive"):
        pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens,
                                  kn[:1].expand_as(kn), vn, n_incr=n_incr)
    with pytest.raises(ValueError, match="k_pool: TMA strides must be positive"):
        call(pool[:1].expand_as(pool))
    assert pk.launches == before
    # a strided pool whose strides TMA takes is read through them
    roomy = _randn(dev, *pool.shape[:3], 128, seed=5)
    roomy[..., :64] = pool
    assert torch.equal(call(roomy[..., :64]), call(pool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_prefix_refills_the_staged_table(dev, dtype):
    """One-token pages over a 4096-token psi: a block walks about ten
    prefix tiles of 64 pages each, more than its staged table holds, so
    it refills the table as it goes; paged == dense and one-span
    segment == paged, bit for bit."""
    lens, Sq, n_incr, pt = [4096, 3001], 80, 16, 1
    n_pages = 4096
    q, kn, vn, pool, kt, vt, plens = _paged(dev, lens, pt, n_pages, Sq, 2)
    q, kn, vn, pool = (t.to(dtype) for t in (q, kn, vn, pool))
    paged = pk.paged_prefix_rank_attn(q, pool, pool, kt, vt, plens, kn, vn,
                                      n_incr=n_incr)
    kg, vg = ref.gather_pages(pool, kt, plens), ref.gather_pages(pool, vt, plens)
    assert torch.equal(rk.prefix_rank_attn_split(q, kg, vg, kn, vn,
                                                 n_incr=n_incr), paged)
    ppos = (torch.arange(n_pages, dtype=torch.int32, device=dev) * pt
            ).expand(2, n_pages).contiguous()
    pval = (plens[:, None] - ppos).clamp(0, pt).int()
    qpos = (n_pages * pt + torch.arange(Sq, dtype=torch.int32, device=dev)
            ).expand(2, Sq)
    assert torch.equal(pk.segment_rank_attn(
        q, pool, pool, kt, vt, ppos, pval, qpos, kn, vn, n_items=Sq - n_incr),
        paged)


def test_model_on_card_matches_cpu(dev):
    from repro_torch.models import build_model, get_config
    cfg = get_config("hstu-gr", smoke=True)
    gpu = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab, (2, n)) for n in (100, 16, 24)]
    counts = (hk.launches, rk.launches)
    out = gpu.full_rank(*(torch.as_tensor(t, device=dev) for t in toks))
    want = cpu.full_rank(*map(torch.as_tensor, toks))
    assert hk.launches == counts[0] + cfg.n_layers
    assert rk.launches == counts[1] + cfg.n_layers
    torch.testing.assert_close(out.cpu(), want, atol=1e-4 * want.abs().max(),
                               rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = _randn(dev, 1, 2, 8, 64)
    with pytest.raises(TypeError, match="float32"):
        hk.hstu_attn(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hk.hstu_attn(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="k_new"):
        hk.hstu_attn(q.bfloat16(), q, q.bfloat16())
    odd = _randn(dev, 1, 2, 8, 66)[..., 1:65]       # rows not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        hk.hstu_attn(odd, odd, odd)
    odd = _randn(dev, 1, 2, 8, 72).bfloat16()[..., 4:68]   # 8 bytes in
    with pytest.raises(ValueError, match="aligned"):
        hk.hstu_attn(odd, odd, odd)
    with pytest.raises(ValueError, match="head dim"):
        wide = _randn(dev, 1, 2, 8, 96)
        hk.hstu_attn(wide, wide, wide)


# --- the hybrid's kernels -------------------------------------------------------


def _decode_close(got, want):
    if got.dtype == torch.float32:
        _close(got, want.float())
    else:
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=2 ** -6 * want.abs().max().item())


# S around the key tile (64 keys in bf16, 32 in float32 at D 64), the
# 4-tile ring (256 / 128 keys) and a 64-key split; 1 and 8192 as on the path
@pytest.mark.parametrize("S", [1, 31, 33, 63, 65, 127, 129, 255, 257, 1000,
                               8192])
@pytest.mark.parametrize("KV", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel(dev, S, KV, dtype):
    """H = 32 query heads (G = 32, 4, 1) over a ring of S slots in the
    model layout, the cache one section of a stacked (n_sec, B, S, KV, D)
    buffer."""
    B, H, D = 2, 32, 64
    q = _randn(dev, B, H, D, seed=1).to(dtype)
    k = _randn(dev, 3, B, S, KV, D, seed=2).to(dtype)[1]
    v = _randn(dev, 3, B, S, KV, D, seed=3).to(dtype)[1]
    before = dk.launches
    got = dk.decode_attn(q, k, v)
    assert dk.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, D)
    _decode_close(got, dk.decode_attn_plain(q, k, v))


@pytest.mark.parametrize("case", ["one-split-per-row", "short-ring", "path"])
def test_decode_attn_split_plan_edges_are_exact_and_deterministic(dev, case):
    """The plan's edges on this card: rows enough that every (b, kv) gets
    a single split; a ring shorter than one split; the path's shape with
    a handful of splits per row.  Two calls give the same bits."""
    from repro_torch.kernels import cuda_lib
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    KV, D = 32, 64
    target = cuda_lib.DECODE_BLOCKS_PER_SM * n_sm
    B, S = {"one-split-per-row": (-(-target // KV), 1000),
            "short-ring": (2, cuda_lib.DECODE_KEY_ALIGN - 1),
            "path": (2, 8192)}[case]
    n_split, _ = cuda_lib.decode_split_plan(B, KV, S, n_sm)
    assert (n_split == 1) == (case != "path")
    assert case != "path" or 2 <= n_split <= 16
    q = _randn(dev, B, KV, D, seed=11).bfloat16()
    k = _randn(dev, B, S, KV, D, seed=12).bfloat16()
    v = _randn(dev, B, S, KV, D, seed=13).bfloat16()
    got = dk.decode_attn(q, k, v)
    _decode_close(got, dk.decode_attn_plain(q, k, v))
    assert torch.equal(dk.decode_attn(q, k, v), got)


@pytest.mark.parametrize("S", [1, 65, 1000, 8192])
@pytest.mark.parametrize("KV", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_lse(dev, S, KV, dtype):
    """The kernel's log-sum-exp (one launch, counted once): ``out`` the
    same bits with and without it; the lse within 1e-4 of its twin's
    (``torch.logsumexp``) and of float64's; the ring cut in 3 at 64-slot
    boundaries, merged by the parts' lse, equal to the whole ring's out
    (float32 within 1e-5, bf16 within 2^-6 of the largest |out|)."""
    B, H, D = 2, 32, 64
    q = _randn(dev, B, H, D, seed=1).to(dtype)
    k = _randn(dev, B, S, KV, D, seed=2).to(dtype)
    v = _randn(dev, B, S, KV, D, seed=3).to(dtype)
    before = dk.launches
    out, lse = dk.decode_attn(q, k, v, lse=True)
    assert dk.launches == before + 1
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    assert torch.equal(out, dk.decode_attn(q, k, v))
    _, twin = dk.decode_attn_plain(q, k, v, lse=True)
    _, l64 = dk.decode_attn_plain(q.double(), k.double(), v.double(),
                                  lse=True)
    assert (lse - twin).abs().max().item() <= 1e-4
    assert (lse.double() - l64).abs().max().item() <= 1e-4
    cut = sorted({0, S} | {c for c in (64 * (S // 192), 128 * (S // 192))
                           if 0 < c < S})
    parts = [dk.decode_attn(q, k[:, a:b], v[:, a:b], lse=True)
             for a, b in zip(cut[:-1], cut[1:])]
    pl = torch.stack([p[1] for p in parts])
    w = torch.exp(pl - pl.amax(0))
    merged = (torch.stack([p[0].float() for p in parts]) * w[..., None]
              ).sum(0) / w.sum(0)[..., None]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    assert (merged - out.float()).abs().max().item() <= \
        tol * out.float().abs().max().item()


@pytest.mark.parametrize("D", [32, 128])
def test_decode_attn_head_dims_and_strided_cache(dev, D):
    """Every compiled head dim; a cache whose batch and slot axes are
    swapped views (no copy) is read through its strides."""
    B, H, KV, S = 3, 8, 2, 300
    q = _randn(dev, B, H, D, seed=4)
    k = _randn(dev, S, B, KV, D, seed=5).transpose(0, 1)
    v = _randn(dev, S, B, KV, D, seed=6).transpose(0, 1)
    assert not k.is_contiguous()
    _close(dk.decode_attn(q, k, v), dk.decode_attn_plain(q, k, v))


def _ssd_inputs(dev, B, nc, Q, H, P, N, steep=False, dtype=torch.float32):
    """x, B, C as slices of one (B, L, H*P + 2N) buffer of ``dtype``, as
    the model hands them over; cum a negative cumulative log-decay."""
    L = nc * Q
    xBC = _randn(dev, B, L, H * P + 2 * N, seed=7).to(dtype)
    xc = xBC[..., :H * P].reshape(B, nc, Q, H, P)
    Bc = xBC[..., H * P:H * P + N].reshape(B, nc, Q, N)
    Cc = xBC[..., H * P + N:].reshape(B, nc, Q, N)
    dt = torch.nn.functional.softplus(_randn(dev, B, nc, Q, H, seed=8))
    rate = 20.0 if steep else 0.5          # steep: exp(cum[q] - cum[t]) overflows for t > q
    cum = torch.cumsum(-dt * rate, dim=2)
    return Cc, Bc, xc, cum, dt


# the state kernel's head group is 32 (31, 33 around it); 8 x 8 thread
# tiles of 1 to 32 heads per round (N x P from 16 x 32 to 128 x 128, and
# N 48, where 256 threads hold 5 heads); Q = 1, 100 and 128.  Then the
# intra kernel's tiling: 8-key steps over two 64-row tiles, each warp 16
# rows of a tile (Q around 8, 16 and 64..128), one 64-column product at
# P <= 64 and two at P 128, every N (C and B swizzled by 32 or 16
# columns), and H not a multiple of its head group (19 = 10 + 9, 35 =
# 12 + 12 + 11)
SSD_CASES = [
    (2, 4, 128, 64, 64, 64), (2, 2, 128, 4, 64, 64), (2, 2, 128, 2, 128, 32),
    (2, 2, 128, 8, 64, 16), (1, 1, 100, 8, 32, 16), (2, 1, 1, 17, 64, 64),
    (1, 3, 64, 20, 64, 128), (1, 2, 128, 31, 64, 64), (1, 2, 128, 33, 64, 64),
    (1, 2, 128, 3, 128, 128), (1, 1, 77, 5, 64, 48), (1, 2, 100, 40, 32, 16)] + [
    (2, 2, Q, 19 if Q % 2 else 35, P, (16, 48, 64, 128)[(Q + P // 32) % 4])
    for Q in (1, 8, 15, 16, 17, 100, 127, 128) for P in (32, 64, 128)]


@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_CASES)
def test_ssd_chunk_kernels(dev, B, nc, Q, H, P, N):
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, B, nc, Q, H, P, N)
    before = (sk.launches_intra, sk.launches_state)
    y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt)
    s = sk.ssd_chunk_state(Bc, xc, cum, dt)
    assert (sk.launches_intra, sk.launches_state) == (before[0] + 1, before[1] + 1)
    _close(y, sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dt))
    _close(s, sk.ssd_chunk_state_ref(Bc, xc, cum, dt))
    assert torch.equal(sk.ssd_chunk_state(Bc, xc, cum, dt), s)


def test_ssd_chunk_intra_steep_decay_is_finite(dev):
    """Masked entries have a huge positive cum[q] - cum[t]: the kernel
    selects before the exp, so no inf * 0 = NaN reaches the output."""
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, 2, 2, 128, 8, 64, 64, steep=True)
    assert (cum[:, :, 0] - cum[:, :, -1]).max() > 100
    y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt)
    assert torch.isfinite(y).all()
    _close(y, sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dt))


@pytest.mark.parametrize("steep", [False, True])
def test_ssd_chunk_intra_keeps_f32_accuracy(dev, steep):
    """Against a float64 version within 1e-5 of the largest |out|, at a
    full head group and a full chunk, gentle and steep decay.  The same
    float64 version with C, B, x and M rounded to TF32 misses that limit,
    so a kernel that dropped the lo terms of 3xTF32 would fail; the 3e-4
    + 3e-4|plain| limit above cannot tell f32 from TF32."""
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, 2, 4, 128, 16, 64, 64, steep=steep)
    got = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt)
    want = ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dt)
    lim = 1e-5 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= lim
    tf32 = ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dt, tf32=True)
    assert (tf32 - want).abs().max().item() > lim


def test_ssd_chunk_intra_is_deterministic_and_batch_independent(dev):
    """Two calls give the same bits, and each row of a B = 3 call equals
    the B = 1 call on that row bit for bit (the plan reads H only)."""
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, 3, 2, 128, 20, 64, 64)
    y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt)
    assert torch.equal(sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt), y)
    for b in range(3):
        s = slice(b, b + 1)
        one = sk.ssd_chunk_intra(Cc[s], Bc[s], xc[s], cum[s], dt[s])
        assert torch.equal(one[0], y[b])


@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_CASES)
def test_ssd_chunk_kernels_bf16(dev, B, nc, Q, H, P, N):
    """The bf16 load path at every case of the float32 sweep, x, B and C
    as slices of one bf16 xBC: (a) the intra launch writing float32 (the
    model's) equals the float32 launch on widened inputs bit for bit, the
    one writing bf16 equals it rounded, and the state (float32) equals
    the float32 state launch; the plain twins, which widen too, within
    the float32 tolerance; two calls bit for bit."""
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, B, nc, Q, H, P, N,
                                      dtype=torch.bfloat16)
    wC, wB, wx = (t.float() for t in (Cc, Bc, xc))
    before = (sk.launches_intra, sk.launches_state)
    y = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt, out_dtype=torch.float32)
    yb = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt)
    s = sk.ssd_chunk_state(Bc, xc, cum, dt)
    assert (sk.launches_intra, sk.launches_state) == (before[0] + 2,
                                                      before[1] + 1)
    assert y.dtype == torch.float32 and yb.dtype == torch.bfloat16
    assert torch.equal(y, sk.ssd_chunk_intra(wC, wB, wx, cum, dt))
    assert torch.equal(yb, y.bfloat16())
    assert torch.equal(s, sk.ssd_chunk_state(wB, wx, cum, dt))
    assert torch.equal(sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt,
                                          out_dtype=torch.float32), y)
    assert torch.equal(sk.ssd_chunk_state(Bc, xc, cum, dt), s)
    _close(y, sk.ssd_chunk_intra_ref(Cc, Bc, xc, cum, dt, torch.float32))
    _close(s, sk.ssd_chunk_state_ref(Bc, xc, cum, dt))


@pytest.mark.parametrize("steep", [False, True])
def test_ssd_chunk_bf16_against_float64(dev, steep):
    """(b) at a full head group and chunk: the intra launch on bf16
    inputs writing float32 within 1e-5 of the largest |out| of float64
    on the widened inputs (bf16 out: plus its rounding), the state
    within 1e-5 of its largest |out|; rows of a batch bit for bit."""
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, 2, 4, 128, 16, 64, 64,
                                      steep=steep, dtype=torch.bfloat16)
    want = ref.ssd_chunk_intra_f64(Cc, Bc, xc, cum, dt)
    got = sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt, out_dtype=torch.float32)
    lim = 1e-5 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= lim
    _f64_close_bf16(sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt), want)
    s = sk.ssd_chunk_state(Bc, xc, cum, dt)
    ws = _state_f64(Bc, xc, cum, dt)
    assert (s.double() - ws).abs().max().item() <= 1e-5 * ws.abs().max().item()
    for b in range(2):
        sl = slice(b, b + 1)
        one = sk.ssd_chunk_intra(Cc[sl], Bc[sl], xc[sl], cum[sl], dt[sl],
                                 out_dtype=torch.float32)
        assert torch.equal(one[0], got[b])


@pytest.mark.parametrize("Q,P,N", [(1, 64, 64), (17, 32, 16), (100, 64, 48),
                                   (128, 64, 64), (128, 128, 128)])
def test_ssd_function_bf16_gradients_equal_the_float32_copy_route(dev, Q, P,
                                                                  N):
    """The Functions on bf16 x, B and C: outputs and every gradient bit
    for bit what autograd gives through float32 copies of them (the
    route before the bf16 load path): the backward computes in float32
    and rounds each bf16 input's gradient once."""
    ins = _ssd_inputs(dev, 2, 3, Q, 6, P, N, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(ins[2].shape, generator=g, device=dev)
    dS = torch.randn((2, 3, 6, N, P), generator=g, device=dev)
    for kernel, args, dout, kw in (
            (sk.ssd_chunk_intra, ins, dy, dict(out_dtype=torch.float32)),
            (sk.ssd_chunk_state, ins[1:], dS, {})):
        grads = []
        for widen in (False, True):
            leaves = [t.detach().clone().requires_grad_(True) for t in args]
            xs = [t.float() if widen else t for t in leaves]
            out = kernel(*xs, **kw)
            out.backward(dout)
            grads.append((out, [t.grad for t in leaves]))
        (o1, g1), (o2, g2) = grads
        assert torch.equal(o1, o2), kernel.__name__
        for a, b in zip(g1, g2):
            assert a.dtype == b.dtype and torch.equal(a, b), kernel.__name__


def _state_f64(Bc, xc, cum, dt):
    """``ssd_chunk_state_ref``'s einsum in float64 (the float64 twin of
    ``ssd_chunk_intra`` is ``ref.ssd_chunk_intra_f64``)."""
    return torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.double(),
                        torch.exp(cum[:, :, -1:] - cum).double() * dt.double(),
                        xc.double())


def _ssd_grads(dev, ins, seed=3):
    """The SSD Functions' gradients on the card (float32) and float64
    autograd's over the twins' einsums, for random output gradients:
    [(input name, card grad, float64 grad)] for both kernels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Cc, Bc, xc, cum, dt = ins
    B, nc, Q, H, P = xc.shape
    dy = torch.randn((B, nc, Q, H, P), generator=g, device=dev)
    dS = torch.randn((B, nc, H, Bc.shape[3], P), generator=g, device=dev)
    out = []
    for kernel, f64, names, args, dout in (
            (sk.ssd_chunk_intra, ref.ssd_chunk_intra_f64, "C B x cum dt",
             ins, dy),
            (sk.ssd_chunk_state, _state_f64, "B x cum dt", ins[1:], dS)):
        f32 = [t.detach().clone().requires_grad_(True) for t in args]
        y = kernel(*f32)
        assert "SSDChunk" in type(y.grad_fn).__name__
        y.backward(dout)
        d64 = [t.detach().double().requires_grad_(True) for t in args]
        f64(*d64).backward(dout.double())
        out += [(f"{kernel.__name__} d{n}", a.grad, b.grad)
                for n, a, b in zip(names.split(), f32, d64)]
    return out


@pytest.mark.parametrize("Q,P,N", [(1, 64, 64), (17, 32, 16), (64, 128, 128),
                                   (100, 64, 48), (128, 32, 16),
                                   (128, 64, 64), (128, 128, 128)])
def test_ssd_function_gradients_against_float64(dev, Q, P, N):
    """The Functions' forward launches, their float32 backward, against
    float64 autograd of the twins' einsums: every input's gradient
    within 1e-5 of its largest |g| (Q 1: cum has none, exactly 0)."""
    ins = _ssd_inputs(dev, 2, 3, Q, 6, P, N)
    for name, got, want in _ssd_grads(dev, ins):
        assert torch.isfinite(got).all(), name
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (name, err)


def test_ssd_backward_is_bitwise_repeatable(dev):
    """Two backwards of the same call give the same bits (no atomics),
    at steep decay too (no NaN from the masked exp)."""
    for steep in (False, True):
        ins = _ssd_inputs(dev, 2, 2, 128, 8, 64, 64, steep=steep)
        first = _ssd_grads(dev, ins)
        for (name, a, _), (_, b, _) in zip(first, _ssd_grads(dev, ins)):
            assert torch.isfinite(a).all() and torch.equal(a, b), name


def test_hybrid_train_step_on_card(dev):
    """One AdamW step of the Zamba2 smoke variant (one section of 2 +
    a 1-layer tail) at 2 x 256 (two chunks): every parameter has a
    finite gradient, and each SSD kernel launches twice a Mamba2 layer
    (its forward and its recompute under remat; the backward launches
    none)."""
    import dataclasses
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, get_config
    from repro_torch.training import optimizer as opt
    cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True),
                              n_layers=3, attn_every=2)
    gpu = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        gpu.shared_attn.lora_b.normal_(
            generator=torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 257))
    step = make_train_step(gpu, opt.AdamWConfig(warmup_steps=1))
    before = (sk.launches_intra, sk.launches_state, dk.launches, hk.launches)
    m = step(opt.init_state(step.params),
             {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    after = (sk.launches_intra, sk.launches_state, dk.launches, hk.launches)
    assert [a - b for a, b in zip(after, before)] == \
        [2 * cfg.n_layers, 2 * cfg.n_layers, 0, 0]
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    for name, p in gpu.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_hybrid_on_card_matches_cpu(dev):
    """The float32 Zamba2 smoke variant (2 sections + tail) on the card
    against the same weights on the CPU: prefill of two 256-token
    prompts, then 3 decode steps; every Mamba2 layer launches both SSD
    kernels once per prefill, every section one decode launch per step.
    Tolerance: 5e-4 of the largest |value| (float32 on both sides, sums
    in other orders)."""
    import dataclasses
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True),
                              n_layers=5, attn_every=2, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.shared_attn.lora_b.normal_(generator=torch.Generator().manual_seed(1))
    gpu = build_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 256)))
    counts = (sk.launches_intra, sk.launches_state, dk.launches)
    lg, cg = make_prefill_step(gpu)({"tokens": toks.to(dev)})
    assert (sk.launches_intra - counts[0], sk.launches_state - counts[1]) == \
        (cfg.n_layers, cfg.n_layers)
    lc, cc = make_prefill_step(cpu)({"tokens": toks})

    def close(a, b):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=5e-4 * max(b.abs().max().item(), 1.0))
    close(lg, lc)
    close(cg["a"][0], cc["a"][0])
    close(cg["m"]["sections"][0], cc["m"]["sections"][0])
    step_g, step_c = make_serve_step(gpu), make_serve_step(cpu)
    for i in range(3):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)))
        pos = torch.full((2,), 256 + i)
        before = dk.launches
        lg, cg = step_g(cg, {"token": tok.to(dev), "pos": pos.to(dev)})
        assert dk.launches == before + gpu.n_sections
        lc, cc = step_c(cc, {"token": tok, "pos": pos})
        close(lg, lc)


def test_hybrid_wrappers_refuse_what_the_kernels_do_not_take(dev):
    Cc, Bc, xc, cum, dt = _ssd_inputs(dev, 1, 1, 128, 4, 64, 64)
    for t in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            sk.ssd_chunk_intra(Cc.to(t), Bc.to(t), xc.to(t), cum, dt)
    with pytest.raises(TypeError, match="Bc"):
        sk.ssd_chunk_intra(Cc, Bc, xc.bfloat16(), cum, dt)
    with pytest.raises(TypeError, match="writes float32"):
        sk.ssd_chunk_intra(Cc, Bc, xc, cum, dt, out_dtype=torch.bfloat16)
    # a bf16 slice 8 bytes off a 16-byte boundary is refused, never copied
    flat = torch.zeros(1, 128, 4 * 64 + 4, device=dev, dtype=torch.bfloat16)
    odd = flat[..., 4:].reshape(1, 1, 128, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        sk.ssd_chunk_state(Bc.bfloat16(), odd, cum, dt)
    wide = torch.zeros(1, 1, 128, 4, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        sk.ssd_chunk_state(Bc, wide, cum, dt)
    long = torch.zeros(1, 1, 256, 4, 64, device=dev)
    with pytest.raises(ValueError, match="chunk"):
        sk.ssd_chunk_state(torch.zeros(1, 1, 256, 64, device=dev), long,
                           torch.zeros(1, 1, 256, 4, device=dev),
                           torch.zeros(1, 1, 256, 4, device=dev))
    q = _randn(dev, 1, 6, 64)
    kv = _randn(dev, 1, 10, 4, 64)
    with pytest.raises(ValueError, match="H % KV"):
        dk.decode_attn(q, kv, kv)
    with pytest.raises(TypeError, match="bfloat16"):
        dk.decode_attn(q.half(), kv.half(), kv.half())
    odd = _randn(dev, 1, 10, 4, 66)[..., 1:65]
    with pytest.raises(ValueError, match="aligned"):
        dk.decode_attn(_randn(dev, 1, 4, 64), odd, odd)


# --- CUDA graphs (core/graphs.py): replay == eager, honest counters ------------


def _hstu(dev, layers=2):
    """hstu-gr at full width (d_model 256, 4 heads x 64), cut in depth."""
    import dataclasses
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("hstu-gr"), n_layers=layers)
    return build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))


def _graph_cases(model, dev, B, seed):
    """(key, fn, args, refs) of every HSTU serve launch at batch B:
    prefill, rank with cache, full rank, paged and segment rank over one
    page pool (64-token pages, ragged rows, the null page last)."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    tok = lambda *s: torch.as_tensor(rng.integers(0, cfg.vocab, s),
                                     dtype=torch.int32, device=dev)
    P, pt, npb = 256, 64, 4
    psi = tuple(torch.as_tensor(rng.standard_normal(
        (cfg.n_layers, B, P, cfg.n_heads, cfg.head_dim)), dtype=torch.float32,
        device=dev) for _ in range(2))
    incr, items = tok(B, 16), tok(B, 64)
    n_pool = 2 * cfg.n_layers * B * npb
    pool = torch.as_tensor(rng.standard_normal(
        (n_pool + 1, pt, cfg.n_heads, cfg.head_dim)), dtype=torch.float32,
        device=dev)
    pool[n_pool] = 0
    tables = torch.as_tensor(rng.permutation(n_pool).reshape(
        B, cfg.n_layers, 2, npb), dtype=torch.int32, device=dev)
    lens = torch.as_tensor(rng.integers(1, P + 1, B), dtype=torch.int32,
                           device=dev)
    ppos = (torch.arange(npb, dtype=torch.int32, device=dev) * pt).expand(
        B, npb).contiguous()
    pval = (lens[:, None] - ppos).clamp(0, pt).int()
    return {
        "prefill": (("prefill", B, P), model.prefill, ({"tokens": tok(B, P)},),
                    ()),
        "rank": (("rank", B, P, 16, 64), model.rank_with_cache,
                 (psi, incr, items), ()),
        "full": (("full", B, P, 16, 64), model.full_rank,
                 (tok(B, P), incr, items), ()),
        "paged": (("paged", B, npb, 16, 64, pool.data_ptr()),
                  model.rank_with_pages, (tables, lens, incr, items),
                  (pool,)),
        "segment": (("segment", B, npb, 16, 64, pool.data_ptr()),
                    model.rank_with_segments,
                    (tables, ppos, pval, incr, items), (pool,)),
    }


def _equal(a, b):
    from repro_torch.core.graphs import tensor_leaves
    return all(torch.equal(x, y) for x, y in
               zip(tensor_leaves(a), tensor_leaves(b)))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("entry", ["prefill", "rank", "full", "paged",
                                   "segment"])
def test_graph_replay_equals_eager_bitwise(dev, entry, B):
    """The first call (eager warm-up, then capture) and replays on new
    inputs give the eager call's bits; the capture counts no launch, the
    warm-up one eager run, each replay the graph's tally."""
    from repro_torch.core.graphs import GraphRunner, read_counters
    model = _hstu(dev)
    runner = GraphRunner(dev)
    key, fn, args, refs = _graph_cases(model, dev, B, 0)[entry]
    c0 = read_counters()
    first = runner.run(key, fn, args, refs)
    c1 = read_counters()
    assert _equal(first, fn(*refs, *args))
    eager_run = {n: read_counters()[n] - c1[n] for n in c1}
    assert {n: c1[n] - c0[n] for n in c0} == eager_run   # warm-up only
    tally = runner.get(key).tally
    assert tally == {n: c for n, c in eager_run.items() if c}
    for seed in (1, 2, 3):
        _, _, new, _ = _graph_cases(model, dev, B, seed)[entry]
        before = read_counters()
        got = runner.run(key, fn, new, refs)
        after = read_counters()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
            == tally
        assert _equal(got, fn(*refs, *new)), f"{entry} B={B} seed {seed}"
    assert runner.get(key).replays == 3


def test_graph_outputs_survive_another_keys_replay(dev):
    from repro_torch.core import LiveExecutor, UserMeta
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    model = _hstu(dev)
    store = UserBehaviorStore(WorkloadConfig(
        vocab=model.cfg.vocab, n_items=64, incr_len=16, max_len=2048))
    ex = LiveExecutor(model, store)
    eager = LiveExecutor(model, store, graphs=False)
    assert ex.graphs is not None
    metas = [UserMeta(user_id=u, prefix_len=n, incr_len=16, n_items=64)
             for u, n in ((1, 300), (2, 700), (3, 300))]
    psis = [ex.pre_infer(m)[0] for m in metas]
    for m, p in zip(metas, psis):
        assert _equal(p, eager.pre_infer(m)[0])
    kept = []
    for _ in range(2):                   # capture, then replay
        for m, p in zip(metas, psis):
            kept.append((m, p, ex.rank_cached(m, p)[0]))
            ex.rank_full(m)
    for m, p, s in kept:                 # other keys replayed since
        assert torch.equal(s, eager.rank_cached(m, p)[0])
        assert torch.equal(ex.rank_full(m)[0], eager.rank_full(m)[0])


def test_paged_graph_refuses_another_pool(dev):
    from repro_torch.core.graphs import GraphRunner
    model = _hstu(dev)
    runner = GraphRunner(dev)
    key, fn, args, (pool,) = _graph_cases(model, dev, 2, 0)["paged"]
    runner.run(key, fn, args, (pool,))
    runner.run(key, fn, args, (pool,))
    with pytest.raises(ValueError, match="reference"):
        runner.get(key).replay(args, (pool.clone(),))


def test_decode_step_graph_equals_eager(dev):
    """The Zamba2 decode step (float32 smoke variant) replayed from a
    graph: logits and the updated cache equal the eager step's bit for
    bit over several steps; each step counts one decode launch a
    section."""
    import dataclasses
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True),
                              n_layers=5, attn_every=2, dtype="float32")
    model = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 256)), device=dev)
    _, cache = make_prefill_step(model)({"tokens": toks})
    clone = lambda c: {"m": {k: tuple(t.clone() for t in v)
                             for k, v in c["m"].items()},
                       "a": tuple(t.clone() for t in c["a"])}
    ce, cg = clone(cache), clone(cache)
    eager, graphed = make_serve_step(model, graphs=False), make_serve_step(model)
    for i in range(4):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)), device=dev)
        pos = torch.full((2,), 256 + i, device=dev)
        le, ce = eager(ce, {"token": tok, "pos": pos})
        before = dk.launches
        lg, cg2 = graphed(cg, {"token": tok, "pos": pos})
        assert cg2 is cg and dk.launches == before + model.n_sections
        assert torch.equal(lg, le), f"step {i}"
        assert _equal(cg, ce), f"step {i}: cache"
    assert graphed.runner.captures == {"warmup": 0, "lazy": 1}


@pytest.mark.parametrize("flags", [
    ["--page-tokens", "64"], ["--batched", "--page-tokens", "64"],
    ["--segments", "--batched"], ["--hosts", "2"], ["--prefill-hosts", "1"]],
    ids=["reship", "batched-reship", "segments-batched-reship", "hosts-2",
         "prefill-hosts-1"])
def test_serve_replays_graphs_on_card(dev, flags, capsys):
    """serve (smoke model) on the card in modes chip_smoke.py does not
    drive — a host page pool re-shipped per launch into the runner's
    static pool buffer among them — with graphs and with --no-graphs:
    graphs are captured and replayed, hits reach HBM, the rank kernels
    count launches, and the re-shipped pool stays in the h2d ledger."""
    import re
    from repro_torch.core.graphs import read_counters, write_counters
    from repro_torch.launch import serve
    for extra in ([], ["--no-graphs"]):
        write_counters({n: 0 for n in read_counters()})
        summary = {}
        hits = serve.main(["--device", "cuda", "--requests", "12", *flags,
                           *extra], summary)
        out = capsys.readouterr().out
        counts = read_counters()
        assert hits.get("hbm_hit", 0) >= 1, (extra, hits)
        assert counts["hstu_attn"] > 0, counts
        runner = summary["graphs"]
        if extra:
            assert runner is None and "graphs:" not in out
        else:
            assert sum(g.replays for g in runner.graphs.values()) > 0
            assert "graphs:" in out
        paged = ("paged_prefix_rank_attn" if "--segments" not in flags
                 else "segment_rank_attn")
        if "--page-tokens" in flags or "--segments" in flags:
            assert counts[paged] > 0, counts
            reships = int(re.search(r'"launch_reships": (\d+)', out).group(1))
            assert reships > 0, out


@pytest.mark.parametrize("flags", [
    ["--batched", "--device-pool"], ["--segments", "--batched",
                                     "--device-pool"]],
    ids=["batched-device-pool", "segments-batched-device-pool"])
def test_serve_bf16_on_card(dev, flags, monkeypatch, capsys):
    """A bf16 smoke ``hstu-gr`` served on the card with graphs: hits
    reach HBM, the pool is device-resident and never re-shipped, and the
    rank kernels launch at bf16 (every launch of the run takes bf16)."""
    import dataclasses
    from repro_torch.core.graphs import read_counters, write_counters
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve
    from repro_torch.models import get_config
    monkeypatch.setattr(serve, "get_config", lambda arch, smoke=False:
                        dataclasses.replace(get_config(arch, smoke=smoke),
                                            dtype="bfloat16"))
    types = set()
    launch = cuda_lib.rank_attn

    def spy(q, *a, **k):
        types.add(q.dtype)
        return launch(q, *a, **k)
    monkeypatch.setattr(cuda_lib, "rank_attn", spy)
    write_counters({n: 0 for n in read_counters()})
    hits = serve.main(["--device", "cuda", "--requests", "12", *flags])
    out = capsys.readouterr().out
    counts = read_counters()
    assert hits.get("hbm_hit", 0) >= 1, hits
    assert '"launch_reships": 0' in out and '"device_resident": true' in out
    paged = "segment_rank_attn" if "--segments" in flags else \
        "paged_prefix_rank_attn"
    assert counts["hstu_attn"] > 0 and counts[paged] > 0, counts
    assert types == {torch.bfloat16}, types


def test_hstu_bf16_model_on_card_matches_cpu(dev):
    """A bf16 smoke ``hstu-gr`` on the card against the same weights on
    the CPU: ``full_rank`` within 2**-4 of the largest |score| (the
    kernels round once from float32, the CPU twins round logits and
    scores to bf16, bf16 ulps apart at every layer), one launch of rows
    1 and 2 a layer; the relay (``rank_with_cache`` over the prefill's
    psi) equals the full rank bit for bit."""
    import dataclasses
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("hstu-gr", smoke=True),
                              dtype="bfloat16")
    gpu = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab, (2, n)) for n in (100, 16, 24)]
    on = [torch.as_tensor(t, device=dev) for t in toks]
    counts = (hk.launches, rk.launches)
    out = gpu.full_rank(*on)
    assert (hk.launches, rk.launches) == (counts[0] + cfg.n_layers,
                                          counts[1] + cfg.n_layers)
    assert out.dtype == torch.bfloat16
    want = cpu.full_rank(*map(torch.as_tensor, toks)).float()
    torch.testing.assert_close(out.cpu().float(), want, rtol=0,
                               atol=2 ** -4 * want.abs().max().item())
    _, psi = gpu.prefill({"tokens": on[0]})
    assert psi[0].dtype == torch.bfloat16
    assert torch.equal(gpu.rank_with_cache(psi, on[1], on[2]), out)


def test_hybrid_bf16_ssd_route_equals_float32_copies(dev, monkeypatch):
    """zamba2's smoke config (bf16) on the card: every SSD launch of a
    prefill and a train step takes bf16 x, B and C, and the prefill's
    logits and caches, the step's loss and every gradient equal bit for
    bit the route that hands each kernel float32 copies of them."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, get_config
    cfg = get_config("zamba2_1p2b", smoke=True)
    model = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.shared_attn.lora_b.normal_(
            generator=torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 257)), device=dev)
    prefill = make_prefill_step(model)
    types = []
    launch = cuda_lib.ssd_chunk

    def spy(kind, Cc, Bc, xc, *a, **k):
        types.append({t.dtype for t in (Cc, Bc, xc) if t is not None})
        return launch(kind, Cc, Bc, xc, *a, **k)
    monkeypatch.setattr(cuda_lib, "ssd_chunk", spy)

    def run():
        logits, cache = prefill({"tokens": toks[:, :256]})
        model.zero_grad(set_to_none=True)
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        loss.backward()
        model.requires_grad_(False)
        return ([logits, *torch.utils._pytree.tree_leaves(cache), loss],
                {n: p.grad for n, p in model.named_parameters()})

    new, grads = run()
    assert types and all(t == {torch.bfloat16} for t in types)
    types.clear()
    intra, state = sk.ssd_chunk_intra, sk.ssd_chunk_state
    monkeypatch.setattr(sk, "ssd_chunk_intra",
                        lambda C, B, x, cum, dt, out_dtype=None: intra(
                            C.float(), B.float(), x.float(), cum, dt,
                            out_dtype))
    monkeypatch.setattr(sk, "ssd_chunk_state",
                        lambda B, x, cum, dt: state(B.float(), x.float(),
                                                    cum, dt))
    old, want = run()
    assert types and all(t == {torch.float32} for t in types)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name, g in grads.items():
        assert g is not None and torch.equal(g, want[name]), name


def test_a_failing_capture_raises(dev):
    """A capture that cannot be recorded (a host sync inside) raises and
    leaves no graph; nothing reruns eagerly in its place."""
    from repro_torch.core.graphs import GraphRunner, read_counters
    runner = GraphRunner(dev)
    x = _randn(dev, 8)
    before = read_counters()
    with pytest.raises(RuntimeError):
        runner.run(("sync", 1), lambda t: t * t.sum().item(), (x,))
    assert runner.get(("sync", 1)) is None
    assert read_counters() == before
    torch.cuda.synchronize()
    assert torch.isfinite(x).all()


# --- training: the attention's gradient, the train step, HSTU decode ----------


@pytest.mark.parametrize("S", [1, 17, 64, 130, 600])
@pytest.mark.parametrize("D", [32, 64])
def test_hstu_attn_function_gradients_against_float64(dev, S, D,
                                                     monkeypatch):
    """``HSTUAttnFunction``: one counted kernel launch forward, and dq,
    dk, dv within 1e-5 of each gradient's largest |g| of float64
    autograd over the plain twin (64-row blocks at S 130 and 600)."""
    q, k, v, dout = (_randn(dev, 2, 3, S, D, seed=i) for i in range(4))
    f32 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = hk.launches
    out = hk.hstu_attn(*f32)
    assert hk.launches == before + 1
    assert type(out.grad_fn).__name__ == "HSTUAttnFunctionBackward"
    _close(out.detach(), hk.hstu_attn_plain(q, k, v))
    monkeypatch.setattr(hk, "BWD_BLOCK_ELEMS", 2 * 3 * 64 * S)
    out.backward(dout)
    assert hk.launches == before + 1           # the backward launches nothing
    f64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    hk.hstu_attn_plain(*f64).backward(dout.double())
    for name, a, b in zip("qkv", f32, f64):
        rel = ((a.grad.double() - b.grad).abs().max()
               / b.grad.abs().max()).item()
        assert rel <= 1e-5, f"d{name}: {rel:.2e}"


@pytest.mark.parametrize("S", [17, 130])
def test_hstu_attn_function_bf16_gradients_equal_the_widened_float32(
        dev, S, monkeypatch):
    """bf16 q, k, v through ``HSTUAttnFunction``: the forward is the bf16
    launch (equal to the float32 launch on the widened inputs, rounded
    to bf16), and dq, dk, dv are the float32 Function's gradients on the
    widened inputs and the widened bf16 dout, each rounded to bf16 once:
    bit for bit."""
    q, k, v, dout = (_randn(dev, 2, 3, S, 64, seed=i).bfloat16()
                     for i in range(4))
    monkeypatch.setattr(hk, "BWD_BLOCK_ELEMS", 2 * 3 * 64 * S)
    bf = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wide = [t.float().requires_grad_(True) for t in (q, k, v)]
    before = hk.launches
    out = hk.hstu_attn(*bf)
    assert hk.launches == before + 1 and out.dtype == torch.bfloat16
    ref_out = hk.hstu_attn(*wide)
    assert torch.equal(out.float(), ref_out.detach().bfloat16().float())
    out.backward(dout)
    ref_out.backward(dout.float())
    for name, a, b in zip("qkv", bf, wide):
        assert a.grad.dtype == torch.bfloat16, name
        assert torch.equal(a.grad, b.grad.bfloat16()), f"d{name}"


def test_two_ranks_over_gloo_share_one_card(dev, tmp_path):
    """hstu-gr smoke with 4 heads on a (1, 2) mesh of two processes on
    one card, joined by gloo with CUDA tensors: each rank launches
    ``hstu_attn`` once a layer on its 2 heads in the prefill and
    ``prefix_rank_attn`` once a layer in ``rank_with_cache``; the
    reassembled logits, psi and scores equal one process's within 1e-5
    of their largest |value|."""
    import dataclasses
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    import _dist_workers as W
    from repro_torch.models import build_model, get_config
    from repro_torch.models.convert import export_params
    cfg = dataclasses.replace(get_config("hstu-gr", smoke=True), n_heads=4)
    whole = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 64))
    incr, items = (rng.integers(0, cfg.vocab, (2, n)) for n in (8, 16))
    lg, psi = whole.prefill({"tokens": torch.as_tensor(prompt, device=dev)})
    sc = whole.rank_with_cache(psi, torch.as_tensor(incr, device=dev),
                               torch.as_tensor(items, device=dev))
    # the ranks load the kernels this process has built
    outs = W.spawn(W.cuda_hstu_worker, (1, 2), tmp_path, cfg,
                   export_params(whole), prompt, incr, items)
    pairs = [("logits", lg, ("batch", None, "vocab")),
             ("scores", sc, ("batch", None, None))]
    pairs += [(f"psi{j}", t, whole.cache_axes(2, 64)[j])
              for j, t in enumerate(psi)]
    for key, want, axes in pairs:
        want = want.float().cpu().numpy()
        got = W.assemble([o[key] for o in outs], axes, want.shape, (1, 2))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
    for o in outs:
        assert o["launches"] == {"hstu_attn": cfg.n_layers,
                                 "prefix_rank_attn": cfg.n_layers}


def _train_pair(dev):
    from repro_torch.models import build_model, get_config
    cfg = get_config("hstu-gr", smoke=True)
    gpu = build_model(cfg, device=dev).init(torch.Generator().manual_seed(0))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return cfg, gpu, cpu


def test_train_step_counts_hstu_attn_launches(dev):
    """One AdamW step on the card: two ``hstu_attn`` launches a layer
    (the forward and its recompute under remat), the loss and the
    updated weights as on the CPU (1e-5 relative, 1e-4 of each leaf's
    largest |value|)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import optimizer as opt
    cfg, gpu, cpu = _train_pair(dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 257))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    adamw = opt.AdamWConfig(warmup_steps=1)
    steps = [make_train_step(m, adamw) for m in (gpu, cpu)]
    states = [opt.init_state(s.params) for s in steps]
    before = hk.launches
    got = steps[0](states[0], batch)
    assert hk.launches == before + 2 * cfg.n_layers
    want = steps[1](states[1], batch)
    assert got["loss"].item() == pytest.approx(want["loss"].item(), rel=1e-5)
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=1e-4 * b.abs().max().item(),
                                   msg=name)


def test_a_failing_attention_launch_raises_in_training(dev, monkeypatch):
    """No fallback: a refused kernel launch fails the train step, and a
    head dim the kernel does not compile is refused, not run plainly."""
    import dataclasses
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    cfg, gpu, _ = _train_pair(dev)
    batch = {"tokens": np.zeros((1, 16), np.int32),
             "labels": np.zeros((1, 16), np.int32)}
    step = make_train_step(gpu)

    def refuse(*a, **k):
        raise RuntimeError("hstu_rank_attn_f32 launch failed: refused")

    monkeypatch.setattr(cuda_lib, "rank_attn", refuse)
    before = hk.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        step(opt.init_state(step.params), batch)
    assert hk.launches == before
    monkeypatch.undo()
    odd = build_model(dataclasses.replace(cfg, head_dim=16, n_heads=4),
                      device=dev).init(torch.Generator().manual_seed(0))
    step = make_train_step(odd)
    with pytest.raises(ValueError, match="head dim"):
        step(opt.init_state(step.params), batch)


def test_hstu_serve_step_replay_equals_eager(dev):
    """HSTU ``decode_step`` through ``make_serve_step``: graph replays
    equal the eager step bit for bit, the psi comes back untouched, one
    ``prefix_rank_attn`` launch a layer and step, and the card's logits
    match the CPU's (1e-4 of the largest)."""
    from repro_torch.launch.steps import make_serve_step
    cfg, gpu, cpu = _train_pair(dev)
    rng = np.random.default_rng(1)
    _, psi = gpu.prefill({"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (2, 100)), device=dev)})
    keep = [t.clone() for t in psi]
    eager, graphed = make_serve_step(gpu, graphs=False), make_serve_step(gpu)
    pos = torch.tensor([100, 63], device=dev)
    for i in range(3):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)), device=dev)
        before = rk.launches
        lg, cache = graphed(psi, {"token": tok, "pos": pos})
        assert cache is psi and rk.launches == before + cfg.n_layers
        le, _ = eager(psi, {"token": tok, "pos": pos})
        assert torch.equal(lg, le), f"step {i}"
        want = cpu.decode_step(tuple(t.cpu() for t in psi),
                               {"token": tok.cpu(), "pos": pos.cpu()})[0]
        torch.testing.assert_close(le.cpu(), want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    assert all(torch.equal(a, b) for a, b in zip(psi, keep))
    assert graphed.runner.captures == {"warmup": 0, "lazy": 1}


# --- the decoder-only Transformer family ------------------------------------------


# (H, KV) of the family's configs: G = 1 (deepseek_moe_16b), 2 (internvl2),
# 4 (qwen3), 6 (dbrx), 8 (yi), 9 (starcoder2_7b's real heads), 12
# (starcoder2_15b); S on the 16 / 32-key tiles at D 128, a 64-key split,
# a last split holding one key, deepseek_moe_16b's and internvl2_2b's
# served rings (2048, 256 + 2048), the 4096 window, decode_32k's length
@pytest.mark.parametrize("S", [1, 33, 65, 321, 2048, 2304, 4096, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", [(16, 16), (16, 8), (32, 8), (48, 8),
                                  (32, 4), (36, 4), (48, 4)])
def test_decode_attn_transformer_groups(dev, H, KV, dtype, S):
    B, D = 2, 128
    q = _randn(dev, B, H, D, seed=21).to(dtype)
    k = _randn(dev, B, S, KV, D, seed=22).to(dtype)
    v = _randn(dev, B, S, KV, D, seed=23).to(dtype)
    before = dk.launches
    got = dk.decode_attn(q, k, v)
    assert dk.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, D)
    _decode_close(got, dk.decode_attn_plain(q, k, v))
    assert torch.equal(dk.decode_attn(q, k, v), got)


def test_head_pad_decode_launches_on_the_real_heads(dev):
    """starcoder2_7b's decode attention: 36 real heads padded to 48 over 4
    kv heads, at full width in float32.  One launch on the real heads
    (G 9: real head h reads kv head h // 9, not h // 12), equal to the
    CPU's plain path on the same weights and ring."""
    import dataclasses
    from repro_torch.models import get_config, layers
    cfg = dataclasses.replace(get_config("starcoder2_7b"), dtype="float32")
    assert (cfg.n_heads, cfg.head_pad, cfg.n_kv_heads) == (36, 48, 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {k: _randn(dev, *s.shape, seed=24 + i) / s.shape[0] ** 0.5
              for i, (k, s) in enumerate(
                  sorted(layers.attention_specs(cfg).items()))}
    x = _randn(dev, 2, 1, cfg.d_model, seed=27)
    pos = torch.tensor([4096, 5000], device=dev)
    cache = tuple(_randn(dev, 2, 4096, 4, 128, seed=s) for s in (28, 29))

    def run(d):
        kv = tuple(t.to(d, copy=True) for t in cache)
        return layers.attention({k: w.to(d) for k, w in params.items()},
                                x.to(d), cfg, positions=pos.to(d)[:, None],
                                cache=kv, cache_index=pos.to(d))[0]

    before = dk.launches
    got = run(dev)
    assert dk.launches == before + 1
    want = run("cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


_LM = {}


def _lm_model(dev, arch):
    """A full-width config cut to 2 layers, bf16, weights from seed 0."""
    import dataclasses
    from repro_torch.models import build_model, get_config
    if arch not in _LM:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        _LM[arch] = build_model(cfg, device=dev).init(
            torch.Generator().manual_seed(0))
    return _LM[arch]


@pytest.mark.parametrize("arch,quant", [("qwen3_4b", False),
                                        ("deepseek_moe_16b", False),
                                        ("qwen3_4b", True)])
def test_transformer_decode_graph_equals_eager(dev, arch, quant):
    """A Transformer decode step at full width (2 layers) replayed from a
    graph: logits and the cache, written in place, equal the eager
    step's bit for bit over 4 steps; each step launches ``decode_attn``
    once a layer.  ``quant``: the int8 4-tuple cache (the prefill's K/V
    quantized), under a ``kv_quant`` copy of the config."""
    import dataclasses
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import quantize_kv
    model = _lm_model(dev, arch)
    if quant:
        qm = build_model(dataclasses.replace(model.cfg, kv_quant=True),
                         device=dev)
        qm.load_state_dict(model.state_dict())
        model = qm
    cfg = model.cfg
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 192)), device=dev)
    _, cache = make_prefill_step(model)({"tokens": toks})
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(cache[0]), quantize_kv(cache[1])
        cache = (kq, vq, ks, vs)
    ce, cg = tuple(t.clone() for t in cache), tuple(t.clone() for t in cache)
    eager, graphed = make_serve_step(model, graphs=False), make_serve_step(model)
    for i in range(4):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)), device=dev)
        pos = torch.tensor([192 + i, 7 + i], device=dev)
        le, ce = eager(ce, {"token": tok, "pos": pos})
        before = dk.launches
        lg, cg2 = graphed(cg, {"token": tok, "pos": pos})
        assert cg2 is cg and dk.launches == before + cfg.n_layers
        assert torch.equal(lg, le), f"step {i}"
        assert _equal(cg, ce), f"step {i}: cache"
    assert graphed.runner.captures == {"warmup": 0, "lazy": 1}


def _ssm_encdec_model(dev, arch, family=None):
    """A full-width config cut to 2 layers (2 + 2 for the enc-dec), bf16,
    weights from seed 0; ``family`` replaces the config's."""
    import dataclasses
    from repro_torch.models import build_model, get_config
    key = (arch, family)
    if key not in _LM:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, n_enc_layers=2)
        if family:
            cfg = dataclasses.replace(cfg, family=family)
        _LM[key] = build_model(cfg, device=dev).init(
            torch.Generator().manual_seed(0))
    return _LM[key]


@pytest.mark.parametrize("arch,family", [("rwkv6_1p6b", None),
                                         ("zamba2_1p2b", "ssm_mamba2"),
                                         ("seamless_m4t_large_v2", None)])
def test_ssm_and_encdec_decode_graph_equals_eager(dev, arch, family):
    """An SSM stack (RWKV6; Mamba2 at zamba2's widths) and the enc-dec at
    full width, 2 layers: a decode step replayed from a graph gives the
    eager step's logits and state bit for bit over 4 steps, the graph
    copying an SSM's new state (RWKV6's token shift included) into the
    caller's and writing the enc-dec's self ring in place.  Each
    enc-dec step launches ``decode_attn`` twice a layer (self ring and
    cross K/V); the SSM steps launch no kernel."""
    from repro_torch.core.graphs import read_counters, tensor_leaves
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    model = _ssm_encdec_model(dev, arch, family)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128)),
                                       device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                                      device=dev).to(torch.bfloat16)
    _, cache = make_prefill_step(model)(batch)
    clone = lambda c: ({k: tuple(t.clone() for t in v) for k, v in c.items()}
                       if isinstance(c, dict) else tuple(t.clone() for t in c))
    ce, cg = clone(cache), clone(cache)
    eager, graphed = make_serve_step(model, graphs=False), make_serve_step(model)
    per_step = 2 * cfg.n_layers if cfg.family == "encdec" else 0
    for i in range(4):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)), device=dev)
        pos = torch.tensor([128 + i, 9 + i], device=dev)
        le, ce = eager(ce, {"token": tok, "pos": pos})
        before = read_counters()
        lg, cg2 = graphed(cg, {"token": tok, "pos": pos})
        after = read_counters()
        assert cg2 is cg
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == \
            ({"decode_attn": per_step} if per_step else {})
        assert torch.equal(lg, le), f"step {i}"
        assert all(torch.equal(a, b) for a, b in
                   zip(tensor_leaves(cg), tensor_leaves(ce))), f"step {i}"
    assert graphed.runner.captures == {"warmup": 0, "lazy": 1}


def test_cross_attention_decode_launches_decode_attn(dev):
    """``attention`` with ``kv_override`` and one query launches the
    ``decode_attn`` kernel once, within the bf16 limit of the reference
    math (the plain ``_sdpa`` with no mask, on float32 copies); S > 1
    queries run the plain ``_sdpa`` and launch nothing."""
    from repro_torch.models import get_config, layers
    cfg = get_config("seamless_m4t_large_v2")
    g = torch.Generator(device=dev).manual_seed(3)
    p = {k: (torch.randn(s.shape, generator=g, device=dev)
             / s.shape[0] ** 0.5).to(torch.bfloat16)
         for k, s in layers.attention_specs(cfg).items()}
    ek, ev = (torch.randn((2, cfg.n_frontend_tokens, cfg.n_kv_heads,
                           cfg.head_dim), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    for S, launched in ((1, 1), (5, 0)):
        x = torch.randn((2, S, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        pos = torch.arange(S, device=dev)[None, :] + 40
        before = dk.launches
        y, _ = layers.attention(p, x, cfg, positions=pos,
                                kv_override=(ek, ev), causal=False)
        assert dk.launches - before == launched, S
        q = torch.einsum("bsd,dhk->bshk", x.float(), p["wq"].float())
        want = layers._sdpa(q, ek.float(), ev.float(), None,
                            cfg.head_dim ** -0.5)
        want = torch.einsum("bshk,hkd->bsd", want, p["wo"].float())
        err = (y.float() - want).abs().max() / want.abs().max()
        assert err.item() < 2 ** -6, (S, err.item())
