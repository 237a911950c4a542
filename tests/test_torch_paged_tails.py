"""The keys a paged launch does not hold, and TMA's rules for a pool.

The paged and segment rank kernels (``csrc/hstu_rank_attn.cu``, rows 3-4)
load whole pages by TMA, so the keys a launch does not hold reach shared
memory too: the tail of a row's last page past ``prefix_lens``, a segment
page's keys past ``page_valid``, and pages no table names.  A freed page
keeps its last user's K/V, and a re-shipped pool may hold any bits, NaN
included.  Here, on the CPU: the plain twins give the same bits on a
pool whose unheld keys are NaN as on one whose unheld keys are finite
junk; that clean pool matches the JAX package's Pallas paged and segment
kernels in interpret mode (3e-4 absolute and relative, the repo's
float32 kernel tolerance, ``tests/test_torch_kernels.py``); and the
wrapper's TMA preconditions (``cuda_lib.tma_pool_geometry``) give the
box geometry of every head dim, type and page size, or a ValueError that
names the rule a pool breaks.  The card runs the same checks on the
kernels (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_prefix_attn import pack_segments as jpack_segments
from repro.kernels.paged_prefix_attn import (
    paged_prefix_rank_attn as pallas_paged_rank_attn)
from repro.kernels.paged_prefix_attn import (
    segment_rank_attn as pallas_segment_rank_attn)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import paged_prefix_attn as pk

torch.set_num_threads(1)

TOL = dict(atol=3e-4, rtol=3e-4)
H, D = 2, 64
TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _paged_case(rng, lens, pt, n_pages, Sq, equal_tables=False):
    """A pool of random pages, K and V tables naming distinct shuffled
    pages (or one table for both), ragged rows; the tail of each row's
    last page and the pages no table names hold finite junk.  Returns
    numpy (q, kn, vn, pool, k_table, v_table, prefix_lens, held) with
    ``held`` (N + 1, page_tokens) the pool keys some row holds."""
    B = len(lens)
    n_pool = (1 if equal_tables else 2) * B * n_pages
    pool = rng.normal(size=(n_pool + 1, pt, H, D)).astype(np.float32)
    pool[n_pool] = 0
    ids = rng.permutation(n_pool)
    kt = np.full((B, n_pages), n_pool, np.int32)
    vt = kt.copy()
    held = np.zeros((n_pool + 1, pt), bool)
    for b, ln in enumerate(lens):
        used = -(-ln // pt)
        base = (1 if equal_tables else 2) * b * n_pages
        kt[b, :used] = ids[base:base + used]
        vt[b, :used] = kt[b, :used] if equal_tables else \
            ids[base + n_pages:base + n_pages + used]
        for s in range(used):
            n = min(pt, ln - s * pt)
            held[kt[b, s], :n] = held[vt[b, s], :n] = True
    q, kn, vn = (rng.normal(size=(B, H, Sq, D)).astype(np.float32)
                 for _ in range(3))
    return q, kn, vn, pool, kt, vt, np.asarray(lens, np.int32), held


SEG_ROWS = [   # ('c', n) a cached span, ('f', n) fresh tokens; 64 fresh a row
    [("c", 100), ("f", 8), ("c", 37), ("f", 24), ("c", 70), ("f", 32)],
    [("c", 64), ("f", 32), ("f", 32)],
    [("f", 4), ("c", 100), ("f", 12), ("c", 1), ("f", 48)],
]


def _segment_case(rng, pt, rows):
    """Span pages packed by the JAX package's packer (one table for K and
    V), a slot past the longest row (null-padded), the tail of each
    partly held page finite junk.  Returns numpy (q, kn, vn, pool, table,
    page_pos, page_valid, q_pos, held)."""
    B = len(rows)
    Sq = sum(n for kind, n in rows[0] if kind == "f")
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
    kc, vc = (rng.normal(size=(B, H, C, D)).astype(np.float32) for _ in "kv")
    n_pages = max(sum(-(-n // pt) for _, n in sp) for sp in spans) + 1
    kp, vp, table, ppos, pval = (np.asarray(a) for a in jpack_segments(
        kc, vc, spans, pt, n_pages))
    kp, vp = kp.copy(), vp.copy()
    held = np.zeros(kp.shape[:2], bool)
    for t, v in zip(table.reshape(-1), pval.reshape(-1)):
        held[t, :v] = True
    for pages in (kp, vp):
        junk = rng.normal(size=pages.shape).astype(np.float32)
        pages[~held] = junk[~held]
    q, kn, vn = (rng.normal(size=(B, H, Sq, D)).astype(np.float32)
                 for _ in range(3))
    return (q, kn, vn, kp, vp, table, ppos, pval,
            np.asarray(q_pos, np.int32), held)


def _poison(pool, held):
    bad = pool.copy()
    bad[~held] = np.nan
    return bad


def _t(x, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if t.is_floating_point() else t


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("pt", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_twin_ignores_what_the_pool_does_not_hold(dtype, pt, B):
    """The paged twin on a pool whose unheld keys are NaN: finite, and
    the clean pool's bits (unheld keys finite junk there)."""
    rng = np.random.default_rng(pt + B)
    lens = [256, 200, 1, 65, 130, 64, 255, 17][:B] if B > 1 else [200]
    q, kn, vn, pool, kt, vt, plens, held = _paged_case(rng, lens, pt,
                                                       256 // pt, 80)
    assert (~held).any() and np.isfinite(pool).all()
    dt = TYPES[dtype]
    call = lambda p: pk.paged_prefix_rank_attn(
        _t(q, dt), _t(p, dt), _t(p, dt), _t(kt), _t(vt), _t(plens),
        _t(kn, dt), _t(vn, dt), n_incr=16)
    clean, bad = call(pool), call(_poison(pool, held))
    assert torch.isfinite(bad).all()
    assert torch.equal(bad, clean)


@pytest.mark.parametrize("pt", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_twin_ignores_what_the_pool_does_not_hold(dtype, pt):
    """The segment twin on a pool whose keys past page_valid (and the
    null-padded slots' page) are NaN: finite, and the clean pool's bits."""
    rng = np.random.default_rng(7 + pt)
    q, kn, vn, kp, vp, table, ppos, pval, q_pos, held = _segment_case(
        rng, pt, SEG_ROWS)
    assert (~held).any()
    dt = TYPES[dtype]
    call = lambda k, v: pk.segment_rank_attn(
        _t(q, dt), _t(k, dt), _t(v, dt), _t(table), _t(table), _t(ppos),
        _t(pval), _t(q_pos), _t(kn, dt), _t(vn, dt), n_items=32)
    clean, bad = call(kp, vp), call(_poison(kp, held), _poison(vp, held))
    assert torch.isfinite(bad).all()
    assert torch.equal(bad, clean)


@pytest.mark.parametrize("lens,pt", [([100, 37], 16), ([256, 130], 64),
                                     ([1, 64], 64)])
def test_paged_clean_pool_matches_pallas(lens, pt):
    """The pool with finite junk in its unheld keys: the paged twin
    matches the Pallas paged kernel in interpret mode (one table for K
    and V, the reference's interface)."""
    rng = np.random.default_rng(sum(lens) + pt)
    n_pages = 256 // pt
    q, kn, vn, pool, kt, _, plens, held = _paged_case(
        rng, lens, pt, n_pages, 64, equal_tables=True)
    assert (~held).any()
    got = pk.paged_prefix_rank_attn(_t(q), _t(pool), _t(pool), _t(kt),
                                    _t(kt), _t(plens), _t(kn), _t(vn),
                                    n_incr=32)
    want = pallas_paged_rank_attn(
        *map(jnp.asarray, (q, pool, pool, kt, plens, kn, vn)), n_incr=32,
        bq=32, bk=pt, n_total=n_pages * pt + 64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pt", [16, 64])
def test_segment_clean_pool_matches_pallas(pt):
    """The span pool with finite junk past page_valid: the segment twin
    matches the Pallas segment kernel in interpret mode."""
    rng = np.random.default_rng(11 + pt)
    q, kn, vn, kp, vp, table, ppos, pval, q_pos, held = _segment_case(
        rng, pt, SEG_ROWS)
    got = pk.segment_rank_attn(_t(q), _t(kp), _t(vp), _t(table), _t(table),
                               _t(ppos), _t(pval), _t(q_pos), _t(kn), _t(vn),
                               n_items=32)
    want = pallas_segment_rank_attn(
        *map(jnp.asarray, (q, kp, vp, table, ppos, pval, q_pos, kn, vn)),
        n_items=32, bq=32, bk=pt, n_total=table.shape[1] * pt + q.shape[2],
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# the boxes a page takes for each of K and V (one 128-byte row each)
BOXES = {(32, "float32"): 1, (64, "float32"): 2, (128, "float32"): 4,
         (32, "bfloat16"): 1, (64, "bfloat16"): 1, (128, "bfloat16"): 2}


@pytest.mark.parametrize("D_", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_geometry_of_every_page_size(dtype, D_):
    """page_tokens 1..64 at each head dim and type: a page that divides
    the 64-key tile gets one box per 128-byte column block (64 bytes for
    bf16 at D 32), written through a swizzle of the box row's bytes;
    anything else raises naming its rule: pages that do not tile the
    key tile, or a page box whose shared-memory destination cannot start
    on 128 bytes (bf16 at D 32, one token a page)."""
    dt = TYPES[dtype]
    esz = torch.finfo(dt).bits // 8
    row = D_ * esz
    for pt in range(1, 65):
        shape = (9, pt, H, D_)
        strides = (pt * H * D_, H * D_, D_, 1)
        geometry = lambda: cuda_lib.tma_pool_geometry(shape, strides, dt, 256)
        if 64 % pt:
            with pytest.raises(ValueError, match="divide the 64-key tile"):
                geometry()
            continue
        w = min(128, row)
        if pt * w % 128:
            with pytest.raises(ValueError, match="128-byte aligned"):
                geometry()
            assert (dtype, D_) == ("bfloat16", 32) and pt == 1
            continue
        got = geometry()
        assert got == dict(swizzle=w, inner=w // esz,
                           boxes=BOXES[D_, dtype], box=(w // esz, 1, pt, 1),
                           page_bytes=pt * row)
        assert got["boxes"] * got["swizzle"] == row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_geometry_names_the_rule_a_pool_breaks(dtype):
    """A misaligned pool, a strided pool whose strides are no multiples
    of 16 bytes, a D that is not the innermost contiguous dim, and
    extents TMA cannot address each raise a ValueError naming the rule;
    a strided pool whose strides TMA takes is accepted."""
    dt = TYPES[dtype]
    esz = torch.finfo(dt).bits // 8
    shape = (9, 16, H, D)
    packed = (16 * H * D, H * D, D, 1)
    g = lambda sh=shape, st=packed, ptr=256: cuda_lib.tma_pool_geometry(
        sh, st, dt, ptr, "k_pool")
    with pytest.raises(ValueError, match="k_pool: TMA needs a 16-byte "
                                         "aligned global address"):
        g(ptr=256 + esz)
    strided = (16 * H * (D + 2), H * (D + 2), D + 2, 1)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        g(st=strided)
    with pytest.raises(ValueError, match="innermost dimension"):
        g(st=(16 * H * D * 2, H * D * 2, D * 2, 2))
    with pytest.raises(ValueError, match="below 2\\*\\*40"):
        g(st=(1 << 40, H * D, D, 1))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        g(sh=((1 << 32) + 1, 16, H, D))
    roomy = (16 * H * (D + 64), H * (D + 64), D + 64, 1)
    assert g(st=roomy) == g()
    # the wrapper itself checks a real strided view the same way
    pool = torch.zeros(9, 16, H, D + 2, dtype=dt)[..., :D]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        cuda_lib.tma_pool_geometry(pool.shape, pool.stride(), dt,
                                   pool.data_ptr(), "v_pool")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_strides_refuse_an_expanded_view(dtype):
    """The new K and V are read through tensor maps as the pools are: a
    view expanded over its rows (stride 0) raises a ValueError naming the
    rule, where a stride-0 dim of one row, never stepped over, is taken."""
    dt = TYPES[dtype]
    kn = torch.zeros(1, H, 80, D, dtype=dt)
    dims = ("batch", "head", "token")
    check = lambda t, name="k_new": cuda_lib.tma_strides(
        tuple(t.shape), t.stride(), dt, name, dims)
    check(kn.expand(1, H, 80, D))
    with pytest.raises(ValueError, match="k_new: TMA strides must be "
                                         "positive, the batch stride is 0"):
        check(kn.expand(3, H, 80, D))
    with pytest.raises(ValueError, match="v_new: TMA strides must be "
                                         "positive, the token stride is 0"):
        check(kn[:, :, :1].expand(1, H, 80, D), "v_new")
    pool = torch.zeros(1, 16, H, D, dtype=dt).expand(9, 16, H, D)
    with pytest.raises(ValueError, match="k_pool: TMA strides must be "
                                         "positive, the page stride is 0"):
        cuda_lib.tma_pool_geometry(pool.shape, pool.stride(), dt, 256, "k_pool")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_layout_refuses_pages_the_loader_cannot_take(dtype):
    """``PageLayout.from_model_config`` asks the paged loader's rule when
    a page size is chosen, so a layout the kernel would refuse fails at
    configuration, not at the first rank: one-token pages of bf16 at head
    dim 32 (a 64-byte box cannot start on 128 bytes); every other page
    size that divides 64 is taken, in both types."""
    from repro_torch.core.paging import PageLayout
    from repro_torch.configs.hstu_gr import smoke_config
    cfg = dataclasses.replace(smoke_config(), dtype=dtype)
    assert cfg.head_dim == 32
    for pt in (1, 2, 4, 8, 16, 32, 64):
        if dtype == "bfloat16" and pt == 1:
            with pytest.raises(ValueError, match="page_tokens=1: a TMA box's "
                                                 "shared-memory destination"):
                PageLayout.from_model_config(cfg, pt)
        else:
            assert PageLayout.from_model_config(cfg, pt).page_tokens == pt


def test_kernel_sweeps_time_the_tree_they_are_given(tmp_path):
    """``tools/rank_plan_sweep.py --root`` (and ``ssd_intra_sweep.py``)
    time another tree's kernels beside this tree's, as the parent of a
    change is timed against it: chip_smoke, imported first for its
    timers, has already imported this tree's ``repro_torch``, so the
    sweep must load the kernel module from the tree it is given."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    shutil.copytree(repo / "src" / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [%r, %r]; import chip_smoke; "
            "from rank_plan_sweep import load_tree; "
            "print(load_tree(%r).__file__)"
            % (str(repo), str(repo / "tools"), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().startswith(str(tmp_path / "src")), out.stdout
