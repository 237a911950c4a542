"""The CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card (marker ``cuda``; every test skips without one):

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch only, so it also runs where JAX is absent.  It
sweeps the edges that ``chip_smoke.py`` does not: ragged lengths around
the 64-token tiles, every compiled head dim, short and empty prefixes,
pages smaller than the key tile, and the refusals of the wrapper.
Tolerance: 3e-4 absolute + 3e-4 relative, the repo's f32 kernel
tolerance.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import hstu_attn as hk
from repro_torch.kernels import paged_prefix_attn as pk
from repro_torch.kernels import prefix_rank_attn as rk
from repro_torch.kernels import ref

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
    (0, 16, 64), (1, 5, 7), (100, 16, 64), (128, 0, 70), (130, 64, 512)])
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
    with pytest.raises(TypeError, match="float32"):
        hk.hstu_attn(q.bfloat16(), q.bfloat16(), q.bfloat16())
    odd = _randn(dev, 1, 2, 8, 66)[..., 1:65]       # rows not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        hk.hstu_attn(odd, odd, odd)
    with pytest.raises(ValueError, match="head dim"):
        wide = _randn(dev, 1, 2, 8, 96)
        hk.hstu_attn(wide, wide, wide)
