"""The port's kernel modules on the CPU, held against the JAX package.

Every kernel wrapper of ``repro_torch.kernels`` runs its plain-PyTorch
version on CPU tensors.  Each is held, on the same numpy-made inputs,
against the ``repro.kernels.ref`` oracle and against the Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it), at that file's
shapes.  Tolerance: the repo's f32 kernel tolerance, 3e-4 absolute and
relative (``tests/test_kernels.py``) — the two frameworks sum the same
products in different orders.  The CUDA kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.hstu_attn import hstu_attn as pallas_hstu_attn
from repro.kernels.paged_prefix_attn import (
    paged_prefix_rank_attn as pallas_paged_rank_attn)
from repro.kernels.prefix_rank_attn import (
    prefix_rank_attn as pallas_prefix_rank_attn)
from repro_torch.kernels import (cuda_lib, hstu_attn, ops, paged_prefix_attn,
                                 prefix_rank_attn, ref)

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

TOL = dict(atol=3e-4, rtol=3e-4)


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
    """CPU tensors take the plain version without counting a launch;
    any other device goes to the kernel launcher, which refuses what is
    not CUDA — there is no silent fallback."""
    before = (hstu_attn.launches, prefix_rank_attn.launches,
              paged_prefix_attn.launches)
    q = torch.zeros(1, 1, 4, 32)
    hstu_attn.hstu_attn(q, q, q)
    prefix_rank_attn.prefix_rank_attn_split(q, q, q, q, q, n_incr=2)
    assert (hstu_attn.launches, prefix_rank_attn.launches,
            paged_prefix_attn.launches) == before
    m = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hstu_attn.hstu_attn(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        prefix_rank_attn.prefix_rank_attn_split(m, m, m, m, m, n_incr=2)


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
