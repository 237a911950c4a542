"""The traffic is the same for the same seed and differs across seeds;
lengths are drawn from the law, stratified, and arrivals are Poisson."""

import numpy as np
import pytest

from relaybench import spec, traffic

LONG = {"loop": "open", "arrivals": "poisson", "rate_per_s": 8.0,
        "incr_len": 64, "n_items": 512, "block": 16,
        "prefix": {"law": "log_uniform", "lo": 8192, "hi": 32768}}
SHORT = {"loop": "closed", "callers": 16, "pool": 64, "incr_len": 64,
         "n_items": 512,
         "prefix": {"law": "log_normal", "mu": 6.2, "sigma": 0.95,
                    "lo": 8, "hi": 2048}}
SEEDS = (7, 2 ** 31 + 11, 2 ** 40 + 3)


def draw(t, seed, seconds=5.0):
    store, reqs = traffic.generate(t, seed, seconds, 100000,
                                   callers_pool=t.get("pool", 0))
    lens = [r.prefix_len for r in reqs]
    offs = [r.offset_s for r in reqs]
    toks = np.concatenate([store.long_term(r.user_id) for r in reqs[:4]])
    return lens, offs, toks, store, reqs


@pytest.mark.parametrize("t", [LONG, SHORT], ids=["open", "closed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(t, seed):
    a, b = draw(t, seed), draw(t, seed)
    assert a[0] == b[0] and a[1] == b[1]
    assert np.array_equal(a[2], b[2])


@pytest.mark.parametrize("t", [LONG, SHORT], ids=["open", "closed"])
def test_seeds_differ_in_lengths_and_tokens(t):
    a, b = draw(t, SEEDS[0]), draw(t, SEEDS[1])
    assert a[0] != b[0]
    assert not np.array_equal(a[2][:1000], b[2][:1000])
    if t["loop"] == "open":
        assert a[1] != b[1]


@pytest.mark.parametrize("block", [0, 16])
def test_each_block_draws_once_in_every_stratum(block):
    u = traffic.strata(100, block, traffic.seed_rng(3, 1))
    k = block or 100
    assert np.all((u > 0) & (u < 1))
    for i in range(0, 100 - k + 1, k):
        assert sorted((u[i:i + k] * k).astype(int)) == list(range(k))


def test_lengths_follow_the_law_not_classes():
    lens = traffic.prefix_lengths(LONG["prefix"], 4000,
                                  traffic.seed_rng(5, 1), block=16)
    assert lens.min() >= 8192 and lens.max() <= 32768
    # log-uniform: a quarter of the draws in each quarter of log(length)
    q = np.log(lens / 8192) / np.log(4)
    counts = np.histogram(q, bins=4, range=(0, 1))[0]
    assert np.all(np.abs(counts - 1000) <= 2)
    # the 64-token prefill grid's 384 steps of the band nearly all occur
    assert len({-(-n // 64) for n in lens}) > 370


def test_poisson_arrivals_keep_the_rate():
    t = traffic.poisson_arrivals(8.0, 1000.0, traffic.seed_rng(9, 1))
    assert np.all(np.diff(t) > 0) and 0 < t[0] and t[-1] < 1000.0
    assert abs(len(t) - 8000) < 4 * np.sqrt(8000)
    gaps = np.diff(t)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05


def test_requests_carry_their_tokens():
    lens, offs, _, store, reqs = draw(LONG, 3)
    assert reqs and 0.0 < offs[0] and max(offs) < 5.0
    for r in reqs:
        assert len(store.long_term(r.user_id)) == r.prefix_len
        assert len(store.short_term(r.user_id)) == 64
        assert len(store.candidates(r.user_id)) == 512
        assert 8192 <= r.prefix_len <= 32768
    assert len({r.user_id for r in reqs}) == len(reqs)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (spec.HERE / "traffic").glob("*.json")))
def test_traffic_files_generate(name):
    t = spec.traffic(name)
    store, reqs = traffic.generate(t, 5, 2.0, 100000,
                                   callers_pool=min(t.get("pool", 0), 32))
    assert reqs and all(r.prefix_len >= 8 for r in reqs)
