"""A whole run on the CPU at a smoke size, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath
(an answer altered where it is produced, half of each batch left out),
or with the TF32 control in the program's place, it comes out not
correct."""

import pytest
import torch

from relaybench import run as harness
from relaybench import spec

CONFIG = {
    "model": {"arch": "hstu-gr", "n_layers": 2, "d_model": 64,
              "n_heads": 2, "n_kv_heads": 2, "head_dim": 32, "d_ff": 128,
              "vocab": 512, "n_tasks": 1, "dtype": "float32",
              "rope_theta": 10000.0},
    "relay": {"trigger": {"n_instances": 2, "r2": 0.5,
                          "rank_p99_budget_ms": 1e-3},
              "cluster": {"max_batch": 8, "batch_wait_ms": 2.0,
                          "page_tokens": 64, "device_pool": True,
                          "hbm_cache_bytes": 64e6,
                          "dram_budget_bytes": 64e6}},
    "limits": {"score_gap": 1e-4},
}
# 16 callers start at once: rank batches form, so half a batch can go
TRAFFIC = {"loop": "closed", "callers": 16, "pool": 40, "incr_len": 16,
           "n_items": 32, "drain_s": 30,
           "prefix": {"law": "log_uniform", "lo": 64, "hi": 1024}}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the run is on the wall clock, and test
    workers that each spin a thread a core would stall it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def go(fault=None, trace=False, config=CONFIG, control=None):
    return harness.run_cell(config, TRAFFIC, seed=2 ** 31 + 5, seconds=3.0,
                            trace=trace, device="cpu", fault=fault,
                            control=control)


def test_sound_run_is_correct_and_batches():
    r = go(trace=True)
    assert r.correct and r.failed == 0 and r.attempted > 16
    assert r.checks["score_gap"]["value"] < 1e-5
    metrics = [{"name": n, "unit": "x"} for n in
               ("saturated_ranked_per_s", "setup_s",
                "rank_batch_mean.over", "mfu.over")]
    got = spec.read_metrics(metrics, r)
    assert got["rank_batch_mean.over"]["value"] > 1.0
    assert got["saturated_ranked_per_s"]["value"] > 0
    assert got["setup_s"]["value"] > 0
    assert 0 < got["mfu.over"]["value"]
    assert "hbm_hit" in {q["hit"] for q in r.requests}


@pytest.mark.parametrize("fault", ["alter", "half"])
def test_broken_timed_path_is_not_correct(fault):
    r = go(fault)
    assert not r.correct
    assert r.checks["score_gap"]["value"] > CONFIG["limits"]["score_gap"]


def test_control_in_the_programs_place_is_not_correct():
    r = go(control="tf32")
    assert not r.correct and r.failed == 0
    assert r.checks["score_gap"]["value"] > CONFIG["limits"]["score_gap"]


def test_full_ranks_are_compared():
    cfg = dict(CONFIG, relay=dict(CONFIG["relay"], trigger=dict(
        CONFIG["relay"]["trigger"], rank_p99_budget_ms=1e9)))
    r = go(config=cfg)
    assert r.correct
    assert {h for _, h, _ in r.sample} == {"miss"}
