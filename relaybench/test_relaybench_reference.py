"""The plain reference equals the port's plain path on a smoke-size
model, with the benchmark's weights loaded into both."""

import dataclasses

import pytest
import torch

from relaybench import reference, traffic, weights
from repro_torch.models import build_model, get_config
from repro_torch.serving.batching import pad_psi

SMOKE = {"arch": "hstu-gr", "n_layers": 2, "d_model": 64, "n_heads": 2,
         "n_kv_heads": 2, "head_dim": 32, "d_ff": 128, "vocab": 512,
         "n_tasks": 1, "dtype": "float32", "rope_theta": 10000.0}


def smoke(dtype="float32"):
    sizes = dict(SMOKE, dtype=dtype)
    cfg = dataclasses.replace(get_config("hstu-gr"), **{
        k: v for k, v in sizes.items() if k != "arch"})
    model = build_model(cfg, device="cpu")
    w = weights.make(sizes, 11, "cpu")
    weights.load(model, w)
    return sizes, model, w


def tokens(n, seed):
    return torch.as_tensor(traffic.zipf_tokens(traffic.seed_rng(seed, 9),
                                               n, SMOKE["vocab"]))


@pytest.mark.parametrize("n,bucket", [(64, 64), (192, 256), (320, 512)])
def test_reference_equals_the_ports_plain_path(n, bucket):
    sizes, model, w = smoke()
    pre, incr, items = tokens(n, 1), tokens(16, 2), tokens(32, 3)
    _, kv = model.prefill({"tokens": pre[None]})
    got = model.rank_with_cache(pad_psi(kv, bucket), incr[None],
                                items[None])[0]
    want = reference.Reference(w, sizes).scores(pre, bucket, incr, items)
    assert reference.gap(got, want) < 1e-5


def test_bf16_port_is_near_the_float32_reference():
    sizes, model, w = smoke("bfloat16")
    pre, incr, items = tokens(256, 1), tokens(16, 2), tokens(32, 3)
    _, kv = model.prefill({"tokens": pre[None]})
    got = model.rank_with_cache(kv, incr[None], items[None])[0]
    want = reference.Reference(w, sizes).scores(pre, 256, incr, items)
    assert 1e-5 < reference.gap(got, want) < 0.1


def test_weights_follow_the_seed():
    a = weights.make(SMOKE, 3, "cpu")
    b = weights.make(SMOKE, 3, "cpu")
    c = weights.make(SMOKE, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.uvqk"], c["layers.uvqk"])


def test_bf16_weights_are_stored_values():
    w = weights.make(dict(SMOKE, dtype="bfloat16"), 3, "cpu")
    for name in ("tok", "layers.uvqk", "layers.wo"):
        assert torch.equal(w[name], w[name].bfloat16().float())


def test_tf32_control_departs_from_the_reference():
    sizes, _, w = smoke()
    pre, incr, items = tokens(256, 1), tokens(16, 2), tokens(32, 3)
    want = reference.Reference(w, sizes).scores(pre, 256, incr, items)
    low = reference.Reference(w, sizes, precision="tf32").scores(
        pre, 256, incr, items)
    assert reference.gap(low, want) > 1e-4


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5))
    r = reference.tf32(x)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.equal(reference.tf32(r), r)
