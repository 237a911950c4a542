"""LM training in the port for the hybrid, the SSM stacks (Mamba2, RWKV6)
and the enc-dec on the CPU, held against the JAX package; the SSD
kernels' backward; the launcher.

Weights and inputs as ``tests/_lm_train.py`` makes them, in float32:
``zamba2_1p2b``'s, ``rwkv6_1p6b``'s and ``seamless_m4t_large_v2``'s smoke
configs, and an ``ssm_mamba2`` stack built from zamba2's by
``dataclasses.replace(family="ssm_mamba2")`` in both packages.

Tolerances (both sides float32, summed in other orders): the loss 1e-5
relative; a step's grad_norm 1e-5 relative; each gradient leaf, and the
step's AdamW moments, 1e-4 of the leaf's largest |value|; the updated
parameters 1e-6 of each leaf's largest |p| against the reference's
``apply_updates`` given the port's gradients (``_lm_train``).  The SSD
backward (``kernels.ssd_chunk``) is held against float64 autograd of the
twins' einsums, evaluated in float64, to 1e-10 of each gradient's
largest |g| (both float64).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train as lt
from repro.kernels import ssd_chunk as jssd
from repro_torch.kernels import ssd_chunk as sk
from repro_torch.launch import train

torch.set_num_threads(1)

SSD_REL = 1e-10


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_1p6b",
                                  "seamless_m4t_large_v2", "ssm_mamba2"])
def test_loss_and_train_step_match_reference(arch):
    """``loss`` and one ``make_train_step`` step at the smoke config, B 2
    x S 64 (the enc-dec's frames beside)."""
    m = lt.check_train_step(arch, 2, 64)
    assert math.isfinite(float(m["loss"])) and set(m) == {
        "loss", "ce", "grad_norm", "lr"}


@pytest.mark.parametrize("arch,S", [
    ("zamba2_1p2b", 256),        # hybrid: two SSD chunks, shared attention
    ("ssm_mamba2", 256),         # Mamba2 stack: two SSD chunks
    ("rwkv6_1p6b", 64),          # RWKV6: the plain WKV loop
    ("seamless_m4t_large_v2", 64),   # enc-dec: the encoder through xattn
])
def test_every_gradient_matches_reference(arch, S):
    lt.check_gradients(arch, 2, S)


# --- the SSD backward -------------------------------------------------------------


def _intra64(Cc, Bc, xc, cum, dtc):
    """``ssd_chunk_intra_ref``'s einsums in the inputs' type."""
    Q = Cc.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    M = torch.where(causal, torch.exp(torch.where(causal, dec, 0.0)), 0.0)
    return torch.einsum("bcqkh,bckhp->bcqhp",
                        M * scores[..., None] * dtc[:, :, None], xc)


def _state64(Bc, xc, cum, dtc):
    """``ssd_chunk_state_ref``'s einsum in the inputs' type."""
    return torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc,
                        torch.exp(cum[:, :, -1:] - cum) * dtc, xc)


def _ssd_inputs(B, nc, Q, H, P, N, A=None, seed=0):
    """float64 inputs as ``mamba2_forward`` makes them: dt = softplus(.),
    cum the cumulative log-decay dt A, A = -exp(N(0, 1/4)) a head or the
    one rate given."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    Cc, Bc, xc = rn(B, nc, Q, N), rn(B, nc, Q, N), rn(B, nc, Q, H, P)
    dtc = torch.nn.functional.softplus(rn(B, nc, Q, H))
    A = -torch.exp(0.5 * rn(H)) if A is None \
        else torch.full((H,), A, dtype=torch.float64)
    return Cc, Bc, xc, torch.cumsum(dtc * A, dim=2), dtc


def _close64(got, want, rel=SSD_REL):
    """Within ``rel`` of the largest |want| (exactly 0 where want is:
    one token a chunk has no decay to differentiate)."""
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.parametrize("B,nc,Q,H,P,N,A", [
    (2, 3, 16, 3, 8, 5, None),
    (1, 2, 1, 2, 4, 3, None),         # one token a chunk
    (1, 1, 128, 2, 4, 4, None),       # the model's chunk
    (2, 2, 33, 2, 4, 4, -20.0),       # steep decay: far pairs underflow
])
def test_ssd_backward_matches_float64_autograd(B, nc, Q, H, P, N, A):
    ins = _ssd_inputs(B, nc, Q, H, P, N, A)
    g = torch.Generator().manual_seed(1)
    dy = torch.randn((B, nc, Q, H, P), generator=g, dtype=torch.float64)
    dS = torch.randn((B, nc, H, N, P), generator=g, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    _intra64(*leaves).backward(dy)
    for got, want in zip(sk.ssd_chunk_intra_backward(*ins, dy), leaves):
        assert got.dtype == torch.float64 and got.shape == want.shape
        _close64(got, want.grad)
    leaves = [t.clone().requires_grad_(True) for t in ins[1:]]
    _state64(*leaves).backward(dS)
    for got, want in zip(sk.ssd_chunk_state_backward(*ins[1:], dS), leaves):
        assert got.dtype == torch.float64 and got.shape == want.shape
        _close64(got, want.grad)


def test_ssd_functions_wire_the_backward(monkeypatch):
    """The Functions with the kernel launches swapped for the float64
    einsums (the CPU has no card): ``gradcheck`` in float64, one launch
    per forward; the CPU wrappers never enter them."""
    calls = {"intra": 0, "state": 0}

    def fake(kind, fn):
        def launch(*a, out_dtype=None):
            calls[kind] += 1
            return fn(*a)
        return launch

    monkeypatch.setattr(sk, "_launch_intra", fake("intra", _intra64))
    monkeypatch.setattr(sk, "_launch_state", fake("state", _state64))
    ins = [t.requires_grad_(True) for t in _ssd_inputs(1, 2, 5, 2, 3, 4)]
    assert torch.autograd.gradcheck(sk.SSDChunkIntraFunction.apply, ins)
    assert torch.autograd.gradcheck(sk.SSDChunkStateFunction.apply, ins[1:])
    n = dict(calls)
    sk.SSDChunkIntraFunction.apply(*ins).sum().backward()
    sk.SSDChunkStateFunction.apply(*ins[1:]).sum().backward()
    assert calls == {"intra": n["intra"] + 1, "state": n["state"] + 1}
    # CPU tensors: the plain twins, ordinary autograd
    f32 = [t.detach().float().requires_grad_(True) for t in ins]
    for out in (sk.ssd_chunk_intra(*f32), sk.ssd_chunk_state(*f32[1:])):
        assert out.grad_fn is not None and "SSDChunk" not in type(
            out.grad_fn).__name__
    assert calls == {"intra": n["intra"] + 1, "state": n["state"] + 1}


def test_twin_gradient_is_finite_where_the_reference_is_nan():
    """ROADMAP Queue 3, item 24: the reference's intra-chunk mask
    ``where(causal, exp(dec), 0)`` exponentiates the masked entries too,
    and at a chunk's log-decay span above 88 they overflow to inf, whose
    gradient through the ``where`` is 0 * inf = NaN.  The port's twin
    exponentiates under the mask: the same output (1e-6 of its largest
    |value|, float32 sums in other orders), and a finite gradient within
    1e-4 of the largest |g| of the float64 backward on the same float32
    inputs (a float32 exp(cum[q] - cum[t]) at spans near 100 carries a
    relative rounding of ~100 * 2**-24)."""
    ins = [t.float().double() for t in _ssd_inputs(1, 2, 64, 2, 4, 4, -3.0)]
    assert (ins[3][:, :, 0] - ins[3][:, :, -1]).max() > 88
    dy = torch.randn((1, 2, 64, 2, 4),
                     generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    jins = [jnp.asarray(t.float().numpy()) for t in ins]
    jgrads = jax.grad(lambda *a: jnp.sum(
        jssd.ssd_chunk_intra_ref(*a) * jnp.asarray(dy.float().numpy())),
        argnums=(0, 1, 2, 3, 4))(*jins)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)
    f32 = [t.float().requires_grad_(True) for t in ins]
    out = sk.ssd_chunk_intra(*f32)
    lt.close(out, np.asarray(jssd.ssd_chunk_intra_ref(*jins)), 1e-6)
    out.backward(dy.float())
    want = sk.ssd_chunk_intra_backward(*ins, dy)
    for t, w in zip(f32, want):
        assert torch.isfinite(t.grad).all()
        _close64(t.grad.double(), w, 1e-4)


# --- the launcher -----------------------------------------------------------------


@pytest.mark.parametrize("arch,extra", [
    ("zamba2-1.2b", []),
    ("seamless-m4t-large-v2", ["--batch", "2", "--seq", "64"]),
])
def test_launcher_trains_the_hybrid_and_the_encdec(arch, extra, capsys):
    """``--smoke --device cpu --steps 3``: three finite losses, one a
    step (the enc-dec's batch gets zero frames, as the reference's
    launcher gives them)."""
    last = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--log-every", "1"] + extra)
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", out)]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] == pytest.approx(last, abs=1e-4)
