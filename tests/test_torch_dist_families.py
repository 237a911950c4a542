"""The hybrid, SSM and enc-dec families and the sequence-sharded decode
under a process mesh, on the CPU, held against the JAX package's
unsharded results.

Three gloo spawns of 4 ranks (``tests/_dist_workers.py``):

* (2, 2) and (1, 4): the smoke configs of zamba2_1p2b (hybrid),
  "ssm_mamba2" (zamba2's with the SSM family), rwkv6_1p6b and
  seamless_m4t_large_v2: prefill logits, 3 decode steps, the loss and
  every gradient (the backward on its own thread, as autograd runs a
  CUDA model's, so every checkpoint's recompute needs its own rules).
  On (1, 4) Mamba2's ``w_in`` (552 columns, 138 a rank) and ``conv``
  (288, 72) are cut across the z | x | B | C | dt parts, and RWKV6's 2
  heads do not divide 4 while its 128 "heads" columns do (half a head a
  rank).  (2, 2) also runs two AdamW steps of the hybrid, and both
  meshes the live collectives of each family's steps against the meta
  dry-run's;
* (4, 1): one sequence (B 1) decoded over a 65536-slot ring under the
  kv_seq rule ("kv_seq" on "data", 16384 slots a rank) for the qwen3,
  zamba2, hstu-gr and seamless smoke configs: the logits of 4 steps
  whose slots fall on each rank in turn and the ring after them (the
  owner's write at its local index, nothing else changed), against the
  port's unsharded decode of the same ring on one process, and the
  logits against the reference's.  At positions near 10^5 the two
  frameworks' float32 cos / sin of the RoPE angles differ (their angles
  are equal bit for bit), which moves the logits by up to ~3e-4 of the
  largest and the written keys by ~1e-2 relative in the unsharded
  decode already: the sharded logits are held to that unsharded gap
  plus 2e-5 of the largest.

Weights and tolerances are ``tests/test_torch_dist.py``'s: the
reference's init with ``tests/_lm_train.py``'s noise (Mamba2's A_log
centred at -2: ROADMAP Queue 3, item 24), 2e-5 of the largest |value|
for logits and caches, 1e-4 for gradients, the loss 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
import _lm_train as lm
from repro_torch.kernels import decode_attn as dk
from repro_torch.launch.dryrun import trace_collectives
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model, get_config
from repro_torch.models.config import InputShape
from repro_torch.models.convert import state_from_tree
from repro_torch.models.layers import merge_ring
from repro_torch.models.partitioning import make_mesh
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten, leaves, tree_map

REL = 2e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
FAMILIES = ["zamba2_1p2b", "ssm_mamba2", "rwkv6_1p6b",
            "seamless_m4t_large_v2"]
KV_SEQ_ARCHS = ["qwen3_4b", "zamba2_1p2b", "hstu_gr",
                "seamless_m4t_large_v2"]
RING = 65536
SIZES = {"22": (2, 2), "14": (1, 4)}


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _tcfg(arch):
    return lm.cfgs(arch, dtype="float32")[1]


def _inputs(arch, seed, B=4, S=16):
    """A prompt (an enc-dec's with its frames), 3 decode steps and a
    train batch, from numpy."""
    cfg = _tcfg(arch)
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        prompt["frames"] = rng.normal(size=(B, cfg.n_frontend_tokens,
                                            cfg.d_model)).astype(np.float32)
    steps = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
              (S + i + np.arange(B) * 3).astype(np.int32)) for i in range(3)]
    return prompt, steps, lm.batch(cfg, B, S, seed)


def _kv_seq_inputs(arch, seed):
    """The global cache of a one-sequence decode over RING slots (numpy,
    every leaf drawn N(0.5, 0.5^2): the ring's K/V, a hybrid's Mamba2
    states, an enc-dec's cross K/V) and 4 steps whose slots fall on the
    4 ranks of "data" in turn.  The mean keeps the attention's output
    away from zero: over 65536 zero-mean values it would be their
    cancellation, whose float32 rounding is most of what is left."""
    cfg = _tcfg(arch)
    model = build_model(cfg, device="meta")
    specs = model.cache_specs(1, RING)
    if cfg.hstu:
        specs = specs[0]
    rng = np.random.default_rng(seed)

    def draw(sd):
        if isinstance(sd, dict):
            return {k: draw(sd[k]) for k in sorted(sd)}
        if isinstance(sd[1], torch.dtype):
            return (0.5 + 0.5 * rng.normal(size=sd[0])).astype(np.float32)
        return tuple(draw(x) for x in sd)
    cache = draw(specs)
    steps = [(rng.integers(0, cfg.vocab, (1, 1)).astype(np.int32),
              np.array([RING + r * (RING // 4) + 7 + r], np.int32))
             for r in range(4)]
    return cache, steps


def _collective_cases(archs):
    return [(_tcfg(a), s) for a in archs for s in (
        InputShape("p", 16, 4, "prefill"), InputShape("d", 16, 4, "decode"),
        InputShape("t", 16, 4, "train"))]


TALLY = {"22": FAMILIES, "14": ["zamba2_1p2b", "rwkv6_1p6b"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_families")
    ins = {a: _inputs(a, 20 + i) for i, a in enumerate(FAMILIES)}
    fam = [(W.lm_worker, (_tcfg(a), lm.pair(a)[1]) + ins[a])
           for a in FAMILIES]
    hcfg = _tcfg("zamba2_1p2b")
    batches = [lm.batch(hcfg, 4, 16, 30 + i) for i in range(2)]
    out22 = W.spawn(W.jobs_worker, (2, 2), tmp, fam + [
        (W.train_worker, (hcfg, lm.pair("zamba2_1p2b")[1], batches, ADAMW)),
        (W.collectives_worker, (_collective_cases(TALLY["22"]),))])
    out14 = W.spawn(W.jobs_worker, (1, 4), tmp, fam + [
        (W.collectives_worker, (_collective_cases(TALLY["14"]),))])
    kin = {a: _kv_seq_inputs(a, 40 + i) for i, a in enumerate(KV_SEQ_ARCHS)}
    out41 = W.spawn(W.jobs_worker, (4, 1), tmp, [
        (W.kv_seq_worker, (_tcfg(a), lm.pair(a)[1], kin[a][0], RING,
                           kin[a][1])) for a in KV_SEQ_ARCHS])
    return {"22": out22, "14": out14, "41": out41, "in": ins, "kv": kin,
            "train": (hcfg, batches)}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX package's prefill logits, decode logits, final cache, loss,
    metrics and gradients on ``_inputs``' data (one device)."""
    jm, params, _ = lm.pair(arch)
    prompt, steps, train = _inputs(arch, 20 + FAMILIES.index(arch))
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, prompt))
    out = {"prefill": np.asarray(jl), "decode": []}
    jstep = jax.jit(jm.decode_step)
    for tok, pos in steps:
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(pos)})
        out["decode"].append(np.asarray(jl))
    out["cache"] = jax.tree.map(np.asarray, jc)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, train))
    out.update(loss=float(jloss), ce=float(jmet["ce"]),
               grads=state_from_tree(jax.tree.map(np.asarray, jg)))
    return out


@pytest.mark.parametrize("mesh", ["22", "14"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_reference(runs, arch, mesh):
    """Prefill logits, 3 decode steps (an SSM stack's state after them
    too), the loss, the CE metric and every gradient of each rank's
    shards put back together, against the reference on one device; the
    ranks' tallies alike."""
    sizes = SIZES[mesh]
    outs = [r[FAMILIES.index(arch)] for r in runs[mesh]]
    want = _reference(arch)
    tm = build_model(_tcfg(arch), device="meta")
    lg_ax = ("batch", None, "vocab")
    _close(W.assemble([o["prefill"] for o in outs], lg_ax,
                      want["prefill"].shape, sizes), want["prefill"])
    for i, w in enumerate(want["decode"]):
        _close(W.assemble([o["decode"][i] for o in outs], lg_ax, w.shape,
                          sizes), w)
    if outs[0]["cache"] is not None:                # an SSM stack's state
        for j, (w, ax) in enumerate(zip(want["cache"],
                                        tm.cache_axes(4, 16))):
            _close(W.assemble([o["cache"][j] for o in outs], ax, w.shape,
                              sizes), w)
    for o in outs:
        assert set(o["metrics"]) == {"ce"}
        assert abs(o["metrics"]["ce"] / want["ce"] - 1) <= LOSS_REL
        assert abs(o["metrics"]["ce"] / want["loss"] - 1) <= LOSS_REL
        for k in ("tally_prefill", "tally_decode", "tally_loss"):
            assert o[k] == outs[0][k], (arch, k)
    axes = W.param_axes_flat(tm)
    for name, g in want["grads"].items():
        if name not in outs[0]["grads"]:            # off the loss's path
            assert not np.abs(g).any(), name
            continue
        _close(W.assemble([o["grads"][name] for o in outs], axes[name],
                          g.shape, sizes), g, GRAD_REL)
    sharded = sum(np.shape(outs[0]["grads"][k]) != want["grads"][k].shape
                  for k in outs[0]["grads"])
    assert sharded >= 5, (arch, mesh, sharded)


def test_misaligned_splits_gather_on_the_model_axis(runs):
    """Each Mamba2 layer gathers its projection, its conv weight and the
    conv state it starts from (3 all-gathers a layer, in the prefill and
    in each decode step); RWKV6's half-head columns on (1, 4) one gather
    of r, k, v, g a layer; on (2, 2), where RWKV6's heads split, none."""
    L = get_config("zamba2_1p2b", smoke=True).n_layers
    for mesh, rwkv_gathers in (("14", L), ("22", 0)):
        o = runs[mesh][0][FAMILIES.index("ssm_mamba2")]
        assert o["tally_prefill"]["all-gather"]["count"] == 3 * L
        assert o["tally_decode"]["all-gather"]["count"] == 3 * 3 * L
        o = runs[mesh][0][FAMILIES.index("rwkv6_1p6b")]
        assert o["tally_prefill"]["all-gather"]["count"] == rwkv_gathers


def test_live_collectives_of_the_families_equal_the_meta_tally(runs):
    """Each family's prefill, decode and train step on the mesh: every
    rank's live tally equals the meta dry-run's (``trace_collectives``)
    at the same shape and mesh."""
    for mesh, archs in TALLY.items():
        live = [r[len(FAMILIES) + (1 if mesh == "22" else 0)]
                for r in runs[mesh]]
        m = make_mesh(SIZES[mesh], ("data", "model"))
        for i, (cfg, shape) in enumerate(_collective_cases(archs)):
            want = trace_collectives(cfg, shape, m)
            assert want["total_bytes"] > 0
            for r in live:
                assert r[i] == want, (mesh, cfg.name, shape.kind, r[i], want)


def test_two_hybrid_train_steps_equal_world_one(runs):
    """2 AdamW steps of the zamba2 smoke on (2, 2) against the same steps
    on one process: loss, CE and grad_norm 1e-5 relative, both moments
    GRAD_REL of each leaf's largest, every parameter within 1e-5 of its
    leaf's largest |p| except where AdamW's eps makes an update jump
    (``tests/test_torch_dist.py``'s rule: second moment below (100
    eps)^2, at most 2 lr a step, at most one element in 10^4)."""
    cfg, batches = runs["train"]
    model = build_model(cfg, device="cpu")
    lm.load_jax_params(model, lm.pair("zamba2_1p2b")[1])
    step = lm.make_train_step(model, opt.AdamWConfig(**ADAMW))
    state = opt.init_state(step.params)
    want, low = [], {}
    for b in batches:
        want.append(step(state, {k: torch.as_tensor(v)
                                 for k, v in b.items()}))
        for name, v in flatten(state["nu"], ".").items():
            low[name] = torch.minimum(low.get(name, v), v).clone()
    outs = [r[len(FAMILIES)] for r in runs["22"]]
    for o in outs:
        for got, w in zip(o["metrics"], want):
            for k in ("loss", "ce", "grad_norm"):
                assert abs(got[k] / float(w[k]) - 1) <= 1e-5, (k, got, w)
    axes = W.param_axes_flat(model)
    for key in ("mu", "nu"):
        for name, m in flatten(state[key], ".").items():
            _close(W.assemble([o[key][name] for o in outs], axes[name],
                              tuple(m.shape), (2, 2)), m.numpy(), GRAD_REL)
    eps, loose, total = opt.AdamWConfig().eps, 0, 0
    for name, p in flatten(step.params, ".").items():
        p = p.detach().numpy()
        got = W.assemble([o["params"][name] for o in outs], axes[name],
                         p.shape, (2, 2))
        sharp = low[name].sqrt().numpy() >= 100 * eps
        err = np.abs(got - p)
        off = err > 1e-5 * np.abs(p).max()
        assert not (off & sharp).any(), name
        assert (err[off] <= 2 * ADAMW["lr"] * len(batches)).all(), name
        loose += int(off.sum())
        total += p.size
    assert loose <= 1e-4 * total, (loose, total)


# --- the kv_seq decode --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kv_reference(arch):
    """The reference's decode of ``_kv_seq_inputs``: each step's logits
    and the final cache (one device, the whole ring)."""
    jm, params, _ = lm.pair(arch)
    cache, steps = _kv_seq_inputs(arch, 40 + KV_SEQ_ARCHS.index(arch))
    jp = jax.tree.map(jnp.asarray, params)
    jc = jax.tree.map(jnp.asarray, cache)
    jstep = jax.jit(jm.decode_step)
    logits = []
    for tok, pos in steps:
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(pos)})
        logits.append(np.asarray(jl))
    return logits, jax.tree.map(np.asarray, jc)


@functools.lru_cache(maxsize=None)
def _kv_whole(arch):
    """The port's decode of ``_kv_seq_inputs`` on one process (the whole
    ring): each step's logits and the final cache."""
    cache, steps = _kv_seq_inputs(arch, 40 + KV_SEQ_ARCHS.index(arch))
    model = lm.pair(arch)[2]()
    c = tree_map(torch.tensor, cache)
    serve = make_serve_step(model, graphs=False)
    logits = []
    for tok, pos in steps:
        lg, c = serve(c, {"token": torch.as_tensor(tok),
                          "pos": torch.as_tensor(pos)})
        logits.append(lg.numpy())
    return logits, tree_map(lambda t: t.numpy(), c)


def _axes_leaves(axes):
    """The logical axes of a cache's leaves, in ``leaves`` order."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if all(isinstance(a, (str, type(None))) for a in axes):
        return [axes]
    return [a for t in axes for a in _axes_leaves(t)]


def _ring_collectives(arch):
    """A decode step's collectives over "data" under kv_seq: each ring
    layer's merge (one pmax, two psums); HSTU's sum of parts (one psum
    a layer)."""
    cfg = get_config(arch, smoke=True)
    if cfg.hstu:
        return cfg.n_layers
    if cfg.family == "hybrid":
        return 3 * (cfg.n_layers // cfg.attn_every)
    return 3 * cfg.n_layers


@pytest.mark.parametrize("arch", KV_SEQ_ARCHS)
def test_kv_seq_decode_matches_the_unsharded_decode(runs, arch):
    """(4, 1), B 1, a 65536-slot ring cut into 4 x 16384 by kv_seq: each
    step's logits on every rank against the port's one-process decode of
    the whole ring (2e-5 of the largest) and against the reference's
    (within the port's own unsharded gap to it plus 2e-5), the ring
    after the 4 steps put back together against the one-process ring
    (each slot written by its owner alone: the slots no step wrote keep
    their bits), one step's collectives (the ring merges) equal to the
    meta dry-run's."""
    outs = [r[KV_SEQ_ARCHS.index(arch)] for r in runs["41"]]
    ref_logits, _ = _kv_reference(arch)
    want_logits, want_cache = _kv_whole(arch)
    for o in outs:
        for got, w, ref in zip(o["logits"], want_logits, ref_logits):
            _close(got, w)
            scale = float(np.abs(ref).max())
            gap = float(np.abs(w - ref).max())
            assert float(np.abs(got - ref).max()) <= gap + REL * scale
    cfg = _tcfg(arch)
    model = build_model(cfg, device="meta")
    cache0, steps = runs["kv"][arch]
    axes = _axes_leaves(model.cache_axes(1, RING))
    parts = list(zip(*[leaves(o["cache"]) for o in outs]))
    ring_leaves = 0
    for part, w, ax, c0 in zip(parts, leaves(want_cache), axes,
                               leaves(cache0)):
        full = W.assemble(part, ax, w.shape, (4, 1),
                          overrides={"kv_seq": "data"})
        _close(full, w)
        if "kv_seq" in ax:
            ring_leaves += 1
            assert part[0].shape[2] == RING // 4
            written = np.zeros(w.shape[2], bool)
            for _, pos in steps:
                written[int(pos[0]) % RING] = True
            keep = np.moveaxis(full, 2, 0)[~written]
            assert np.array_equal(keep, np.moveaxis(c0, 2, 0)[~written]
                                  .astype(np.float64))
    assert ring_leaves == 2
    n = _ring_collectives(arch)
    for o in outs:
        assert o["tally"]["all-reduce"]["count"] == n, o["tally"]
        assert o["tally"] == outs[0]["tally"]
    want = trace_collectives(cfg, InputShape("d", RING, 1, "decode"),
                             make_mesh((4, 1), ("data", "model")),
                             {"kv_seq": "data"})
    assert outs[0]["tally"] == want


def test_decode_attn_lse_matches_logsumexp_and_the_oracle():
    """``decode_attn_plain(..., lse=True)``: the output of the call
    without it, bit for bit, and a log-sum-exp equal to
    ``torch.logsumexp`` of the scaled scores (float64) and to the JAX
    package's (``jax.nn.logsumexp``), at G 1 and 4, float32."""
    g = torch.Generator().manual_seed(3)
    for H, KV in ((4, 4), (8, 2)):
        q = torch.randn(2, H, 64, generator=g)
        k, v = (torch.randn(2, 300, KV, 64, generator=g) for _ in range(2))
        out, lse = dk.decode_attn_plain(q, k, v, lse=True)
        assert torch.equal(out, dk.decode_attn_plain(q, k, v))
        assert lse.shape == (2, H) and lse.dtype == torch.float32
        ke = k.double()[:, :, torch.arange(H) * KV // H]
        s = torch.einsum("bhd,bshd->bhs", q.double(), ke) / 8.0
        np.testing.assert_allclose(lse, torch.logsumexp(s, -1), rtol=1e-6)
        js = jnp.einsum("bhd,bshd->bhs", jnp.asarray(q.numpy()),
                        jnp.asarray(ke.float().numpy())) / 8.0
        np.testing.assert_allclose(lse, np.asarray(jax.nn.logsumexp(js, -1)),
                                   rtol=1e-6)


def test_ring_parts_merge_to_one_call():
    """A ring cut into 4 parts, one ``decode_attn_plain`` call with its
    lse each, merged as ``layers.merge_ring`` merges the ranks' parts
    (here outside any mesh: the max and sums over the parts by hand),
    equals one call over the whole ring within 2e-6 of the largest
    |out|; ``merge_ring`` outside a mesh is the identity."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, 8, 32, generator=g)
    k, v = (torch.randn(1, 4096, 2, 32, generator=g) for _ in range(2))
    whole = dk.decode_attn_plain(q, k, v)
    parts = [dk.decode_attn_plain(q, k[:, i:i + 1024], v[:, i:i + 1024],
                                  lse=True) for i in range(0, 4096, 1024)]
    lse = torch.stack([p[1] for p in parts])
    m = lse.amax(0)
    w = torch.exp(lse - m)
    merged = (torch.stack([p[0] for p in parts]) * w[..., None]).sum(0) \
        / w.sum(0)[..., None]
    _close(merged, whole, 2e-6)
    o, l = parts[0]
    assert torch.equal(merge_ring(o[:, None], l, "data")[:, 0], o)
