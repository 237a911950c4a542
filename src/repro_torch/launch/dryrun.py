"""Dry-run and sizing of every (architecture x input shape x mesh) step
(port of ``repro.launch.dryrun``).

For each combination this module:
  1. builds the model at full config on the ``meta`` device (shapes
     only: nothing is allocated or computed, on any device) and the
     step of the shape (``launch.steps.make_step``: train, prefill or
     decode);
  2. runs the step once under ``launch.flops.step_flops``: the global
     matmul and convolution FLOPs (the record's ``jaxpr_flops_global``,
     the reference's name, so ``benchmarks.roofline`` reads both);
  3. sizes it on each mesh under the partitioning rules
     (``models.partitioning``): the bytes one device holds of the
     step's arguments (parameters, optimizer state, batch, cache) and
     of the tensors it returns anew, as the reference reads them from
     XLA's ``memory_analysis``;
  4. counts the collectives of one device's step on each mesh
     (``collectives``, the reference's record layout: {kind: {"count",
     "bytes"}, "total_bytes"}): the step runs once more on meta, built
     from its rank's shards under a ``meta`` ``ProcessMesh`` at rank 0's
     coordinates and the record's rules (fsdp, ZeRO-2), and the mesh
     tallies every collective the model code calls
     (``models.partitioning``), the recompute of every checkpointed
     layer included;
  5. writes one JSON record per mesh into ``build/dryrun/``, read by
     ``repro_torch.benchmarks.roofline``.

The meshes are the reference's (16 x 16, 2 x 16 x 16) and one card
(1 x 1).  ``temp_size_in_bytes`` has no counterpart here and is null
with its reason (PyTorch has no compile-time temporary size;
``chip_smoke.py`` measures the card's peak).  Every record carries its
``collectives``: every family runs under the mesh, with fsdp (each
weight gathered over "data" where a layer reads it, its gradient
reduce-scattered) or ZeRO-2 (the moments' part updated, the parameters
all-gathered), and a long_500k decode with its ring's sequence sharded
over "data" (the reference's kv_seq rule).  The port's collectives are
all all-reduces (an all-gather is one over a zero-padded buffer, a
reduce-scatter one whose result the rank keeps a part of); XLA picks
its own (fused all-reduces, reduce-scatters), so the counts are held
against a closed form and the live run's tally
(``tests/test_torch_dryrun.py``, ``chip_smoke.py --phases dist``), not
against the reference's bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b \\
        --shape train_4k --mesh card

Failures are bugs: the run exits non-zero listing them.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from repro_torch.launch.mesh import (CHIP_HBM_BYTES, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.models.partitioning import Rules, device_bytes, is_spec

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# fsdp "auto": shard the weights over "data" (ZeRO-3) once a device's
# share of them would pass 25% of its HBM -- the reference's rule
# ("~25% of chip HBM", its 4e9 of a 16e9 TPU v5e) at the H100's 80 GB
FSDP_AUTO_SHARE = 0.25
FSDP_AUTO_BYTES = FSDP_AUTO_SHARE * CHIP_HBM_BYTES

MESHES = {"card": make_smoke_mesh, "single": make_production_mesh,
          "multi": lambda: make_production_mesh(multi_pod=True)}

TEMP_REASON = ("PyTorch has no compile-time temporary size; the card's "
               "peak (torch.cuda.max_memory_allocated) is measured by "
               "chip_smoke.py")


def trace_collectives(cfg, shape, mesh, overrides=None, fsdp: bool = False,
                      zero2: bool = False) -> dict:
    """The collectives of rank 0's step of ``shape`` (an ``InputShape``
    or its name) on ``mesh`` (a ``MeshShape``) for the model of ``cfg``
    (a ``ModelConfig`` or an arch id), under the rules with ``fsdp``
    and the step with ``zero2`` (``make_step``'s): the model built on
    meta from rank 0's shards under a ``meta`` ``ProcessMesh``, the step
    run once on rank 0's shards of its arguments, the mesh's tally by
    kind."""
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.launch.steps import local_inputs, make_step, step_inputs
    from repro_torch.models import build_model
    from repro_torch.models.partitioning import logical_rules

    shape = INPUT_SHAPES.get(shape, shape)
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    pm = ProcessMesh.meta(mesh.sizes, mesh.axis_names, rank=0)
    with logical_rules(pm, overrides, fsdp=fsdp):
        model = build_model(cfg, device="meta")
        fn, arg_specs, arg_axes = make_step(model, shape, zero2=zero2)
        fn(*step_inputs(shape, local_inputs(arg_specs, arg_axes), "meta"))
    return pm.collectives()


def _should_skip(cfg, shape):
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is full-attention with no sliding window "
                "(see DESIGN.md)")
    return None


def flops_method(cfg) -> str:
    """How ``jaxpr_flops_global`` was counted, named in the record."""
    if cfg.family == "ssm_rwkv6":
        return ("meta, every op as run; the WKV loop over time as one "
                "batched product of the loop's sizes "
                "(models.ssm._rwkv_wkv_meta)")
    return "meta, every op as run"


def _spec_of(t):
    return (tuple(t.shape), t.dtype)


def _new_outputs(out, args):
    """The step's output tree as (shape, dtype) specs, None where a leaf
    is an argument returned as it is (a cache written in place)."""
    import torch
    ids = set()

    def collect(x):
        if isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                collect(v)
        elif isinstance(x, torch.Tensor):
            ids.add(id(x))

    collect(args)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(walk(v) for v in x)
        if isinstance(x, torch.Tensor):
            return None if id(x) in ids else _spec_of(x)
        return None

    return walk(out)


def _out_axes(model, shape):
    """Logical axes of the step's outputs: logits (B, 1, Vp) and the
    cache (prefill, decode); a train step's metrics are scalars."""
    if shape.kind == "train":
        return None
    from repro_torch.launch.steps import cache_specs_and_axes
    _, c_axes = cache_specs_and_axes(model, shape.global_batch,
                                     shape.seq_len)
    return (("batch", None, "vocab"), c_axes)


def trace(arch: str, shape) -> dict:
    """Build ``arch`` at full config on meta, run the step of ``shape``
    (an ``InputShape`` or its name in ``INPUT_SHAPES``) once under the
    FLOP counter, and return what the per-mesh records need (specs,
    axes, FLOPs)."""
    from repro_torch.launch.flops import step_flops
    from repro_torch.launch.steps import make_step, step_inputs
    from repro_torch.models import build_model

    cfg = get_config(arch)
    shape = INPUT_SHAPES.get(shape, shape)
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    fn, arg_specs, arg_axes = make_step(model, shape)
    args = step_inputs(shape, arg_specs, "meta")
    out = []
    flops = step_flops(lambda *a: out.append(fn(*a)), args)
    return {"flops": flops, "trace_s": time.perf_counter() - t0,
            "arg_specs": arg_specs, "arg_axes": arg_axes,
            "out_specs": _new_outputs(out[0], args),
            "out_axes": _out_axes(model, shape)}


def _sum_bytes(axes, specs, rules, mesh) -> int:
    """Bytes one device holds of a (shape, dtype) tree under ``rules``;
    ``axes`` None replicates every leaf."""
    total = 0

    def one(ax, sd):
        nonlocal total
        if sd is not None:
            total += device_bytes(sd[0], sd[1], rules.spec(ax, sd[0]), mesh)

    def walk(ax, sd):
        if sd is None:
            return
        if is_spec(sd):
            one(ax if ax is not None else (None,) * len(sd[0]), sd)
        elif isinstance(sd, dict):
            for k in sd:
                walk(None if ax is None else ax[k], sd[k])
        else:
            for i, s in enumerate(sd):
                walk(None if ax is None else ax[i], s)

    walk(axes, specs)
    return total


def size_record(arch: str, shape, mesh_key: str, traced: dict,
                fsdp: str = "auto", overrides=None) -> dict:
    """One record: ``traced`` (from ``trace``) sized on a mesh.
    ``memory.argument_parts`` splits the arguments' bytes as the step
    takes them: the parameters, then (train) the optimizer state or
    (decode) the cache, then the batch."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES.get(shape, shape)
    mesh = MESHES[mesh_key]()
    zero2 = fsdp == "zero2"
    if fsdp == "auto":
        itemsize = 4 if cfg.dtype == "float32" else 2
        per_chip = cfg.param_count() * itemsize / mesh.shape["model"]
        use_fsdp = per_chip > FSDP_AUTO_BYTES
    else:
        use_fsdp = fsdp == "on"
    ovr = dict(overrides or {})
    if shape.kind == "decode" and shape.global_batch == 1:
        ovr.setdefault("kv_seq", "data")
    rules = Rules(mesh, ovr, fsdp=use_fsdp)
    coll = trace_collectives(cfg, shape, mesh, ovr, fsdp=use_fsdp,
                             zero2=zero2)
    arg_axes = traced["arg_axes"]
    if zero2 and shape.kind == "train":
        from repro_torch.training import optimizer as opt
        arg_axes = (arg_axes[0], opt.state_axes(arg_axes[0], zero2=True),
                    arg_axes[2])
    parts = [_sum_bytes(a, s, rules, mesh)
             for a, s in zip(arg_axes, traced["arg_specs"])]
    args_b = sum(parts)
    out_b = _sum_bytes(traced["out_axes"], traced["out_specs"], rules, mesh)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh.name,
        "params": cfg.param_count(), "status": "ok", "device": "meta",
        "fsdp": "zero2" if zero2 else bool(use_fsdp),
        "jaxpr_flops_global": float(traced["flops"]),
        "flops_method": flops_method(cfg),
        "trace_s": round(traced["trace_s"], 2),
        "memory": {"argument_size_in_bytes": args_b,
                   "argument_parts": parts,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": None,
                   "temp_reason": TEMP_REASON},
        "collectives": coll, "collectives_reason": None,
        "n_chips": mesh.size,
    }


def run_combo(arch: str, shape, mesh_keys, fsdp: str = "auto",
              overrides=None) -> list:
    """Every mesh's record of one arch x shape (an ``InputShape`` or its
    name): one trace, sized on each mesh (a skipped or failed
    combination gives one record a mesh)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES.get(shape, shape)
    skip = _should_skip(cfg, shape)
    if skip:
        return [{"arch": arch, "shape": shape.name,
                 "mesh": MESHES[m]().name, "params": cfg.param_count(),
                 "status": "skipped", "reason": skip} for m in mesh_keys]
    try:
        traced = trace(arch, shape)
        return [size_record(arch, shape, m, traced, fsdp, overrides)
                for m in mesh_keys]
    except Exception as e:
        return [{"arch": arch, "shape": shape.name,
                 "mesh": MESHES[m]().name, "status": "FAILED",
                 "error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc(limit=8)} for m in mesh_keys]


def run_all(combos, mesh_keys, fsdp: str = "auto", overrides=None,
            jobs: int = 1) -> list:
    """``run_combo`` of every (arch, shape) of ``combos``, in order;
    ``jobs`` > 1 traces that many at once, each in its own (spawned)
    process."""
    if jobs <= 1:
        return [run_combo(a, s, mesh_keys, fsdp, overrides)
                for a, s in combos]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = [pool.submit(run_combo, a, s, mesh_keys, fsdp, overrides)
                   for a, s in combos]
        return [f.result() for f in futures]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="all",
                    choices=["card", "single", "multi", "both", "all"],
                    help="card: 1 x 1; single: 16 x 16; multi: 2 x 16 x "
                         "16; both: single and multi (the reference's "
                         "default); all: every one")
    ap.add_argument("--fsdp", default="auto",
                    choices=["auto", "on", "off", "zero2"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--tag", default="baseline",
                    help="artifact tag (perf iterations use new tags)")
    ap.add_argument("--override", action="append", default=[],
                    help="logical=mesh axis rule override, e.g. kv_seq=data")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many combinations at once, each in "
                         "its own process")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    mesh_keys = {"card": ["card"], "single": ["single"], "multi": ["multi"],
                 "both": ["single", "multi"],
                 "all": ["card", "single", "multi"]}[args.mesh]
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = tuple(v.split(",")) if "," in v else v

    t0 = time.perf_counter()
    results = run_all([(a, s) for a in archs for s in shapes], mesh_keys,
                      args.fsdp, overrides, args.jobs)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for recs in results:
        for rec in recs:
            tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
            if rec["status"] == "FAILED":
                failures.append(tag)
            (outdir / f"{args.tag}__{tag}.json").write_text(
                json.dumps(rec, indent=1))
            mem = rec.get("memory", {})
            print(f"{rec['status']:8s} {tag:55s} "
                  f"trace={rec.get('trace_s', 0):6.2f}s "
                  f"GFLOPs={rec.get('jaxpr_flops_global', 0) / 1e9:14.1f} "
                  f"args/device={mem.get('argument_size_in_bytes', 0) / 1e9:9.3f}GB",
                  flush=True)
            if rec["status"] == "FAILED":
                print(rec["error"], flush=True)
    print(f"\n{sum(len(r) for r in results)} records in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        return 1
    print("\nall dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
