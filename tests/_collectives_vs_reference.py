"""The collectives of one device's step, the reference's beside the port's,
at smoke size on a (2, 2) mesh (data, model), fsdp off:

* the reference: its step (``repro.launch.steps.make_step``) compiled
  under ``logical_rules(mesh)`` with its ``in_shardings`` on 4 forced
  host devices, the partitioned HLO's collectives counted by its own
  ``repro.launch.dryrun._parse_collectives`` (output bytes of every
  all-gather / all-reduce / reduce-scatter / all-to-all /
  collective-permute, fused ones as XLA fused them);
* the port: ``repro_torch.launch.dryrun.trace_collectives`` (rank 0 on
  the meta device under a meta ``ProcessMesh``).

XLA chooses its own collectives (reduce-scatters, fused all-reduces),
so the two are set side by side, not held equal.

    PYTHONPATH=src python tests/_collectives_vs_reference.py
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402

import jax  # noqa: E402

ARCHS = ("hstu_gr", "qwen3_4b", "deepseek_moe_16b")
B, S = 4, 64


def reference(arch, shape, mesh):
    from repro.launch.dryrun import _parse_collectives
    from repro.launch.steps import make_step
    from repro.models import build_model, get_config
    from repro.models.partitioning import logical_rules
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg)
    with logical_rules(mesh) as rules:
        fn, sds, axes = make_step(model, shape)
        shard = jax.tree.map(
            lambda ax, s: jax.NamedSharding(mesh, rules.spec(ax, s.shape)),
            axes, sds, is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x))
        with mesh:
            hlo = jax.jit(fn, in_shardings=shard).lower(*sds).compile()
    return _parse_collectives(hlo.as_text())


def port(arch, shape):
    from repro_torch.launch.dryrun import trace_collectives
    from repro_torch.models import get_config
    from repro_torch.models.config import InputShape
    from repro_torch.models.partitioning import make_mesh
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return trace_collectives(cfg, InputShape(shape.name, shape.seq_len,
                                             shape.global_batch, shape.kind),
                             make_mesh((2, 2), ("data", "model")))


def _cell(rec):
    return ", ".join(f"{k} {v['count']} / {v['bytes']} B"
                     for k, v in rec.items()
                     if isinstance(v, dict) and v["count"]) or "none"


def main():
    from repro.models.config import InputShape
    assert len(jax.devices()) == 4, jax.devices()
    # Auto axes: the reference's constrain calls with_sharding_constraint
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    print(f"smoke configs in float32, B {B} x S {S}, (data 2, model 2); "
          f"count / output bytes by kind, one device")
    print("| arch | step | reference (XLA) | total | port | total |")
    print("|---|---|---|---|---|---|")
    for arch in ARCHS:
        for kind in ("train", "prefill", "decode"):
            shape = InputShape(kind, S, B, kind)
            ref, own = reference(arch, shape, mesh), port(arch, shape)
            print(f"| {arch} | {kind} | {_cell(ref)} | {ref['total_bytes']} "
                  f"| {_cell(own)} | {own['total_bytes']} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
