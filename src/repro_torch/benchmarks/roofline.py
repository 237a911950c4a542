"""Roofline analysis of the dry-run records (port of
``benchmarks/roofline.py``), priced with one NVIDIA H100's published
figures (``repro_torch.launch.mesh``).

Per (arch x shape x mesh) record of ``repro_torch.launch.dryrun``:

  compute    = FLOPs_per_device / peak_FLOPs(config dtype)   [s]
  memory     = HBM_bytes_per_device / HBM_bw                 [s]
  collective = collective_bytes_per_device / NVLink_bw       [s]

  * FLOPs: the step's matmul and convolution FLOPs counted on the meta
    device (``launch.flops.step_flops``), divided by the devices.  The
    peak is the config's type's: bf16 989e12 FLOP/s; float32 67e12
    FLOP/s (outside the tensor cores: the port keeps TF32 off).
  * HBM traffic proxy: argument + output bytes per device, plus twice a
    temporary size where a record has one (the reference's rule; a
    PyTorch record has none, so its proxy is a floor).
  * collective bytes: the ``total_bytes`` of the record's
    ``collectives`` (one device's all-reduces, as the dry-run tallies
    them), over one direction of NVLink 4 (450e9 B/s); null where the
    record's collectives are (a step the port does not run under a
    mesh yet).

Also reports MODEL_FLOPS = 6 N D (train) or 2 N_active tokens (serve)
and the usefulness ratio MODEL_FLOPS / counted FLOPs.  These are bounds
from arithmetic, not measurements.
"""

from __future__ import annotations

import glob
import json
import sys
from pathlib import Path
from typing import List

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, peak_flops
from repro_torch.models import INPUT_SHAPES, get_config

ARTIFACTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: shared + top_k experts only)."""
    n = cfg.param_count()
    if cfg.n_experts:
        d, de = cfg.d_model, cfg.d_expert
        routed_all = cfg.n_layers * cfg.n_experts * 3 * d * de
        routed_active = cfg.n_layers * cfg.top_k * 3 * d * de
        n = n - routed_all + routed_active
    return n


def model_flops(cfg, shape) -> float:
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    return 2.0 * n_act * shape.global_batch  # decode: one token/seq


def analyse_record(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    chips = rec.get("n_chips", 256)
    flops_chip = rec["jaxpr_flops_global"] / chips
    mem = rec.get("memory", {})
    traffic = (mem.get("argument_size_in_bytes", 0)
               + mem.get("output_size_in_bytes", 0)
               + 2 * (mem.get("temp_size_in_bytes") or 0))
    t_comp = flops_chip / peak_flops(cfg.dtype)
    t_mem = traffic / HBM_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem}
    coll = (rec.get("collectives") or {}).get("total_bytes")
    if coll is not None:
        terms["collective_s"] = coll / NVLINK_BW
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "collective_s": None,
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_global": rec["jaxpr_flops_global"],
        "useful_ratio": round(mf / max(rec["jaxpr_flops_global"], 1), 3),
        "hbm_bytes_chip": traffic,
        "coll_bytes_chip": coll,
        "roofline_bound_s": round(max(terms.values()), 6),
        "fsdp": rec.get("fsdp", False),
    }


def load(tag: str = "baseline", mesh: str = "16x16") -> List[dict]:
    """The analysed ``status == ok`` records of ``tag`` on ``mesh``
    (every mesh for a false ``mesh``); [] where the dry-run wrote none."""
    rows = []
    for path in sorted(glob.glob(str(ARTIFACTS / f"{tag}__*.json"))):
        rec = json.loads(Path(path).read_text())
        if rec.get("status") != "ok":
            continue
        if mesh and rec.get("mesh") != mesh:
            continue
        rows.append(analyse_record(rec))
    return rows


def table(rows: List[dict]) -> str:
    hdr = ("arch", "shape", "compute_s", "memory_s", "collective_s",
           "dominant", "useful_ratio")
    lines = [" | ".join(hdr), " | ".join("---" for _ in hdr)]
    for r in rows:
        lines.append(" | ".join(str(r[h]) for h in hdr))
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "baseline"
    rows = load(tag=tag)
    print("arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
          "useful_ratio,roofline_bound_s")
    for r in rows:
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['compute_s']},"
              f"{r['memory_s']},{r['collective_s']},{r['dominant']},"
              f"{r['useful_ratio']},{r['roofline_bound_s']}")
    out = ARTIFACTS.parent / f"roofline_{tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"\nwrote {out}", flush=True)


if __name__ == "__main__":
    main()
