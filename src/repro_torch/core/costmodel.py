# Copied from src/repro/core/costmodel.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Analytic latency cost model for GR serving on an accelerator instance.

Used by (a) the sequence-aware trigger's risk test, (b) the discrete-
event cluster simulator, and (c) the benchmark harness when deriving
paper-figure curves.  Constants default to a production-mirror Ascend
910C-class instance and are calibrated so that the absolute numbers in
the paper's evaluation are reproduced (pre-inference ~35 ms at ~3.5K
tokens for the HSTU backbone; rank-on-cache < 10 ms at 512 candidates;
DRAM->HBM load < 20 ms at 15K-token caches; remote fetch 100s of times
local access).  See EXPERIMENTS.md §Calibration.

All returned latencies are in milliseconds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence

from repro_torch.models.config import ModelConfig

from .paging import ceil_div


def load_batch_calibration(path: str) -> Dict:
    """Load a measured batching-cost table written by
    ``benchmarks/calibrate.py``: per-(prefix-bucket, batch-depth)
    marginal-cost factors replacing the fixed ``batch_factor``.  Format:

        {"default": 0.2,
         "buckets": {"256": {"2": 0.18, "4": 0.21, "8": 0.24}, ...}}

    Keys are strings (JSON); values are the marginal cost of each
    non-dominant member as a fraction of the dominant member's solo
    latency.  A table written under ``--h2d`` additionally carries an
    ``"h2d"`` block — measured scatter-insert vs full-pool-reship
    bandwidths per (pool pages, inserted pages), consumed by
    ``GRCostModel.scatter_ms``.  Feed the result to
    ``GRCostModel.with_calibration``."""
    with open(path) as f:
        table = json.load(f)
    if "buckets" not in table:
        raise ValueError(f"{path}: not a batch-calibration table "
                         "(missing 'buckets')")
    return table


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    # effective sustained throughput for small-GR-model inference
    # (small matmuls at batch<=1k tokens reach ~<1% of peak cube FLOPs on
    # a 910C-class part; the default reproduces pre(2K) ~= 35 ms)
    eff_flops: float = 2.0e12          # FLOP/s sustained
    hbm_bw: float = 1.6e12             # B/s
    h2d_bw: float = 2.0e10             # B/s (PCIe/host-link, shared)
    net_bw: float = 1.25e9             # B/s cross-server (10 GbE share)
    net_rtt_ms: float = 2.0            # per remote fetch
    # Dedicated cross-host psi fabric (100 GbE-class share per host):
    # the provisioned background channel that rebalance migrations and
    # disaggregated-prefill psi shipping ride.  Distinct from net_bw —
    # invariant I1 forbids the *synchronous per-request* fetch over the
    # congested serving network; planned bulk transfers get the fat
    # link, and the runtime serializes concurrent transfers on each
    # host's link (NIC contention) rather than paying latency only.
    nic_bw: float = 1.25e10            # B/s per-host shipping fabric
    # Cold-tier store bandwidth (host-local NVMe SSD or a remote psi
    # store's per-host share): the third link class under the NIC.
    # Demotions (DRAM eviction -> cold) and promotions (cold -> DRAM
    # prefetch) serialize on each host's cold link exactly like
    # shipments serialize on its NIC — SSDs are not full duplex, so the
    # cold link is a single queue.  cold_rtt_ms models submission /
    # seek latency per I/O, analogous to net_rtt_ms per fabric hop.
    cold_bw: float = 6.0e9             # B/s host SSD / remote-store share
    cold_rtt_ms: float = 0.5           # per cold-store I/O
    host_feature_ms: float = 2.0       # CPU feature processing per request
    embed_bytes_per_token: int = 1024  # host->device embedding traffic


@dataclasses.dataclass(frozen=True)
class GRCostModel:
    cfg: ModelConfig
    hw: HardwareModel = HardwareModel()
    # Marginal cost of adding one request to a bucketed batched rank
    # launch, as a fraction of the dominant member's solo latency: small
    # GR matmuls leave most of the MXU idle, so co-scheduled requests
    # ride largely on the same pass (calibrated so an 8-deep batch costs
    # ~2.4x one request, mirroring the live ``batched`` executor).
    batch_factor: float = 0.2
    # Measured per-(bucket, batch) factor table from benchmarks/
    # calibrate.py (load_batch_calibration); None -> the fixed
    # batch_factor above.
    batch_calibration: Optional[Dict[str, Any]] = None

    def with_calibration(self, table) -> "GRCostModel":
        """Return a copy whose batched launch costs come from a measured
        table (``load_batch_calibration`` result or a path to one).
        A table with an ``"h2d"`` block also calibrates
        ``scatter_ms`` (measured host->device page-landing bandwidth)."""
        if isinstance(table, str):
            table = load_batch_calibration(table)
        return dataclasses.replace(self, batch_calibration=table)

    # ---- model primitives -------------------------------------------------
    def layer_param_flops(self) -> int:
        c = self.cfg
        if c.hstu:
            per = 4 * c.d_model * c.n_heads * c.head_dim \
                + c.n_heads * c.head_dim * c.d_model
        else:
            per = (2 * c.d_model * c.n_heads * c.head_dim
                   + 2 * c.d_model * c.n_kv_heads * c.head_dim
                   + 3 * c.d_model * c.d_ff)
        return 2 * per

    def forward_flops(self, n_tokens: int, n_ctx: int = None) -> float:
        """FLOPs for a forward pass of ``n_tokens`` attending to
        ``n_ctx`` context tokens (quadratic term)."""
        c = self.cfg
        n_ctx = n_ctx if n_ctx is not None else n_tokens
        lin = n_tokens * c.n_layers * self.layer_param_flops()
        attn = 4 * n_tokens * n_ctx * c.n_layers * c.n_heads * c.head_dim
        return lin + attn

    def kv_bytes(self, seq_len: int) -> int:
        c = self.cfg
        itemsize = 4 if c.dtype == "float32" else 2
        return 2 * c.n_layers * seq_len * c.n_heads * c.head_dim * itemsize

    # ---- serving-path latencies (ms) ---------------------------------------
    def h2d_ms(self, seq_len: int) -> float:
        bytes_ = seq_len * self.hw.embed_bytes_per_token
        return bytes_ / self.hw.h2d_bw * 1e3

    def pre_infer_ms(self, prefix_len: int, dim_scale: float = 1.0) -> float:
        """Pre-inference of the long-term prefix (relay-race side path)."""
        fl = self.forward_flops(prefix_len) * dim_scale
        return (fl / self.hw.eff_flops * 1e3
                + self.h2d_ms(prefix_len) + self.hw.host_feature_ms)

    def rank_on_cache_ms(self, prefix_len: int, incr_len: int,
                         n_items: int, dim_scale: float = 1.0) -> float:
        """Ranking that reuses cached psi: only incremental tokens +
        candidate items run, attending to the full context."""
        q = incr_len + n_items
        fl = self.forward_flops(q, n_ctx=prefix_len + q) * dim_scale
        return (fl / self.hw.eff_flops * 1e3
                + self.h2d_ms(q) + self.hw.host_feature_ms)

    def full_rank_ms(self, prefix_len: int, incr_len: int, n_items: int,
                     dim_scale: float = 1.0) -> float:
        """Baseline: the whole sequence on the ranking critical path."""
        n = prefix_len + incr_len + n_items
        fl = self.forward_flops(n) * dim_scale
        return (fl / self.hw.eff_flops * 1e3
                + self.h2d_ms(n) + self.hw.host_feature_ms)

    def _marginal_factor(self, bucket: Optional[int], n: int) -> float:
        """Per-member marginal batching cost: the measured table when
        one is loaded (nearest bucket at or above, deepest measured
        batch at or below), else the fixed ``batch_factor``."""
        cal = self.batch_calibration
        if cal is None or n <= 1:
            return self.batch_factor
        default = float(cal.get("default", self.batch_factor))
        buckets = cal.get("buckets") or {}
        if not buckets:
            return default
        keys = sorted(int(b) for b in buckets if buckets[b])
        if not keys:
            return default
        if bucket is None:
            bucket = keys[-1]
        b = next((k for k in keys if k >= int(bucket)), keys[-1])
        row = buckets[str(b)]
        depths = sorted(int(d) for d in row if int(d) <= n) or \
            [min(int(d) for d in row)]
        return float(row[str(depths[-1])])

    def batched_rank_ms(self, per_request_ms,
                        bucket: Optional[int] = None) -> float:
        """Wall time of one micro-batched launch whose members would
        individually cost ``per_request_ms`` — the sim-side mirror of the
        live ``batched`` executor (consumed by ``SimExecutor.rank_group``
        and ``pre_infer_group``).  Dominant member at full cost, the
        rest at the marginal factor (measured per (bucket, batch) when
        a calibration table is loaded, fixed ``batch_factor`` otherwise).
        """
        per = list(per_request_ms)
        if not per:
            return 0.0
        factor = self._marginal_factor(bucket, len(per))
        return max(per) * (1.0 + factor * (len(per) - 1))

    def dram_load_ms(self, prefix_len: int) -> float:
        """DRAM -> HBM reload of psi (expander hit) — one move on the
        unified ``"h2d"`` link class (``psi_transfer_ms``), so reloads
        and scatter-on-insert landings can never drift apart."""
        return self.psi_transfer_ms(prefix_len, link="h2d")

    def paged_load_ms(self, tokens: int, page_tokens: int) -> float:
        """DRAM -> HBM reload at page granularity: only the missing
        ``tokens`` move (a resumed partial reload passes the remainder,
        not the whole prefix), rounded up to whole pages — the
        last-page padding is the only over-transfer.  Same ``"h2d"``
        link class as ``dram_load_ms``."""
        if tokens <= 0:
            return 0.0
        pages = ceil_div(int(tokens), int(page_tokens))
        return self.psi_transfer_ms(pages * int(page_tokens), link="h2d")

    def scatter_ms(self, nbytes: int) -> float:
        """Host->device landing cost of freshly staged pool pages (the
        device pool's scatter-on-insert).  Uses the measured ``h2d``
        calibration (``benchmarks/calibrate.py --h2d`` via
        ``with_calibration``: effective scatter bandwidth including the
        per-call dispatch overhead) when loaded, else the raw
        ``hw.h2d_bw`` link class."""
        cal = (self.batch_calibration or {}).get("h2d") or {}
        bw = float(cal.get("scatter_bw", 0.0)) or self.hw.h2d_bw
        return max(int(nbytes), 0) / bw * 1e3

    def remote_fetch_ms(self, prefix_len: int) -> float:
        """Cross-server cache fetch — the path RelayGR's invariant I1
        forbids on the ranking critical path."""
        return (self.hw.net_rtt_ms
                + self.kv_bytes(prefix_len) / self.hw.net_bw * 1e3)

    # ---- off-critical-path psi transfers (NIC bandwidth model) -------------

    def link_occupancy_ms(self, nbytes: int, *, link: str = "nic") -> float:
        """Time one transfer *occupies* a host's link of the given
        bandwidth class — ``"nic"`` (shipping fabric), ``"cold"``
        (SSD / remote psi store) or ``"h2d"`` (the shared host->device
        link: DRAM->HBM reloads and scatter-on-insert page landings):
        the serialization term of a move.  The runtime's per-host link
        model charges this window against the involved links so
        concurrent shipments, migrations and cold-tier moves contend
        for bandwidth instead of overlapping for free; RTT is
        propagation and does not occupy the link."""
        bw = {"cold": self.hw.cold_bw,
              "h2d": self.hw.h2d_bw}.get(link, self.hw.nic_bw)
        return max(int(nbytes), 0) / bw * 1e3

    def psi_transfer_ms(self, prefix_len: int, *, cross_host: bool = True,
                        link: str = "nic") -> float:
        """THE pricing entry point for any psi that leaves its instance
        off the critical path — rebalance migrations (ownership
        handoff), disaggregated-prefill psi shipping, and cold-tier
        demotions/promotions all price through here, so the paths can
        never drift.  ``link="nic"`` (default): a cross-host move rides
        the dedicated shipping fabric (``hw.nic_bw`` + RTT); an
        intra-host move (ring change within one server) only re-crosses
        the local H2D/DRAM path.  ``link="cold"``: one cold-store I/O
        (DRAM <-> host SSD / remote store) — ``hw.cold_bw`` +
        submission latency; ``cross_host`` is ignored because a
        cross-host cold move composes this with a NIC leg.
        ``link="h2d"``: a host->device landing — DRAM->HBM reloads and
        the device pool's scatter-on-insert both ride the shared H2D
        link class (``hw.h2d_bw``), no fabric RTT; ``cross_host`` is
        ignored (the move is local by definition).  Never charged
        per-request: invariant I1 still forbids critical-path remote
        fetches (``remote_fetch_ms``)."""
        if link == "cold":
            return (self.hw.cold_rtt_ms
                    + self.link_occupancy_ms(self.kv_bytes(prefix_len),
                                             link="cold"))
        if link == "h2d" or not cross_host:
            return self.link_occupancy_ms(self.kv_bytes(prefix_len),
                                          link="h2d")
        return (self.hw.net_rtt_ms
                + self.link_occupancy_ms(self.kv_bytes(prefix_len)))

    def handoff_ms(self, prefix_len: int, cross_host: bool = True) -> float:
        """Back-compat alias: rebalance handoffs are priced by the
        unified ``psi_transfer_ms`` entry point."""
        return self.psi_transfer_ms(prefix_len, cross_host=cross_host)
