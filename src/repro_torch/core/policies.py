# Copied from src/repro/core/policies.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Pluggable policy registries for the relay-race runtime.

Serving-system papers (xGR, MTServe, ...) compare scheduling / admission
/ placement policies against one engine.  To reproduce such comparisons
the runtime resolves its three policy slots by name:

  * **trigger** — who gets a pre-infer signal (admission);
  * **router**  — where producer and consumer rendezvous (placement);
  * **expander** — what happens to psi after the HBM window (reuse tier).

Built-ins:

  trigger:  ``sequence-aware`` (paper Eqs. 1-3), ``admit-all``
            (unconditional pre-inference — the paper's §2.4 strawman),
            ``never`` (baseline: relay disabled at the admission level).
            Under disaggregated prefill (``ClusterConfig.prefill_hosts
            > 0``) ``make_trigger`` installs a shipping-cost estimator
            so the slack test prices the cross-host psi hop into
            admission.
  router:   ``affinity`` (consistent hashing on the user key, paper
            §3.3), ``random`` (placement ablation: producer/consumer
            miss each other).
  expander: ``dram`` (server-local DRAM reuse tier, paper §3.4).

Registering a policy is one decorator; selection is one string in
``ClusterConfig`` — scenario configs never import policy classes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .costmodel import GRCostModel
from .expander import DRAMExpander, ExpanderConfig
from .router import AffinityRouter, _h
from .topology import ClusterTopology
from .trigger import Decision, SequenceAwareTrigger, TriggerConfig
from .types import HASH_KEY, UserMeta

TRIGGER_POLICIES: Dict[str, Callable] = {}
ROUTER_POLICIES: Dict[str, Callable] = {}
EXPANDER_POLICIES: Dict[str, Callable] = {}


def _register(registry: Dict[str, Callable], name: str):
    def deco(obj):
        registry[name] = obj
        return obj

    return deco


def register_trigger(name: str):
    return _register(TRIGGER_POLICIES, name)


def register_router(name: str):
    return _register(ROUTER_POLICIES, name)


def register_expander(name: str):
    return _register(EXPANDER_POLICIES, name)


def _get(registry: Dict[str, Callable], kind: str, name: str) -> Callable:
    try:
        return registry[name]
    except KeyError:
        raise KeyError(f"unknown {kind} policy {name!r}; "
                       f"registered: {sorted(registry)}") from None


def make_trigger(name: str, cfg: TriggerConfig, cost: GRCostModel,
                 ship_ms=None):
    """Build a trigger policy.  ``ship_ms`` (an optional
    ``UserMeta -> ms`` estimator) is installed as the trigger's
    ``ship_estimator`` — the disaggregated-prefill runtime passes the
    cross-host psi shipping cost so the slack test prices the full
    side-path deadline (compute + shipment), not just the compute: a
    psi that lands after its rank request is useless, so admission
    must account for the hop."""
    trigger = _get(TRIGGER_POLICIES, "trigger", name)(cfg, cost)
    if ship_ms is not None:
        trigger.ship_estimator = ship_ms
    return trigger


def make_router(name: str, special: List[str], normal: List[str], *,
                seed: int = 0,
                topology: Optional[ClusterTopology] = None):
    return _get(ROUTER_POLICIES, "router", name)(special, normal, seed=seed,
                                                 topology=topology)


def make_expander(name: str, cfg: ExpanderConfig, tenant_quota=None):
    cls = _get(EXPANDER_POLICIES, "expander", name)
    if tenant_quota is not None:
        return cls(cfg, tenant_quota=tenant_quota)
    return cls(cfg)


def policy_names() -> Dict[str, List[str]]:
    return {"trigger": sorted(TRIGGER_POLICIES),
            "router": sorted(ROUTER_POLICIES),
            "expander": sorted(EXPANDER_POLICIES)}


# --- built-in triggers ---------------------------------------------------------

register_trigger("sequence-aware")(SequenceAwareTrigger)


@register_trigger("admit-all")
class AdmitAllTrigger(SequenceAwareTrigger):
    """Unconditional pre-inference (paper §2.4, challenge 3): every
    request gets the side-path signal, flooding the special pool with
    work for safe short-sequence users.  ``assess`` keeps the real risk
    test so routing decisions stay meaningful."""

    def admit(self, meta: UserMeta, instance: str, now: float) -> Decision:
        d = self.assess(meta)
        self.stats["admitted"] += 1
        # the REAL risk verdict rides along: rank-stage routing keys off
        # Decision.at_risk, and the ablation only floods admission —
        # hard-coding True here would silently turn every short-sequence
        # request into keyed special-pool traffic as well
        return Decision(True, d.at_risk, d.est_full_ms, "admit-all")


@register_trigger("never")
class NeverTrigger(SequenceAwareTrigger):
    """Admission-level baseline: no request ever pre-infers (the risk
    assessment still runs so long-sequence routing is unchanged)."""

    def admit(self, meta: UserMeta, instance: str, now: float) -> Decision:
        d = self.assess(meta)
        return Decision(False, d.at_risk, d.est_full_ms, "never-admit")


# --- built-in routers ---------------------------------------------------------


@register_router("affinity")
def _affinity_router(special: List[str], normal: List[str], *, seed: int = 0,
                     topology: Optional[ClusterTopology] = None
                     ) -> AffinityRouter:
    # user_hash on the normal pool = session affinity for unkeyed
    # traffic (the behaviour the cluster benchmarks are calibrated to)
    return AffinityRouter(special, normal, policy="user_hash",
                          topology=topology)


@register_router("affinity-rr")
def _affinity_rr_router(special: List[str], normal: List[str], *,
                        seed: int = 0,
                        topology: Optional[ClusterTopology] = None
                        ) -> AffinityRouter:
    return AffinityRouter(special, normal, policy="round_robin",
                          topology=topology)


@register_router("random")
class RandomSpecialRouter(AffinityRouter):
    """Placement ablation (paper Fig. 12 argument): keyed requests go to
    a *random* special instance, so the pre-infer producer and the
    ranking consumer rendezvous only by chance and ranking mostly falls
    back to full inference.

    Placement is a pure hash of (seed, stage, key) — NOT a stateful RNG
    re-rolled per call — so two processes replaying the same stream
    (or the live and sim adapters in a parity sweep) pick identical
    "random" instances, while the pre-infer and rank stages of one user
    still hash independently and rendezvous only with probability
    1/n_special."""

    def __init__(self, special: List[str], normal: List[str], *,
                 seed: int = 0,
                 topology: Optional[ClusterTopology] = None, **kw):
        # same normal-pool policy as "affinity" so the ablation varies
        # ONLY the special-pool placement
        kw.setdefault("policy", "user_hash")
        super().__init__(special, normal, topology=topology, **kw)
        self._seed = int(seed)

    def route(self, request) -> str:
        key = request.header.get(HASH_KEY)
        if key is not None:
            # the live topology, not a construction-time snapshot: host
            # churn must never leave departed instances routable
            specials = self.topology.all_special()
            if not specials:
                # churn emptied the special pool: degrade to the
                # normal-pool path (AffinityRouter's discipline) — there
                # is nobody left to rendezvous at, which must mean a
                # fallback rank, never a crash on the empty modulus
                return self.route_normal(request)
            self.stats["special"] += 1
            hv = _h(f"random:{self._seed}:{request.stage.value}:{key}")
            return specials[hv % len(specials)]
        return super().route(request)


# --- built-in expanders ---------------------------------------------------------

register_expander("dram")(DRAMExpander)


@register_expander("null")
class NullExpander(DRAMExpander):
    """No DRAM reuse tier: psi lives only in the HBM window (equivalent
    to a zero DRAM budget, kept as an explicit policy for ablations)."""

    def __init__(self, cfg: ExpanderConfig, tenant_quota=None):
        super().__init__(ExpanderConfig(
            dram_budget_bytes=0.0,
            max_reload_concurrency=cfg.max_reload_concurrency))

    def spill(self, entry) -> bool:
        return False
