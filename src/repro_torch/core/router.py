# Copied from src/repro/core/router.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Affinity-aware router (paper §3.3), fleet-scale (two-level).

Converts late-binding placement into an early-binding contract: the
auxiliary pre-infer signal and the eventual ranking request for the same
user both carry ``consistency-hash-key: userID``.  Routing resolves the
key in two levels:

  1. **host** — the owner map (rendezvous hashing over the host set,
     ``repro_torch.core.topology``) names the one server that owns this
     user's cache lifecycle;
  2. **instance** — the owning host's consistent-hash ring over *its*
     special instances picks the rendezvous instance.

Producer and consumer therefore meet at the same instance on the same
host with no coordination, across however many servers the fleet spans.
With a single host the owner map is constant and the per-host ring is
byte-identical to the historical flat ring, so ``hosts=1`` reproduces
the single-process router exactly.

Requests without the key (normal, short-sequence traffic) fall back to
standard policies (round-robin / least-connections / user-hash) inside
the owning host's normal pool.

Disaggregated prefill splits the rendezvous: when the topology carries
dedicated ``role="prefill"`` hosts, keyed PRE-INFER signals route to a
prefill engine (``route_pre``) while the eventual ranking request still
lands on the psi's owning rank host — the runtime ships the produced
psi cross-host to close the loop.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from .topology import ClusterTopology, Host, _h, stripe_hosts
from .types import HASH_KEY, Request, Stage


class ConsistentHashRing:
    def __init__(self, nodes: Optional[List[str]] = None, vnodes: int = 128):
        self.vnodes = vnodes
        self._ring: List[int] = []
        self._owner: Dict[int, str] = {}
        self.nodes: List[str] = []
        for n in nodes or []:
            self.add(n)

    def add(self, node: str):
        if node in self.nodes:
            return
        self.nodes.append(node)
        for v in range(self.vnodes):
            hv = _h(f"{node}#{v}")
            idx = bisect.bisect(self._ring, hv)
            self._ring.insert(idx, hv)
            self._owner[hv] = node

    def remove(self, node: str):
        if node not in self.nodes:
            return
        self.nodes.remove(node)
        self._ring = [hv for hv in self._ring if self._owner[hv] != node]
        self._owner = {hv: n for hv, n in self._owner.items() if n != node}

    def route(self, key) -> str:
        if not self._ring:
            raise RuntimeError("no nodes on the ring")
        hv = _h(str(key))
        idx = bisect.bisect(self._ring, hv) % len(self._ring)
        return self._owner[self._ring[idx]]


class AffinityRouter:
    """Two-tier, two-level routing.

    Keyed (special-pool) traffic: owner map -> owning host -> that
    host's consistent-hash ring over its special instances.  Unkeyed
    (normal-pool) traffic: owner map -> owning host -> a standard LB
    policy over the host's normal pool — ``round_robin``,
    ``least_connections`` or ``user_hash`` (session affinity: the same
    user keeps landing on the same normal instance, which is what
    production gateways do for feature-cache locality and what the
    cluster benchmarks are calibrated against).

    Construct from flat pools (a single implicit host — the historical
    deployment) or pass an explicit ``topology``."""

    def __init__(self, special: List[str], normal: List[str],
                 policy: str = "round_robin", vnodes: int = 128,
                 topology: Optional[ClusterTopology] = None):
        if topology is None:
            topology = ClusterTopology(
                stripe_hosts(list(special), list(normal), 1))
        self.topology = topology
        self.vnodes = vnodes
        self.policy = policy
        self.rings: Dict[str, ConsistentHashRing] = {
            name: ConsistentHashRing(host.special, vnodes=vnodes)
            for name, host in topology.hosts.items()}
        self._rr: Dict[str, int] = {name: 0 for name in topology.hosts}
        self._load: Dict[str, int] = {n: 0 for n in topology.all_normal()}
        self.stats = {"special": 0, "normal": 0, "prefill": 0}

    # --- single-host compatibility surface -----------------------------------

    @property
    def ring(self) -> ConsistentHashRing:
        """THE ring of the historical flat deployment.  Only meaningful
        with one host; multi-host callers must go through
        ``route_key`` / ``rings``."""
        if self.topology.n_hosts != 1:
            raise AttributeError(
                "router spans multiple hosts; use route_key()/rings")
        return next(iter(self.rings.values()))

    @property
    def normal(self) -> List[str]:
        return self.topology.all_normal()

    # --- routing -------------------------------------------------------------

    def route_key(self, key) -> str:
        """Resolve a user key: owning host, then that host's ring.  A
        host with no special instances (possible when the special pool
        is smaller than the host count) never owns keys — rendezvous
        re-runs over the special-bearing hosts, deterministically."""
        host = self.topology.owner(key)
        ring = self.rings.get(host.name)
        if ring is None or not ring.nodes:
            candidates = [n for n in self.topology.hosts
                          if self.rings[n].nodes]
            if not candidates:
                raise RuntimeError("no special instances on any host")
            name = max(candidates, key=lambda h: _h(f"{h}|{key}"))
            ring = self.rings[name]
        return ring.route(key)

    def route_pre(self, key) -> str:
        """Pre-infer signal placement.  Disaggregated deployments
        (topology carries ``role="prefill"`` hosts) rendezvous-hash the
        key over the dedicated prefill engines — deterministic and
        balanced, and deliberately NOT the owner ring: the producer
        computes on a prefill host and SHIPS psi to the owner at
        completion.  Co-located deployments fall back to the owner
        instance (producer and consumer share it)."""
        pool = self.topology.all_prefill()
        if not pool:
            return self.route_key(key)
        return max(pool, key=lambda p: _h(f"pre|{p}|{key}"))

    def route(self, request: Request) -> str:
        key = request.header.get(HASH_KEY)
        if (request.stage == Stage.PRE_INFER and key is not None
                and self.topology.all_prefill()):
            self.stats["prefill"] += 1
            return self.route_pre(key)
        if key is not None:
            self.stats["special"] += 1
            return self.route_key(key)
        return self.route_normal(request)

    def route_normal(self, request: Request) -> str:
        """The normal-pool LB path: unkeyed traffic, and the
        degradation target when churn leaves no special instance for
        keyed traffic to rendezvous at."""
        self.stats["normal"] += 1
        host = self.topology.owner(request.user.user_id)
        pool = host.normal or self.topology.all_normal()
        if self.policy == "user_hash":
            return pool[request.user.user_id % len(pool)]
        if self.policy == "least_connections" and self._load:
            node = min(pool, key=lambda n: self._load.get(n, 0))
            self._load[node] = self._load.get(node, 0) + 1
            return node
        node = pool[self._rr[host.name] % len(pool)]
        self._rr[host.name] += 1
        return node

    def release(self, node: str):
        if node in self._load:
            self._load[node] = max(0, self._load[node] - 1)

    # --- instance churn (affinity disruption -> fallback, not an error) -------

    def add_special(self, node: str, host: Optional[str] = None):
        """Hot-add a special instance.  Without an explicit host it
        joins the host with the fewest specials (deterministic
        tie-break: topology order) — the single-host case degenerates
        to the historical flat-ring add."""
        if host is None:
            host = min(self.topology.hosts,
                       key=lambda n: len(self.topology.hosts[n].special))
        if node not in self.topology.hosts[host].special:
            self.topology.register_instance(node, host, special=True)
        self.rings[host].add(node)

    def remove_special(self, node: str):
        host = self.topology.host_of(node)
        if host is None:
            return
        self.topology.unregister_instance(node)
        if host in self.rings:
            self.rings[host].remove(node)

    # --- host churn (owner-map epoch bumps; runtime performs the handoff) -----

    def add_host(self, host: Host) -> None:
        self.topology.join(host)
        self.rings[host.name] = ConsistentHashRing(host.special,
                                                   vnodes=self.vnodes)
        self._rr[host.name] = 0
        for n in host.normal:
            self._load.setdefault(n, 0)

    def remove_host(self, name: str) -> Host:
        host = self.topology.leave(name)
        self.rings.pop(name, None)
        self._rr.pop(name, None)
        for n in host.normal:
            self._load.pop(n, None)
        return host
