# Copied from src/repro/core/topology.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Two-level cluster topology: host -> instance, with an explicit
owner map (paper §3.3 at fleet scale; MTServe/xGR-style placement).

The relay race spans pipeline stages that land on different machines,
so placement is a *topology* concern, not a single in-process hash
ring.  This module models the fleet as

  * ``Host`` — one server: a set of special (cache-holding) and normal
    ranking instances plus the server-local DRAM tier they share.  A
    host carries a *role*: ``"rank"`` servers hold psi and serve
    ranking; ``"prefill"`` servers (the disaggregated-prefill
    deployment, ``ClusterConfig.prefill_hosts > 0``) run only the
    pre-infer side path and SHIP every psi they produce to the user's
    owning rank host — they never own keys, so the owner map spans
    rank hosts only;
  * ``OwnerMap`` — which host *owns* a user key, decided by rendezvous
    (highest-random-weight) hashing over the host set.  Rendezvous
    hashing gives the minimal-disruption property the rebalance
    protocol relies on: a join moves only the keys the new host wins,
    a leave moves only the departed host's keys, and nothing else
    reshuffles;
  * ``ClusterTopology`` — epoch-versioned membership.  Every
    join/leave bumps the epoch and produces a new authoritative owner
    map; each host additionally carries its *local view* of the map,
    which trails the authoritative one until the deterministic
    gossip-style convergence steps propagate it (``gossip_step`` /
    ``converge``).  Routers route on the authoritative map; the views
    exist so churn tests and the simulator can model the stale-routing
    window between a membership change and cluster-wide agreement.

Within the owning host, producer/consumer rendezvous still uses the
per-host consistent-hash ring over that host's special instances
(``repro_torch.core.router.AffinityRouter``).  With one host the owner map is
a constant function and the single ring is byte-identical to the
historical flat ring — ``hosts=1`` reproduces the single-process
deployment exactly (tests/test_topology.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional


def _h(data: str) -> int:
    """THE placement hash (8-byte sha256): the owner map, the per-host
    rings (repro_torch.core.router re-exports this) and the random-placement
    ablation all draw from this one function, so their rendezvous
    formulas can never diverge."""
    return int.from_bytes(hashlib.sha256(data.encode()).digest()[:8], "big")


@dataclasses.dataclass
class Host:
    """One server in the fleet: instance names grouped by pool."""
    name: str
    special: List[str] = dataclasses.field(default_factory=list)
    normal: List[str] = dataclasses.field(default_factory=list)
    # dedicated pre-infer engines (only on role="prefill" hosts)
    prefill: List[str] = dataclasses.field(default_factory=list)
    role: str = "rank"                   # "rank" | "prefill"

    @property
    def instances(self) -> List[str]:
        return list(self.special) + list(self.normal) + list(self.prefill)


def stripe_hosts(special: List[str], normal: List[str],
                 n_hosts: int) -> List[Host]:
    """Round-robin the instance pools over ``n_hosts`` servers (instance
    i lands on host i % n_hosts), so every host gets a share of both
    pools when the pools are at least as large as the host count."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    hosts = [Host(name=f"host-{k}") for k in range(n_hosts)]
    for i, s in enumerate(special):
        hosts[i % n_hosts].special.append(s)
    for i, n in enumerate(normal):
        hosts[i % n_hosts].normal.append(n)
    return hosts


def make_prefill_hosts(n_hosts: int) -> List[Host]:
    """Dedicated pre-infer servers for the disaggregated-prefill
    deployment: one pooled prefill engine per host (its ``m_slots``
    model the host's NPU concurrency).  They join the topology with
    ``role="prefill"`` so the owner map never hands them keys."""
    return [Host(name=f"prefill-host-{k}", role="prefill",
                 prefill=[f"prefill-{k}"]) for k in range(int(n_hosts))]


class OwnerMap:
    """Rendezvous hashing over a host set, stamped with the membership
    epoch it was derived from.  ``owner(key)`` is a pure function of
    (members, key): every process that agrees on the membership agrees
    on every owner with no coordination."""

    def __init__(self, hosts: Iterable[str] = (), epoch: int = 0):
        self.hosts: List[str] = list(hosts)
        self.epoch = int(epoch)

    def owner(self, key) -> str:
        if not self.hosts:
            raise RuntimeError("owner map has no hosts")
        return max(self.hosts, key=lambda h: _h(f"{h}|{key}"))

    def copy(self) -> "OwnerMap":
        return OwnerMap(self.hosts, self.epoch)

    def __eq__(self, other) -> bool:
        return (isinstance(other, OwnerMap) and self.epoch == other.epoch
                and self.hosts == other.hosts)

    def __repr__(self) -> str:
        return f"OwnerMap(epoch={self.epoch}, hosts={self.hosts})"


class ClusterTopology:
    """Epoch-versioned host membership with per-host gossip views.

    The authoritative ``owner_map`` advances atomically on join/leave;
    each host's local view (``views[host]``) is only refreshed when the
    membership change is seeded at that host or when a gossip step
    pulls a newer map from a peer.  ``converge()`` runs deterministic
    gossip rounds (every host pulls from its successor in sorted
    order) until all views agree — O(n) rounds worst case for a rumor
    seeded at one host, and the round count is what the churn tests
    assert on."""

    def __init__(self, hosts: List[Host]):
        if not hosts:
            raise ValueError("topology needs at least one host")
        self.hosts: "OrderedDict[str, Host]" = OrderedDict(
            (h.name, h) for h in hosts)
        if not self._rank_names():
            raise ValueError("topology needs at least one rank host")
        self.owner_map = OwnerMap(self._rank_names(), epoch=0)
        self.views: Dict[str, OwnerMap] = {
            name: self.owner_map.copy() for name in self.hosts}
        # departed-host registry (name -> epoch at leave): a host that
        # left stops owning keys immediately, but resources that hand
        # off LAZILY (its cold-tier namespace) stay addressable until
        # their last entry re-homes on touch — consumers use this to
        # tell "departed" apart from "never existed"
        self.departed: Dict[str, int] = {}
        self._instance_host: Dict[str, str] = {}
        for h in hosts:
            for inst in h.instances:
                self._instance_host[inst] = h.name

    def _rank_names(self) -> List[str]:
        """Key-owning membership: prefill hosts run the side path only —
        they never own a user's cache lifecycle."""
        return [n for n, h in self.hosts.items() if h.role != "prefill"]

    # --- lookups ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.owner_map.epoch

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def owner(self, key) -> Host:
        """Authoritative owning host for a user key."""
        return self.hosts[self.owner_map.owner(key)]

    def owner_in_view(self, viewer: str, key) -> str:
        """Owner according to ``viewer``'s possibly-stale local view —
        the host a router colocated with ``viewer`` would pick before
        gossip converges."""
        return self.views[viewer].owner(key)

    def host_of(self, instance: str) -> Optional[str]:
        return self._instance_host.get(instance)

    def all_special(self) -> List[str]:
        return [s for h in self.hosts.values() for s in h.special]

    def all_normal(self) -> List[str]:
        return [n for h in self.hosts.values() for n in h.normal]

    def all_prefill(self) -> List[str]:
        return [p for h in self.hosts.values() for p in h.prefill]

    # --- membership ---------------------------------------------------------

    def join(self, host: Host) -> None:
        """Add a host.  The new authoritative map (epoch + 1) is seeded
        at the joining host; every other view goes stale until gossip
        propagates it."""
        if host.name in self.hosts:
            raise ValueError(f"host {host.name!r} already in topology")
        self.hosts[host.name] = host
        for inst in host.instances:
            self._instance_host[inst] = host.name
        self.owner_map = OwnerMap(self._rank_names(), epoch=self.epoch + 1)
        self.views[host.name] = self.owner_map.copy()

    def leave(self, name: str) -> Host:
        """Remove a host.  The new map is seeded at the first surviving
        host (sorted order) — the rumor's deterministic origin."""
        if name not in self.hosts:
            raise KeyError(f"host {name!r} not in topology")
        if len(self.hosts) == 1:
            raise ValueError("cannot remove the last host")
        if self.hosts[name].role != "prefill" and len(self._rank_names()) == 1:
            raise ValueError("cannot remove the last rank host")
        host = self.hosts.pop(name)
        for inst in host.instances:
            self._instance_host.pop(inst, None)
        self.views.pop(name, None)
        self.owner_map = OwnerMap(self._rank_names(), epoch=self.epoch + 1)
        seed = sorted(self.hosts)[0]
        self.views[seed] = self.owner_map.copy()
        self.departed[name] = self.epoch
        return host

    def mark_departed(self, name: str) -> None:
        """Record a host as departed (idempotent; callers that remove
        hosts through a router wrapper rather than ``leave`` use this
        to keep the registry complete)."""
        self.departed.setdefault(name, self.epoch)

    def register_instance(self, instance: str, host: str,
                          special: bool) -> None:
        """Track an instance hot-added to an existing host (intra-host
        scale-up; the owner map is unaffected)."""
        h = self.hosts[host]
        (h.special if special else h.normal).append(instance)
        self._instance_host[instance] = host

    def unregister_instance(self, instance: str) -> None:
        host = self._instance_host.pop(instance, None)
        if host is not None and host in self.hosts:
            h = self.hosts[host]
            if instance in h.special:
                h.special.remove(instance)
            if instance in h.normal:
                h.normal.remove(instance)

    # --- gossip convergence --------------------------------------------------

    def converged(self) -> bool:
        return all(v == self.owner_map for v in self.views.values())

    def gossip_step(self) -> int:
        """One deterministic anti-entropy round: every host (sorted)
        pulls from its successor and keeps the newer map.  Returns the
        number of views that changed this round."""
        names = sorted(self.hosts)
        updated = 0
        fresh = {n: self.views[n] for n in names}
        for i, n in enumerate(names):
            peer = names[(i + 1) % len(names)]
            if fresh[peer].epoch > self.views[n].epoch:
                self.views[n] = fresh[peer].copy()
                updated += 1
        return updated

    def converge(self, max_rounds: int = 64) -> int:
        """Run gossip rounds until every view matches the authoritative
        map; returns the rounds taken (0 when already converged)."""
        rounds = 0
        while not self.converged():
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"gossip failed to converge in {max_rounds} rounds")
            if self.gossip_step() == 0:
                # no view holds the newest map (e.g. views were never
                # seeded): force-seed the deterministic origin
                self.views[sorted(self.hosts)[0]] = self.owner_map.copy()
        return rounds
