"""Deterministic placement ring shared (by construction) across router
replicas.

With N stateless router replicas behind one Service, per-replica affinity
dicts stop being a source of truth: replica A would pin a session to one
engine, replica B to another, and every failover or load-balancer reshuffle
would cold-start the session's KV. The fix is the reference stack's
(PAPER.md §data plane): make placement a *pure function of the discovered
backend set*, so every replica computes the same pick from the same
membership without exchanging a single byte of state.

``PlacementRing`` wraps the in-repo consistent-hash ring
(utils/hashring.py — the same structure SessionRouter already uses) with
the two key namespaces the routing ladder needs:

  * ``pick_session(session_id, candidates)``  — session→engine
  * ``pick_prefix(head_hash, candidates)``    — prefix→engine

Both accept a candidate subset and walk the FULL ring from the key's
position, returning the first candidate encountered — so restricting to
near-least-loaded engines (the load-margin guard below) keeps the mapping
deterministic AND keeps churn bounded: a key only moves when the node it
lands on leaves the candidate set.

``near_least_loaded`` is the bridge to the existing load-aware routers:
instead of "the one least-loaded engine" (a tie-broken, replica-local
answer), routers take "every engine within LOAD_MARGIN of the minimum
load" and let the ring pick deterministically among them. When load gaps
are large the candidate set collapses to the least-loaded engine and
behavior is exactly the pre-ring behavior; when engines are comparably
loaded, all replicas agree on the pick.

The port's copy of ``production_stack_tpu/router/ring.py``.
"""

from typing import Callable, Iterable, List, Optional, Sequence

from production_stack_tpu_torch.utils import HashRing

# An engine whose load score is within this margin of the fleet minimum is
# "comparably loaded": the ring — not replica-local tie-breaking — decides
# among such engines. Load scores are in [0, 1.3] (routing_logic
# _engine_load_score), so 0.1 ~ one queue-depth notch.
LOAD_MARGIN = 0.1


def near_least_loaded(
    urls: Iterable[str],
    load_fn: Callable[[str], float],
    margin: float = LOAD_MARGIN,
) -> List[str]:
    """URLs whose load is within ``margin`` of the minimum (sorted)."""
    urls = sorted(urls)
    if not urls:
        return []
    loads = {u: load_fn(u) for u in urls}
    floor = min(loads.values())
    return [u for u in urls if loads[u] <= floor + margin]


class PlacementRing:
    """Session→engine and prefix→engine placement, identical on every
    replica that has seen the same backend membership."""

    def __init__(self, vnodes: int = 160):
        self._ring = HashRing(vnodes=vnodes)

    @property
    def nodes(self) -> List[str]:
        return self._ring.nodes

    def sync(self, urls: Iterable[str]) -> None:
        """Reconcile ring membership to the discovered backend set.
        Diff-based under the hood: joining/leaving a node remaps only the
        keys whose ring successor changed (~1/N of the keyspace)."""
        self._ring.set_nodes(urls)

    def _pick(self, key: str,
              candidates: Optional[Sequence[str]]) -> Optional[str]:
        if candidates is None:
            return self._ring.get_node(key)
        return self._ring.get_node_among(key, candidates)

    def pick_session(self, session_id: str,
                     candidates: Optional[Sequence[str]] = None,
                     ) -> Optional[str]:
        # Namespaced so a session id and a prefix hash that happen to share
        # bytes don't collide onto correlated ring positions.
        return self._pick(f"s|{session_id}", candidates)

    def pick_prefix(self, head_hash: str,
                    candidates: Optional[Sequence[str]] = None,
                    ) -> Optional[str]:
        return self._pick(f"p|{head_hash}", candidates)

    def __len__(self) -> int:
        return len(self._ring)
