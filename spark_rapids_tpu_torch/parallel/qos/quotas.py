"""Per-tenant quotas (port of the JAX package's
``parallel/qos/quotas.py``).

A *tenant* is a serving-tier identity (one user, one client pool, one
product) named by ``spark.rapids.sql.scheduler.qos.tenant`` or the
``tenant=`` kwarg of ``DataFrame.collect`` / ``submit``. The tracker
holds three admission-time caps, all unlimited (0) by default:

- **In-flight queries** (``tenantMaxInFlight``): the tenant's running
  and queued queries, checked before a query enters the run queue.
- **Catalog bytes** (``tenantMaxCatalogBytes``): the sum of the
  tenant's active queries' owner-tagged catalog registrations
  (:meth:`BufferCatalog.owned_bytes`).
- **Kernel-cache entries** (``tenantMaxKernelCacheEntries``): compiled
  kernels owned by the tenant's query ids. The port compiles no kernel
  at query time and keeps no kernel cache (``ops/kernel_cache.py``), so
  a tenant owns zero entries and this cap never acts.

Pure bookkeeping: the QueryManager's lock covers every mutation.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

DEFAULT_TENANT = "default"


def resolve_tenant(name: Optional[str]) -> str:
    v = str(name).strip() if name else ""
    return v or DEFAULT_TENANT


class TenantQuotas:
    """In-flight reservations and owner attribution for one
    QueryManager."""

    def __init__(self):
        self._inflight: Dict[str, int] = {}
        self._qid_tenant: Dict[int, str] = {}

    # -- in-flight reservations ----------------------------------------------
    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def reserve(self, tenant: str) -> None:
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def release(self, tenant: str) -> None:
        n = self._inflight.get(tenant, 0) - 1
        if n <= 0:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = n

    # -- ownership attribution -----------------------------------------------
    def record_query(self, query_id: int, tenant: str) -> None:
        """Remember which tenant an issued query id belongs to."""
        self._qid_tenant[query_id] = tenant

    def tenant_of(self, query_id: Optional[int]) -> Optional[str]:
        if query_id is None:
            return None
        return self._qid_tenant.get(query_id)

    def query_ids(self, tenant: str) -> set:
        return {qid for qid, t in self._qid_tenant.items() if t == tenant}

    def prune(self, live_query_ids: Iterable) -> None:
        """Drop the attribution of ids not in ``live_query_ids`` (bounds
        the map)."""
        keep = set(live_query_ids)
        for qid in [q for q in self._qid_tenant if q not in keep]:
            self._qid_tenant.pop(qid, None)

    # -- catalog bytes -------------------------------------------------------
    @staticmethod
    def catalog_bytes(tickets) -> int:
        """Owner-tagged registered bytes across the given tickets'
        contexts (each admitted query owns its catalog; the owner tag is
        its query id)."""
        total = 0
        for t in tickets:
            ctx = getattr(t, "ctx", None)
            catalog = getattr(ctx, "_catalog", None)
            if catalog is None:
                continue
            owned = catalog.owned_bytes()
            total += owned.get(t.query_id, 0)
        return total

    # -- kernel-cache entries ------------------------------------------------
    def kernel_entries(self, tenant: str, owners: Dict) -> int:
        """How many kernel-cache entries the tenant's query ids own;
        ``owners`` maps a cache key to the query id that compiled it."""
        qids = self.query_ids(tenant)
        return sum(1 for qid in owners.values() if qid in qids)
