"""Cost-aware admission policy (port of the JAX package's
``parallel/qos/admission.py``).

:class:`QosPolicy` is what a QoS-enabled QueryManager carries in place
of its FIFO waiter list: the WFQ run queue (``policy.py``), the
per-tenant quota tracker (``quotas.py``), and the admission-time checks
(tenant caps and the deadline test) that run BEFORE a query takes a
queue slot. All methods are called under the manager's lock.

Deadline-aware admission tests ``collect(timeout_ms=...)``'s deadline
against the plan's cost estimate: a query whose estimate (scaled by
``qos.deadlineSlack``) cannot fit is rejected at once (kind
``deadline-unmeetable``). The port has no cost model yet, so its queries
are un-priced and always pass, as the JAX package's do for a plan
without a file scan; the in-flight deadline timer is the backstop.
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.parallel.qos.policy import (WfqQueue,
                                                        parse_weights)
from spark_rapids_tpu_torch.parallel.qos.quotas import TenantQuotas


class QosPolicy:
    """Everything a QueryManager needs beyond FIFO, in one handle."""

    def __init__(self, weights_spec: str, starvation_bound: int):
        self.weights_spec = str(weights_spec)
        self.queue = WfqQueue(parse_weights(weights_spec), starvation_bound)
        self.quotas = TenantQuotas()

    @property
    def sig(self):
        """Structural identity for the idle-only manager resize."""
        return (self.weights_spec, self.queue.starvation_bound)

    def deadline_rejects(self, conf, cost_ms: Optional[float],
                         deadline_ms: Optional[float]) -> Optional[str]:
        """The rejection reason when the cost estimate cannot meet the
        deadline, else None. The manager carries a retry hint when only
        the slack broke the deadline (``cost_ms <= deadline_ms <
        cost_ms * slack``) and none when the raw estimate already
        exceeds it."""
        from spark_rapids_tpu_torch import config as C
        if deadline_ms is None or deadline_ms <= 0 or cost_ms is None:
            return None
        if not bool(conf.get(C.QOS_DEADLINE_ADMISSION)):
            return None
        slack = max(float(conf.get(C.QOS_DEADLINE_SLACK)), 0.0)
        est = cost_ms * slack
        if est > deadline_ms:
            return (f"deadline {deadline_ms:.0f}ms unmeetable: cost "
                    f"estimate {est:.0f}ms (qos.deadlineSlack applied)")
        return None

    def tenant_rejects(self, conf, tenant: str,
                       active_tickets) -> Optional[str]:
        """The rejection reason when the tenant is over an admission cap
        (in-flight queries or catalog bytes), else None."""
        from spark_rapids_tpu_torch import config as C
        cap = int(conf.get(C.QOS_TENANT_MAX_IN_FLIGHT))
        if cap > 0 and self.quotas.inflight(tenant) >= cap:
            return (f"tenant {tenant!r} at in-flight cap "
                    f"({self.quotas.inflight(tenant)}/{cap})")
        bcap = int(conf.get(C.QOS_TENANT_MAX_CATALOG_BYTES))
        if bcap > 0:
            mine = [t for t in active_tickets
                    if getattr(t, "tenant", None) == tenant]
            used = self.quotas.catalog_bytes(mine)
            if used >= bcap:
                return (f"tenant {tenant!r} at catalog-bytes cap "
                        f"({used}/{bcap} owner-tagged bytes)")
        return None

    def enforce_kernel_quota(self, conf, tenant: str) -> int:
        """The compile budget (``tenantMaxKernelCacheEntries``): the JAX
        package evicts the tenant's oldest kernel-cache entries down to
        the cap and returns how many went. The port keeps no kernel
        cache, so a tenant owns no entry under any cap: always 0."""
        return 0
