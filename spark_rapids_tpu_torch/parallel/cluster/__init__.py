"""The distributed worker runtime's core (port of the JAX package's
``parallel/cluster/``).

N independent worker processes execute ONE query's stage DAG: the
driver-side coordinator (:mod:`coordinator`) partitions the DAG
(``parallel/stages.py``) into dispatchable stage tasks and assigns them,
locality-aware, to worker processes (:mod:`worker`) registered over the
rendezvous control plane; each worker executes its assigned stage and
publishes the stage output as owner-tagged shards through the hostfile
transport (exclusive-manifest mode) or the objectstore, where the driver
and the dependent stages fetch them. The coordinator journals its state
(:mod:`journal`) and replays it when made over the same directory.

``spark.rapids.sql.cluster.enabled=false`` (the default) leaves every
single-process path as it is: the hooks outside this package are a
``ctx.cache["cluster"]`` lookup in the exchange's session opener and
materializer, the broadcast cache's fetch / publish
(``parallel/broadcast_cache.py``), and the prepare / run / recompute /
reset / install / finish calls of the planner's recovery ladder, all of
which do nothing without the marker.

Not here yet: the driver as a client of a standalone coordinator
(``remote.py``) and the coordinator's own ``main``, the supervisor and
the autoscaler; ``cluster.coordinator.remote=true`` raises
``NotPortedError``.
"""

from spark_rapids_tpu_torch.parallel.cluster.coordinator import (  # noqa
    ClusterCoordinator, ClusterDispatchError, ClusterExecInfo, QueryRun,
    cluster_enabled, cluster_store_kind, dispatch_timeout_error,
    get_coordinator, maybe_prepare, merge_worker_reports,
    shutdown_coordinator, stage_plan)
from spark_rapids_tpu_torch.parallel.cluster.journal import (  # noqa: F401
    Journal, replay_state)
