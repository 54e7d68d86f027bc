"""Worker-process half of the port's cross-process hostfile test.

Runs as a standalone process: opens the shared spool directory as one
independent worker of ``spark_rapids_tpu_torch``'s hostfile transport,
map-writes its deterministic slice of a two-column table as shards for
every reduce partition, commits its manifest and (given a rendezvous
address) announces the commit over the socket. The parent test then
fetches both workers' shards and checks the union row for row.

Usage:
    python torch_hostfile_worker.py <spool_dir> <tag> <worker_id> \
        <num_partitions> <rendezvous host:port | ->
"""

import os
import sys

# Runs as a bare script from anywhere: the repo root (two levels up) must
# be importable as the parent test process sees it.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def worker_rows(worker_id: str, partition: int):
    """The (key, value) rows this worker writes to one reduce partition:
    a pure function of (worker, partition), so the parent computes the
    expected union without any IPC."""
    w = int(worker_id[1:])          # "w0" -> 0
    keys = [partition * 100 + w * 10 + i for i in range(5)]
    vals = [k * 3 + 1 for k in keys]
    return keys, vals


def main() -> int:
    spool, tag, worker_id, n_parts_s, rv = sys.argv[1:6]
    n_parts = int(n_parts_s)

    import numpy as np

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.host import (
        HostBatch, HostColumn, host_to_device)
    from spark_rapids_tpu_torch.parallel.transport.hostfile import \
        HostFileTransport

    conf = C.TpuConf({
        C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: spool,
        C.SHUFFLE_TRANSPORT_HOSTFILE_WORKER_ID.key: worker_id,
        C.SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS.key:
            "" if rv == "-" else rv,
    })
    sess = HostFileTransport().open(conf, tag, n_parts, device="cpu")
    for p in range(n_parts):
        keys, vals = worker_rows(worker_id, p)
        hb = HostBatch(
            ("k", "v"),
            [HostColumn(dt.INT64, np.asarray(keys, np.int64),
                        np.ones(len(keys), bool)),
             HostColumn(dt.INT64, np.asarray(vals, np.int64),
                        np.ones(len(vals), bool))])
        sess.write_shard(p, host_to_device(hb, device="cpu"))
    sess.commit()
    print(f"worker {worker_id} committed {n_parts} partitions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
