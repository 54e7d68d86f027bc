"""The memory tier (port of the JAX package's ``memory/``): the tiered
device -> host -> disk buffer catalog and its spillable handles
(``stores.py``), the OOM escalation ladder (``oom.py``), the LZ4 codec
of the disk tier (``compression.py``) and the native spill file
(``native.py``)."""

from spark_rapids_tpu_torch.memory.stores import (    # noqa: F401
    PRIORITY_ACTIVE_INPUT, PRIORITY_BROADCAST, PRIORITY_DEFAULT,
    PRIORITY_SHUFFLE_OUTPUT, BufferCatalog, SpillableBatch, StorageTier)
