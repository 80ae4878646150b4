"""Placement rules of the port (``sharding``): the reference's partition
entries as data, and whole placement on the one card's (1, 1) mesh."""
from repro_torch.distributed.sharding import (
    dp_axes, param_shardings, opt_shardings, batch_shardings, cache_shardings,
    replicated, shard_bytes, place,
)
