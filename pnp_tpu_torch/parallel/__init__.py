"""Owner-partitioned multi-shard execution (port of ``pnp_tpu.parallel``):
the halo plan and its exchange (:mod:`.halo`), the distribution context
the distributed drivers run on (:mod:`.dist`). The K shards are a leading
batch axis of tensors on one device."""
