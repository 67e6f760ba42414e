"""Owner-partitioned multi-shard execution (port of ``pnp_tpu.parallel``):
the halo plan and its exchange (:mod:`.halo`), the distribution context
the distributed drivers run on (:mod:`.dist`) and the multi-process
bring-up (:mod:`.distributed`). In one process the K shards are a leading
batch axis of tensors on one device; under P ranks each holds K / P of
them and the reads across shards become collectives."""
