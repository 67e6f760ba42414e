"""Multi-shard execution (port of ``pnp_tpu.parallel``), in two layouts.
Owner-partitioned: the halo plan and its exchange (:mod:`.halo`) and the
distribution context the distributed drivers run on (:mod:`.dist`).
Element-sharded (:mod:`.sharding`): element tables split over the shards,
dof vectors whole, each scatter's partials summed; the single-device
driver's ``device_mesh``. Both take their layout from the multi-process
bring-up (:mod:`.distributed`): in one process the K shards are a leading
batch axis of tensors on one device; under P ranks each holds K / P of
them and the reads across shards become collectives."""
