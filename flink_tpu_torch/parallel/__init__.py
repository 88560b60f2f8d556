"""Parallel execution over a mesh of shards: key-group sharding (the data
parallel axis), the keyBy exchange between shards (the shuffle), and
ring collectives.

Counterpart of `flink_tpu/parallel/`. Layering: `parallel` sits below the
runtime — it may import core, ops, state and config, never runtime, api,
table or scheduler (the planner it drives is imported inside the
constructor that needs it, as in the JAX package)."""
