"""The durable plane of the port (mirrors :mod:`svoc_tpu.durability`).

Only the fault-point hook is ported so far (:mod:`.faultspace`); the WAL,
the chain log, reconciliation and recovery come with ROADMAP A11."""
