"""Many graphs at once: the fleet solve (``sharded.optimize_batch``)."""
