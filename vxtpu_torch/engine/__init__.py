"""Ray sharding and the masked train step's bounds pass."""
