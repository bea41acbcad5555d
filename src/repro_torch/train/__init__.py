"""Training substrate: optimizer, data pipeline, checkpointing, loop."""
