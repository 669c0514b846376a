"""Train step and host loop of the port (flat data-parallel path)."""
