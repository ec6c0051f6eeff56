"""Training step functions of the port."""
