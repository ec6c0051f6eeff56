"""Run-time services of the port: fault tolerance (``fault_tolerance``)."""
