def read(ctx):
    """Seconds from the start of the process to the first timed call."""
    return ctx["setup_s"]
