def read(ctx):
    """Peak device memory of the window's calls, largest over the ranks."""
    return ctx["peak_bytes"] / 2**30
