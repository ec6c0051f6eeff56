def read(ctx):
    """Units ranked in the window's whole calls over its seconds."""
    return ctx["units"] * ctx["calls"] / ctx["window_s"]
