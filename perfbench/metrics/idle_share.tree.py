from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx)
