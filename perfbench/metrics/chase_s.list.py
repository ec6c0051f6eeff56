from perfbench import readers


def read(ctx):
    return readers.chase_s(ctx)
