from perfbench import readers


def read(ctx):
    return readers.rounds(ctx)
