from perfbench import readers


def read(ctx):
    return readers.tour_s(ctx)
