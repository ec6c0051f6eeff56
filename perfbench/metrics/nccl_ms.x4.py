from perfbench import readers


def read(ctx):
    return readers.nccl_ms(ctx)
