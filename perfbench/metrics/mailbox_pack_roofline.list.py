from perfbench import readers


def read(ctx):
    return readers.mailbox_pack_roofline(ctx)
