"""Process start to the first timed call: the tables made on the device,
quantized into the program's store, the traffic made, the warm-up."""


def read(ctx):
    return ctx.setup_s
