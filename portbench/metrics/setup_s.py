"""setup_s: seconds from the process's start until the measured window
opens: imports, the weights made on the device, quantization, building the
trainer, the cell's warm-up (and, in a checkout's first run, the kernels'
build)."""


def read(ctx):
    return ctx.setup_s
