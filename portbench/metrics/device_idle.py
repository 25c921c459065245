"""device_idle.<cells>: the share of the profiled slice of the window in which
no kernel, copy or memset ran on the device."""

from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
