"""device_idle: the share of the traced window's wall in which the
card runs no kernel, copy or set (torch.profiler), in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
