"""lm_idle: the share of the traced solve's LM attempts (the union of
the program's lm.attempt spans) in which the card runs no kernel, copy
or set (torch.profiler), in percent. Like device_idle it reads the
solve under the profiler, which slows the launch-bound stages."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    traced = spans.records(ctx)[1]
    if traced is None or ctx.trace is None:
        return None
    attempts = spans.merged((s[1], s[2]) for solve in ctx.traced_solves
                            for s in spans.of_solve(traced[0], solve)
                            if s[0] == "lm.attempt")
    total = sum(b - a for a, b in attempts)
    if total <= 0:
        return None
    busy = spans.overlap_s(attempts, ctx.trace.busy_intervals())
    return 100.0 * (1.0 - busy / total)
