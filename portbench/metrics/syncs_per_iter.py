"""syncs_per_iter: blocking device-to-host reads per LM iteration in the
minimizer: the program's sync.* counters over the untraced window of a
traced run, less the syncs that fall in its outermost load, prep or
post spans (none of today's), over the window's LM iterations."""

from portbench import spans

spans.begin()
install = spans.install
OUTSIDE = ("load.", "prep.", "post.")


def read(ctx):
    window = spans.records(ctx)[0]
    its = spans.lm_iterations(ctx)
    if window is None or not its:
        return None
    recorded, counters = window
    n = sum(v for k, v in counters.items() if spans.is_sync(k))
    if not n:
        return None
    n -= sum(spans.is_sync(s[0]) for s in spans.inside(
        recorded, lambda s: s[3] == 0 and s[0].startswith(OUTSIDE)))
    return n / its
