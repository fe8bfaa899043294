"""sync_wait_ms: milliseconds per LM iteration that the host spends
blocked on device-to-host reads inside LM attempts: the program's
sync.* spans that lie inside its lm.attempt spans, over the untraced
window of a traced run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    window = spans.records(ctx)[0]
    its = spans.lm_iterations(ctx)
    if window is None or not its:
        return None
    waits = [(s[1], s[2]) for s in spans.inside(window[0],
                                                lambda s: s[0] == "lm.attempt")
             if spans.is_sync(s[0])]
    if not waits:
        return None
    return 1e3 * spans.union_s(waits) / its
