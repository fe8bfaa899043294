"""pair_slots_m: millions of pair slots, padding included, that one
assembly of the reduced camera system gathers and folds (the program's
counter rcs.pair_slots over its rcs.assemble count), over the untraced
window of a traced run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    window = spans.records(ctx)[0]
    if window is None:
        return None
    counters = window[1]
    if not counters.get("rcs.assemble") or "rcs.pair_slots" not in counters:
        return None
    return counters["rcs.pair_slots"] / counters["rcs.assemble"] / 1e6
