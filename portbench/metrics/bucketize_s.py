"""bucketize_s: seconds per solve of `bucketize`, the program's
prep.bucketize span (bundle_adjust), over the untraced window of a
traced run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    return spans.seconds_per_solve(ctx, lambda n: n == "prep.bucketize")
