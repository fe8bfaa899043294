"""parse_s: seconds per solve of the input's read and parse, the
program's load.parse span (load_normalized_bal_problem: the native
tokenizer and the BAL text's arrays), over the untraced window of a
traced run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    return spans.seconds_per_solve(ctx, lambda n: n == "load.parse")
