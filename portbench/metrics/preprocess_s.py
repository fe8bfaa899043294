"""preprocess_s: seconds per solve of the loaded problem's
preprocessing, the program's load.normalize, load.perturb and
load.filter spans (load_normalized_bal_problem), over the untraced
window of a traced run."""

from portbench import spans

spans.begin()
install = spans.install
STEPS = ("load.normalize", "load.perturb", "load.filter")


def read(ctx):
    return spans.seconds_per_solve(ctx, lambda n: n in STEPS)
