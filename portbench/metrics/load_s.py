"""load_s: seconds of `load_normalized_bal_problem` per solve (harness
clock): the text load (native tokenizer), normalisation, perturbation
and depth filter."""


def read(ctx):
    return sum(s.load_s for s in ctx.solves) / len(ctx.solves)
