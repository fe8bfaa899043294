"""lm_iter_ms: milliseconds per LM iteration, the summaries'
minimizer_time_in_seconds over their LM iterations (the LM driver's
host clock around synchronised attempts)."""


def read(ctx):
    its = sum(s.lm_iterations for s in ctx.solves)
    return 1e3 * sum(s.minimizer_s for s in ctx.solves) / its if its else None
