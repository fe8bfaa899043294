"""stage1_ms: milliseconds of stage1 (linearize, landmark QR or
scaling) per LM iteration, from the summaries' stage1_time (CUDA events
at the stage boundaries)."""


def read(ctx):
    its = sum(s.lm_iterations for s in ctx.solves)
    total = sum(it.stage1_time_in_seconds for s in ctx.solves
                for it in s.summary.iterations[1:])
    return 1e3 * total / its if its else None
