"""stage2_ms: milliseconds of stage2 (damping, assembly of the reduced
camera system, the preconditioner) per LM iteration: the linearizer's
prepare field, stage2_time for SQUARE_ROOT and prepare_time for the
Schur solvers (CUDA events at the stage boundaries)."""


def read(ctx):
    its = sum(s.lm_iterations for s in ctx.solves)
    total = sum(it.stage2_time_in_seconds + it.prepare_time_in_seconds
                for s in ctx.solves for it in s.summary.iterations[1:])
    return 1e3 * total / its if its else None
