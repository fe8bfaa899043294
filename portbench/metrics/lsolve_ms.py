"""lsolve_ms: milliseconds of the reduced system's solve (pcg's loop,
the CG kernel K3, or the power series) per LM iteration, from the
summaries' solve_reduced_system_time (CUDA events)."""


def read(ctx):
    its = sum(s.lm_iterations for s in ctx.solves)
    total = sum(it.solve_reduced_system_time_in_seconds for s in ctx.solves
                for it in s.summary.iterations[1:])
    return 1e3 * total / its if its else None
