"""lsolve_iters: iterations of the reduced system's solver (CG, or the
power series' terms) per LM iteration, from the summaries'
linear_solver_iterations: the work the linear solve's time is spent
on."""


def read(ctx):
    its = sum(s.lm_iterations for s in ctx.solves)
    total = sum(it.linear_solver_iterations for s in ctx.solves
                for it in s.summary.iterations[1:])
    return total / its if its else None
