"""host_prep_s: seconds per solve of `bundle_adjust` outside its
minimizer (its wall on the harness clock less the summary's
minimizer_time_in_seconds): bucketing, the linearizer's index builds,
the upload, and the solution's copy back to host memory."""


def read(ctx):
    return (sum(s.bundle_adjust_s - s.minimizer_s for s in ctx.solves)
            / len(ctx.solves))
