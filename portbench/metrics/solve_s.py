"""solve_s: seconds per whole solve, the window's wall clock (harness
clock) over the solves it completed: a `bal` user's time to solution,
from the BAL text file to the solution in host memory."""


def read(ctx):
    return ctx.window_s / len(ctx.solves)
