"""k1_roofline: K1's (csrc/fold.cu) share of its roofline over the
traced solves: the sum of its calls' least times (portbench.roofline,
from the shapes each call was given) over the sum of its device time in
the trace, in percent. Read only from a trace that holds exactly the
launches the wrapper counted and the calls the probe saw."""

from portbench.roofline import bound_s, k1_counts

KERNELS = {"outer81_fold": "outer81_fold_kernel"}


def install(ctx):
    from rootba_tpu_torch.ops import fold

    calls = ctx.probes.setdefault("outer81_fold", [])
    inner = fold.outer81_fold

    def probe(s1, s2, width):
        out = inner(s1, s2, width)
        if s1.is_cuda and s1.shape[0] // width > 0:
            calls.append((s1.shape[0], s1.shape[1], width,
                          s1.element_size()))
        return out

    fold.outer81_fold = probe


def read(ctx):
    tr = ctx.kernel_trace
    calls = ctx.probes.get("outer81_fold", [])
    name = KERNELS["outer81_fold"]
    if tr is None or not calls or tr.launches(name) != len(calls):
        return None
    least = sum(bound_s(*k1_counts(M, K9, W, size), size)
                for M, K9, W, size in calls)
    return 100.0 * least / tr.seconds(name)
