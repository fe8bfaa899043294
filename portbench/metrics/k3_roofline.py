"""k3_roofline: K3's (csrc/cg_dense.cu: the cluster, half or grid CG
kernel) share of its roofline over the traced solves: the sum of its
calls' least times on the real 9N rows for the CG iterations each call
ran (portbench.roofline) over the sum of its device time in the trace,
in percent. Read only from a trace that holds exactly the launches the
wrapper counted and the calls the probe saw."""

from portbench.roofline import bound_s, k3_counts

KERNELS = {"pcg_dense_cluster": "pcg_dense_cluster_kernel",
           "pcg_dense_half": "pcg_dense_half_kernel",
           "pcg_dense_grid": "pcg_dense_kernel"}


def install(ctx):
    from rootba_tpu_torch.ops import cg_dense

    calls = ctx.probes.setdefault("pcg_dense", [])
    inner = cg_dense._launch

    def probe(Hz, b2, Lp, N, **kw):
        x2, stats = inner(Hz, b2, Lp, N, **kw)
        calls.append((N, stats))
        return x2, stats

    cg_dense._launch = probe


def read(ctx):
    tr = ctx.kernel_trace
    calls = ctx.probes.get("pcg_dense", [])
    launched = sum(tr.launches(k) for k in KERNELS.values()) if tr else 0
    if tr is None or not calls or launched != len(calls):
        return None
    least = sum(bound_s(*k3_counts(N, int(stats[0])), 4)
                for N, stats in calls)
    return 100.0 * least / sum(tr.seconds(k) for k in KERNELS.values())
