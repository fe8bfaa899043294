"""assemble_ms: device milliseconds per LM iteration of the reduced
camera system's assembly inside stage2 (the program's rcs.assemble
timer: CUDA events around flat_assemble_rcs, or flat_assemble_rcs_bsr
and the BSR table, read after each attempt's sync; counter
rcs.assemble_s), over the untraced window of a traced run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    window = spans.records(ctx)[0]
    its = spans.lm_iterations(ctx)
    if window is None or not its or "rcs.assemble_s" not in window[1]:
        return None
    return 1e3 * window[1]["rcs.assemble_s"] / its
