"""index_build_s: seconds per solve of the host index builds and their
uploads, the union of the program's prep.build.* spans wherever they
fall (the linearizer's build, and the camera CSR built on its first
access, inside the LM loop), over the untraced window of a traced
run."""

from portbench import spans

spans.begin()
install = spans.install


def read(ctx):
    return spans.seconds_per_solve(ctx,
                                   lambda n: n.startswith("prep.build."))
