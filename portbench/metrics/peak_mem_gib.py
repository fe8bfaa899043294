"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window (the
peak is reset at its start), in GiB: whether a problem fits the card."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30
