"""The ring distances' share of their roofline: the least time the card
could take for the window's pairs (operations over the peak of the
configuration's product, or bytes over HBM bandwidth, whichever is
larger) over the device time of the compute kernels between the
window's block boundaries. Both counts come from shapes (counts/)."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.compute_s([run.trace.window])
    if busy <= 0 or run.work["flops"] <= 0:
        return None
    bound = max(run.work["flops"] / run.peak_flops,
                run.work["bytes"] / run.hbm_bytes_per_s)
    return 100.0 * bound / busy
