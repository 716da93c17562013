"""The Newton-Schulz products' share of their roofline: their operations
(counts/pj_step.ns_flops, from shapes) over the peak of the
configuration's product, over the device time of every compute kernel
inside the ``pj_train_chunk_batch`` spans. The other work of a step
(gathers, the batch products, the chunk's eigendecomposition) is in the
time and not in the count, so the share is a floor."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.compute_s(run.trace.spans.get("pj_chunk", []))
    if busy <= 0 or run.work["ns_flops"] <= 0:
        return None
    return 100.0 * run.work["ns_flops"] / run.peak_flops / busy
