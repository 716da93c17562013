"""A whole window's share of the card's peak: the work its entry counted
from shapes (the PJ steps' and validations' products, or stage 3's ring
distances), over the window's wall time and the peak of the
configuration's product."""


def read(run):
    if run.work["flops"] <= 0:
        return None
    return 100.0 * run.work["flops"] / run.window_s / run.peak_flops
