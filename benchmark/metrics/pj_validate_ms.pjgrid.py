"""Mean milliseconds of one ``pj_validate`` call, from the benchmark's
span around it (synchronised with the device in the traced run)."""


def read(run):
    spans = run.spans_in_window("pj_validate")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
