"""Mean milliseconds of one ``write_rows`` call (one block's rows into the
Distance artifact), from the benchmark's spans inside the window."""


def read(run):
    spans = run.spans_in_window("write_rows")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
