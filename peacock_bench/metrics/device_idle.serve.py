"""Share of the traced serve window in which no kernel or copy ran on the
card: 1 − busy / window, the union of the device's activity from the
profiler's trace."""


def read(record):
    tr = record.get("trace")
    if tr is None or ("epoch_s" in record) != ("serve" == "train"):
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
