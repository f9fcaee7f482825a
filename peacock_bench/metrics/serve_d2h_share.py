"""Device-to-host copy time over device busy time in the traced serving
window (the profiler's ``Memcpy DtoH`` activity: the engines' copies of
pkd, ids and weights)."""


def read(record):
    tr = record.get("trace")
    if tr is None or "batch_ms" not in record or tr["busy_s"] <= 0:
        return None
    d2h = sum(v for k, v in tr["ops"].items() if "DtoH" in k)
    return d2h / tr["busy_s"]
