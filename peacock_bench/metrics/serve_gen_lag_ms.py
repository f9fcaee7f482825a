"""p99 of how late the benchmark's load generator submitted each request
of the window after it was due, in ms."""
import stats


def read(record):
    lag = record.get("gen_lag_ms")
    return stats.percentile(lag, 99) if lag else None
