"""Median latency of a fleet cell, timed from each request's due time: in
a Zipf mix most answers are cache hits paced by the host."""
import stats


def read(record):
    if not record.get("cache_lookups") or not record.get("latency_ms"):
        return None
    return stats.percentile(record["latency_ms"], 50)
