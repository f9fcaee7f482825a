"""Share of the window's served requests answered from the fleet's result
cache (each ``Response.cached``); the fleet's own hit and miss counters
over the run are printed beside it."""


def read(record):
    n = record.get("cache_lookups")
    return record["cache_hits"] / n if n else None
