"""Mean real rows (queries, not padding) of the window's inference calls."""


def read(record):
    rows = record.get("batch_rows")
    return sum(rows) / len(rows) if rows else None
