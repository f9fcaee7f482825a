"""Mean ``Trainer.metrics["epoch_s"]`` of the window's epochs, in ms: the
ring epoch of ``core/distributed.py`` alone (a ring of one device)."""


def read(record):
    if not record.get("epoch_s"):
        return None
    return 1e3 * sum(record["epoch_s"]) / len(record["epoch_s"])
