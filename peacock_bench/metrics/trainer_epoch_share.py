"""Share of the training window spent inside ``Trainer`` epochs: Σ of
``Trainer.metrics["epoch_s"]`` (host clock after a synchronize) over the
window; the rest is α steps, table rebuilds, callbacks and the loop."""


def read(record):
    if "epoch_s" not in record:
        return None
    return sum(record["epoch_s"]) / record["window_s"]
