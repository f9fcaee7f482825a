"""Mean time of a served batch: from the engine's inference call (the
harness's wrapper of ``TopicEngine._infer``) to the last of its
engine-level futures resolving, after the copy of its results to the
host. Batches called inside the window."""


def read(record):
    ms = record.get("batch_ms")
    return sum(ms) / len(ms) if ms else None
