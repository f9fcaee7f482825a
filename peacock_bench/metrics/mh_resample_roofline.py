"""mh_resample's device time against its bound: per launch the tokens' own
bytes, the pair table and the [K] vectors once (``peaks.mh_fixed_bytes``)
plus 32 B for each distinct 32-byte sector of the [rows, K] tables that the
chain reads, as the reference's chain over the window's last epoch counts
them; or ``peaks.mh_ops``. Every launch of the window is charged that
epoch's count. In %."""
import peaks


def read(record):
    tr = record.get("trace")
    if record.get("sampler") != "alias" or tr is None or not record.get("mh_sector_bytes"):
        return None
    kernel_s = sum(v for k, v in tr["ops"].items() if "mh_resample" in k)
    if kernel_s <= 0:
        return None
    T, K = record["tokens"], record["K"]
    b = peaks.mh_fixed_bytes(T, record["n_docs"], record["doc_cap"], K) + record["mh_sector_bytes"]
    least, _ = peaks.bound(b, peaks.mh_ops(T, record["doc_cap"], record["n_mh"]))
    return 100.0 * record["epochs"] * record["packages"] * least / kernel_s
