"""The training window's share of the card's peak: the algorithmic work of
the window's epochs counted from the cell's shapes, each piece at the
larger of its operations over the f32 peak and its bytes over the HBM peak,
over the window's wall time. Dense: per epoch the T × K conditional terms
(``peaks.gibbs_ops``) against the Θ plane of the docs and the Φ rows of the
distinct words (``peaks.dense_epoch_bytes``). Alias: per epoch the MH
chain's bytes and operations, and each table build's slots. In %."""
import peaks


def read(record):
    if "epoch_s" not in record:
        return None
    K, T, n = record["K"], record["tokens"], record["epochs"]
    if record["sampler"] == "dense":
        per, _ = peaks.bound(peaks.dense_epoch_bytes(record["n_docs"], record["n_words"], K),
                             peaks.gibbs_ops(T, K))
        work = n * per
    else:
        if not record.get("mh_sector_bytes"):
            return None
        mh, _ = peaks.bound(peaks.mh_fixed_bytes(T, record["n_docs"], record["doc_cap"], K)
                            + record["mh_sector_bytes"],
                            peaks.mh_ops(T, record["doc_cap"], record["n_mh"]))
        R = record["rows"]
        word, _ = peaks.bound(peaks.build_bytes(R, K), peaks.build_ops(R, K))
        alpha, _ = peaks.bound(peaks.build_bytes(1, K), peaks.build_ops(1, K))
        work = n * mh + record["word_builds"] * word + record["alpha_builds"] * alpha
    return 100.0 * work / record["window_s"]
