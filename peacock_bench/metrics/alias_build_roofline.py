"""alias_build's device time against its bound: each word-table build is
rows × K slots, each α-table build 1 × K, bound by ``peaks.build_bytes``
(12 B a slot, 4 B a row) or ``peaks.build_ops``. In %."""
import peaks


def read(record):
    tr = record.get("trace")
    if record.get("sampler") != "alias" or tr is None:
        return None
    n_word, n_alpha = record["word_builds"], record["alpha_builds"]
    kernel_s = sum(v for k, v in tr["ops"].items() if "alias_build" in k)
    if kernel_s <= 0 or n_word + n_alpha == 0:
        return None
    R, K = record["rows"], record["K"]
    word, _ = peaks.bound(peaks.build_bytes(R, K), peaks.build_ops(R, K))
    alpha, _ = peaks.bound(peaks.build_bytes(1, K), peaks.build_ops(1, K))
    return 100.0 * (n_word * word + n_alpha * alpha) / kernel_s
