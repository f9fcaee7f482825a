"""gibbs_argmax's device time against its bound: each launch draws a
package of T tokens over K topics, bound by ``peaks.gibbs_bytes`` (the [T, K]
φ, ψ and θ planes read once) or ``peaks.gibbs_ops``, whichever is slower;
the launches of the window are epochs × packages. In %."""
import peaks


def read(record):
    tr = record.get("trace")
    if record.get("sampler") != "dense" or tr is None:
        return None
    kernel_s = sum(v for k, v in tr["ops"].items() if "gibbs_argmax" in k)
    if kernel_s <= 0:
        return None
    T, K = record["package_len"], record["K"]
    least, _ = peaks.bound(peaks.gibbs_bytes(T, K), peaks.gibbs_ops(T, K))
    return 100.0 * record["epochs"] * record["packages"] * least / kernel_s
