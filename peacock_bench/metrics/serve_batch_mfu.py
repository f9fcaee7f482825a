"""The served batches' share of the card's f32 peak (TF32 stays off, so the
Eq. 5 product runs outside the tensor cores): per batch 2 · rows · K · V
for Eq. 5 and Eq. 4's counted hill climb (``peaks.eq4_ops``) at its real
rows, summed, over Σ batch time × 67 TFLOP/s. In %."""
import peaks


def read(record):
    shapes, ms = record.get("batch_shapes"), record.get("batch_ms")
    if not shapes or not ms:
        return None
    K, V = record["K"], record["V"]
    flops = sum(peaks.serve_gemm_flops(r, K, V)
                + peaks.eq4_ops(r, Ld, record["n_trials"], record["n_iters"])
                for r, Ld in shapes)
    return 100.0 * flops / (sum(ms) / 1e3 * peaks.F32_OPS_PER_S)
