from repro_torch.kernels.gibbs import ops, ref
from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda

__all__ = ["ops", "ref", "gibbs_argmax_cuda"]
