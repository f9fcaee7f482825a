from repro_torch.kernels.alias import ops, ref
from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_resample_cuda

__all__ = ["ops", "ref", "alias_build_cuda", "mh_resample_cuda"]
