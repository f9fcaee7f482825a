from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

__all__ = ["ops", "ref", "embedding_bag_cuda"]
