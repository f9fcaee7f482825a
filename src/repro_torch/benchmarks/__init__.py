"""Benchmarks of the port (twins of the repo's ``benchmarks/``): the quality
figures (Fig. 1, 7, 8 and the sampler guardrail) and Table 1's pipeline.

    python -m repro_torch.benchmarks.bench_quality [--device cpu] [--quick]
    python -m repro_torch.benchmarks.bench_pipeline [--device cpu]
"""
