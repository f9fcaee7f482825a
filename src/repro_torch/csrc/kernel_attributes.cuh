// What the built kernels cost on the card: registers, shared memory, spills
// and blocks an SM, read from the compiled code with cudaFuncGetAttributes
// and the occupancy API. Each library's <name>_attributes entry point lists
// every kernel instantiation its launch function can reach, at the block
// and dynamic shared memory that launch passes; no kernel is launched.
// repro_torch/analysis/smem.py reads them and holds them to sm_90's limits.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

struct KernelEntry {
  const char* name;  // the instantiation, as the wrappers' launch plans name it
  const void* fn;
  int threads;       // the block its launch passes
  size_t smem;       // the dynamic shared bytes its launch passes
  bool opt_in;       // its launch raises the dynamic shared limit to smem first
};

// i < 0: the number of entries. Otherwise entry i's name, and in out[0..10]:
// registers a thread, static shared bytes, the dynamic shared bytes its
// launch passes, the most dynamic shared bytes it may take, local (spill)
// bytes a thread, binaryVersion, ptxVersion, the most threads a block it may
// take, the threads its launch passes, the blocks an SM holds at that
// launch, and 1 where its launch opts in to more dynamic shared memory.
// Returns 0 or the cudaError_t of the call that failed.
inline int kernel_attributes(const KernelEntry* all, int n, int i, const char** name,
                             long long* out) {
  if (i < 0) return n;
  if (i >= n) return (int)cudaErrorInvalidValue;
  const KernelEntry& e = all[i];
  *name = e.name;
  cudaError_t err = cudaSuccess;
  if (e.opt_in && (err = cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)e.smem)) != cudaSuccess)
    return (int)err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, e.fn)) != cudaSuccess) return (int)err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, e.fn, e.threads, e.smem)) !=
      cudaSuccess)
    return (int)err;
  const long long values[11] = {a.numRegs,
                                (long long)a.sharedSizeBytes,
                                (long long)e.smem,
                                a.maxDynamicSharedSizeBytes,
                                (long long)a.localSizeBytes,
                                a.binaryVersion,
                                a.ptxVersion,
                                a.maxThreadsPerBlock,
                                e.threads,
                                per_sm,
                                e.opt_in ? 1 : 0};
  for (int k = 0; k < 11; ++k) out[k] = values[k];
  return 0;
}
