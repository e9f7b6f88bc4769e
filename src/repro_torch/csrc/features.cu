// The param-independent feature kernel of the estimation path.
//
// Replaces: repro/kernels/vampire_energy/vampire_energy.py
//   batched_features_pallas (_features_kernel), the TPU's fused popcount /
//   bus-toggle pass over a padded batch's data stream.
// Computes, per 64-byte line i of M:  ones[i] = popcount(data[i]) and
//   togg[i] = popcount(data[i] ^ prev[i]) * tmask[i], both as float32.
// Bound on the H100: bytes.  It reads 2 x 64 B + 4 B and writes 8 B per
//   line and does ~40 integer operations on them, far below the card's
//   operations-per-byte balance.
// Design: four threads per line, each loading one 16-byte uint4 of data
//   and of prev, so a warp reads 8 whole lines in 512 contiguous bytes
//   (fully coalesced 16-byte loads); __popc on each word and a 4-lane
//   __shfl_xor_sync reduction; the first lane of each line writes both
//   outputs.  No shared memory.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
features_kernel(const uint4* __restrict__ data, const uint4* __restrict__ prev,
                const float* __restrict__ tmask, float* __restrict__ ones,
                float* __restrict__ togg, long long m) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long line = tid >> 2;
  int o = 0, t = 0;
  if (line < m) {
    const uint4 d = data[tid];
    o = repro::popc4(d);
    t = repro::popc4(repro::xor4(d, prev[tid]));
  }
  // every lane takes part in the shuffles; the 4 lanes of a line share a warp
  o = repro::quad_sum(o);
  t = repro::quad_sum(t);
  if (line < m && (tid & 3) == 0) {
    ones[line] = (float)o;
    togg[line] = (float)t * tmask[line];
  }
}

}  // namespace

extern "C" int repro_features(const void* data, const void* prev,
                              const void* tmask, void* ones, void* togg,
                              long long m, void* stream) {
  if (m > 0) {
    const int threads = 256;
    const long long blocks = (4 * m + threads - 1) / threads;
    features_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint4*)data, (const uint4*)prev, (const float*)tmask,
        (float*)ones, (float*)togg, m);
  }
  return (int)cudaGetLastError();
}
