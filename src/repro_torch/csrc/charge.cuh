// The kernel template shared by the charge kernels (vampire_energy.cu,
// baseline_energy.cu): launch geometry, command loads, the deterministic
// mean and per-cell reductions, and the cluster finish.
//
// Geometry.  One block of CT threads takes a tile of consecutive commands
//   of one trace and computes every vendor of one vendor group on it, so
//   each command is read from device memory once per group.  A trace's
//   tiles are the ranks of one thread-block cluster (size `cluster`, 1-8);
//   the grid is (T * cluster, vendor groups).  Commands come in groups of
//   four that start on a 16-byte boundary of the planes (`phase` is the
//   planes' common element offset from one), so a thread loads each plane
//   of a group with one 16-byte load; the two groups at a row's ends that
//   stick out of it load their commands one by one.  A row's steps of CT
//   groups go to the ranks in turn (step s to rank s % cluster); thread i
//   takes group i of a step, copied into shared memory by cp.async some
//   steps ahead (MEAN_STAGES for the mean, one for the surface),
//   the first while the parameters load, so the next loads are in flight
//   while a step computes, without holding registers.  Each command is
//   decoded once (what every vendor shares: state fields, table offsets,
//   the command's class) and then charged for each vendor of the group
//   without a branch, so a warp whose commands differ runs one path.
// Reductions, all in a fixed order (no float atomics, the same bits on
//   every run):
//   mean:    each thread adds its four commands in order and the sum into
//            its own shared-memory slot per vendor; at the end one warp per
//            vendor adds the 256 slots (8 in order per lane, then a
//            __shfl_xor_sync tree) into the block's partial;
//   surface: per command slot, the lanes of a warp whose commands share a
//            (bank, row-band) cell (__match_any_sync) add their charges by
//            pointer jumping over the lanes of their cell in lane order;
//            the cell's lowest lane adds the sum into its warp's bin of
//            the cell; at the end the 8 warps' bins are added in warp
//            order: O(1) work per command per vendor;
//   cluster: every block writes its partials into its rank's slot of
//            rank 0's shared memory (distributed shared memory); after one
//            cluster barrier rank 0 adds them in rank order and writes
//            each output element once, so the kernel's (T, V) or
//            (T, V, 64) output needs no second pass.
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int CT = 256;              // threads per block
constexpr int CWARPS = CT / 32;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int MAX_GROUP = 32;        // vendors per group
constexpr int MEAN_STAGES = 2;       // steps of planes the mean stages ahead
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

// Steps of planes staged ahead: one for the surface, whose bins need the
// shared memory.
__host__ __device__ constexpr int stages(bool surface) {
  return surface ? 1 : MEAN_STAGES;
}
__host__ __device__ constexpr int acc_floats(int group, bool surface) {
  return surface ? CWARPS * group * N_CELLS : group * CT;
}
__host__ __device__ constexpr int out_floats(int group, bool surface) {
  return surface ? group * N_CELLS : group;
}
// Dynamic shared memory of one block: the staged planes (16 bytes a
// thread, plane and step), the group's parameter rows, the per-thread
// accumulators (mean) or the per-warp cell bins (surface), then rank 0's
// gather area for every rank's partials.
template <class Pol, bool SURFACE>
__host__ __device__ constexpr int charge_smem_bytes(int group) {
  return stages(SURFACE) * Pol::PLANES * CT * 16 +
         (group * Pol::P + acc_floats(group, SURFACE) +
          MAX_CLUSTER * out_floats(group, SURFACE)) * 4;
}

// 16-byte asynchronous copies from device to shared memory (cp.async,
// cached in L2 only), committed and waited on per step
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 4-byte words of one plane into a command field
__device__ __forceinline__ void unpack4(const int4 v, int* x) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void unpack4(const int4 v, float* x) {
  x[0] = __int_as_float(v.x);
  x[1] = __int_as_float(v.y);
  x[2] = __int_as_float(v.z);
  x[3] = __int_as_float(v.w);
}

// Pol supplies: P (floats per vendor in shared memory), PLANES (the
// per-command planes it reads, each a 4-byte word), Args, plane(a, p)
// (plane p's base), Cmds
// (four commands as loaded) and unpack(c, p, v) (plane p's four words into
// c), Dec (one command decoded: what every vendor shares, with its weight
// w), Vend (one vendor's scalars, in registers), load_params(sp, a, g0,
// vg) (ends in __syncthreads), trace_scalar(a, t), decode(c, k, ts),
// cell(d), vendor(sv) and charge(sv, u, d) for vendor row sv.
//
// A command of weight 0 (the NOP / dt = 0 padding of a bucket) adds
// charge * 0 = 0, so it is skipped: a warp whose commands all have weight
// 0 skips the vendor loop, and in the surface such a command joins no
// cell.  Within a warp every command's charge is worked out (the decoded
// fields of a skipped one are in range) and a select keeps the active
// ones', so the lanes do not branch.
template <class Pol, bool SURFACE>
__global__ void __launch_bounds__(CT, SURFACE ? 3 : 4)
charge_kernel(const typename Pol::Args a, float* __restrict__ out,
              int n_traces, int n_cmds, int n_vendors, int group, int phase) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = Pol::PLANES, NS = stages(SURFACE);
  static_assert(NS == 1 || NS == 2, "one or two staged steps");
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster's first barrier phase, arrived at now and waited on before
  // any block writes into another's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / cs;
  const int g0 = blockIdx.y * group;
  const int vg = min(group, n_vendors - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int4* staged = reinterpret_cast<int4*>(smem);   // [NS][NP][CT] 16 B
  float* sp = smem + NS * NP * CT * 4;
  float* acc = sp + group * Pol::P;
  float* gather = acc + acc_floats(group, SURFACE);

  // this rank's groups of four: group q covers row elements 4q-h .. 4q-h+3;
  // step s of the rank takes groups (s * cs + rank) * CT + tid
  const int h = (int)(((long long)phase + (long long)t * n_cmds) & 3);
  const int n_groups = (n_cmds + h + 3) >> 2;
  const int row_steps = (n_groups + CT - 1) / CT;
  const int steps = row_steps > rank ? (row_steps - rank + cs - 1) / cs : 0;
  const long long row0 = (long long)t * n_cmds;
  auto group_of = [&](int s) { return (s * cs + rank) * CT + tid; };
  auto valid_of = [&](int q) -> unsigned {
    unsigned valid = 0;
    if (q < n_groups) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q - h + k >= 0 && 4 * q - h + k < n_cmds) valid |= 1u << k;
    }
    return valid;
  };
  // stage step s's group (whole groups only; a row's end groups are read
  // word by word when they are used)
  auto issue = [&](int s) {
    const int q = group_of(s);
    if (valid_of(q) == 0xfu) {
      int4* dst = staged + (s % NS) * NP * CT + tid;
      const long long g = row0 + 4 * q - h;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        cp_async16(dst + p * CT, Pol::plane(a, p) + g);
    }
    cp_async_commit();
  };

  // the first steps' loads are in flight while the parameters load
  for (int s = 0; s < NS && s < steps; ++s) issue(s);
  const float ts = Pol::trace_scalar(a, t);
  for (int i = tid; i < acc_floats(vg, SURFACE); i += CT) acc[i] = 0.0f;
  Pol::load_params(sp, a, g0, vg);

  for (int s = 0; s < steps; ++s) {
    // step s's copies are done once at most step s + 1's are still
    // pending
    if (NS == 2 && s + 1 < steps)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const int q = group_of(s);
    const unsigned valid = valid_of(q);
    typename Pol::Cmds c;
    if (valid == 0xfu) {
      const int4* src = staged + (s % NS) * NP * CT + tid;
#pragma unroll
      for (int p = 0; p < NP; ++p) Pol::unpack(c, p, src[p * CT]);
    } else {
      const long long g = row0 + 4 * q - h;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int* pl = Pol::plane(a, p);
        int w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = ((valid >> k) & 1) ? pl[g + k] : 0;
        Pol::unpack(c, p, make_int4(w[0], w[1], w[2], w[3]));
      }
    }
    typename Pol::Dec d[4];
    unsigned active = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[k] = Pol::decode(c, k, ts);
      if (((valid >> k) & 1) && d[k].w != 0.0f) active |= 1u << k;
    }
    if (s + NS < steps) issue(s + NS);   // this step's stage is free again
    if (!__any_sync(FULL, active)) continue;
    if constexpr (!SURFACE) {
      for (int v = 0; v < vg; ++v) {
        const float* sv = sp + v * Pol::P;
        const typename Pol::Vend u = Pol::vendor(sv);
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ck = Pol::charge(sv, u, d[k]);
          sum += ((active >> k) & 1) ? ck : 0.0f;
        }
        acc[v * CT + tid] += sum;
      }
    } else {
      // per slot: the cell (a lane of its own, 64 + lane, for a command
      // that adds nothing), its lowest lane, and the pointer-jumping
      // partners (6 bits per round, 32 = none) and rounds it needs
      int cell[4];
      unsigned jumps[4];
      int rounds[4];
      bool lead[4], any[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool on = (active >> k) & 1;
        any[k] = __any_sync(FULL, on);
        cell[k] = on ? Pol::cell(d[k]) : N_CELLS + lane;
        const unsigned peers = __match_any_sync(FULL, cell[k]);
        lead[k] = on && (__ffs(peers) - 1) == lane;
        const unsigned above = lane == 31 ? 0u : peers & (FULL << (lane + 1));
        int nx = above ? __ffs(above) - 1 : 32;
        jumps[k] = 0;
        rounds[k] = 0;
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          if (!__any_sync(FULL, nx < 32)) break;
          jumps[k] |= (unsigned)nx << (6 * r);
          rounds[k] = r + 1;
          const int o = __shfl_sync(FULL, nx, nx & 31);
          nx = nx < 32 ? o : 32;
        }
      }
      float* bins = acc + warp * vg * N_CELLS;
      for (int v = 0; v < vg; ++v) {
        const float* sv = sp + v * Pol::P;
        const typename Pol::Vend u = Pol::vendor(sv);
        float x[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ck = Pol::charge(sv, u, d[k]);
          x[k] = ((active >> k) & 1) ? ck : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!any[k]) continue;
#pragma unroll
          for (int r = 0; r < 5; ++r) {
            if (r < rounds[k]) {
              const int src = (jumps[k] >> (6 * r)) & 63;
              const float o = __shfl_sync(FULL, x[k], src & 31);
              if (src < 32) x[k] += o;
            }
          }
          if (lead[k]) bins[v * N_CELLS + cell[k]] += x[k];
          __syncwarp();
        }
      }
    }
  }

  // the block's partials, each pushed into its rank's slot of rank 0's
  // gather area by the thread that adds it up
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst0 = cluster.map_shared_rank(gather, 0);
  const int n_out = out_floats(vg, SURFACE);
  if constexpr (!SURFACE) {
    for (int v = warp; v < vg; v += CWARPS) {
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < CT / 32; ++i) x += acc[v * CT + i * 32 + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
      if (lane == 0) dst0[rank * n_out + v] = x;
    }
  } else {
    for (int e = tid; e < n_out; e += CT) {
      float x = acc[e];
#pragma unroll
      for (int w = 1; w < CWARPS; ++w) x += acc[w * vg * N_CELLS + e];
      dst0[rank * n_out + e] = x;
    }
  }

  // rank 0 adds the ranks' partials in rank order and writes the output
  cluster.sync();
  if (rank == 0) {
    float* dst =
        out + ((long long)t * n_vendors + g0) * (SURFACE ? N_CELLS : 1);
    for (int e = tid; e < n_out; e += CT) {
      float x = 0.0f;
      for (int r = 0; r < cs; ++r) x += gather[r * n_out + e];
      dst[e] = x;
    }
  }
}

// Launch one instance: grid (T * cluster, vendor groups), clusters of
// `cluster` blocks, the group's dynamic shared memory (above 48 KB the
// kernel's limit is raised first, once for each device and larger size).
// Returns the first CUDA error, or cudaGetLastError() after the launch.
template <class Pol, bool SURFACE>
int launch_charge(const typename Pol::Args& a, void* out, int n_traces,
                  int n_cmds, int n_vendors, int cluster, int group,
                  int phase, void* stream) {
  static_assert(charge_smem_bytes<Pol, SURFACE>(MAX_GROUP) <= SMEM_LIMIT,
                "a full vendor group must fit a block's shared memory");
  if (n_traces <= 0 || n_vendors <= 0) return (int)cudaGetLastError();
  if (n_cmds < 0 || cluster < 1 || cluster > MAX_CLUSTER || group < 1 ||
      group > MAX_GROUP || phase < 0 || phase > 3 ||
      (long long)n_traces * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = charge_smem_bytes<Pol, SURFACE>(group);
  auto kernel = charge_kernel<Pol, SURFACE>;
  // the kernel's shared-memory limit, raised once per device and size
  static int limit[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > limit[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) limit[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_traces * cluster),
                     (unsigned)((n_vendors + group - 1) / group), 1);
  cfg.blockDim = dim3(CT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, (float*)out, n_traces, n_cmds,
                         n_vendors, group, phase);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace repro
