// A host stand-in for the parts of the CUDA runtime that the port's
// cooperative kernels use, so that a .cu source can be compiled by g++ and
// run on CPU threads (see ../host_build.py).  One std::thread per CUDA
// thread; std::barrier for __syncthreads, for a warp's shuffles and
// tensor-core products, and for grid.sync().  It checks a kernel's logic
// at small sizes, not its speed.
#pragma once
#define ILSWISS_HOST_SHIM 1
#include <algorithm>
#include <cstring>
#include <barrier>
#include <cmath>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(x) alignas(x)

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct HostIdx { unsigned x, y, z; };
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 720
};
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrCooperativeLaunch = 95 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};

inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error"
         : e == cudaErrorInvalidValue ? "invalid argument" : "launch refused";
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) {
  return cudaSuccess;
}
template <class... Args>
cudaError_t cudaFuncSetAttribute(void (*)(Args...), int, int) {
  return cudaSuccess;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
// the "SM count" is the number of blocks to run: by default three, an odd
// number, so that round-robin dealing of work to blocks wraps unevenly; a
// build may set the H100's 132 to take the launch choices the card takes
#ifndef ILSWISS_SHIM_SMS
#define ILSWISS_SHIM_SMS 3
#endif
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? ILSWISS_SHIM_SMS : 1;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
// defined by host_build.py's trailer, which knows the kernel's argument type
cudaError_t cudaLaunchCooperativeKernel(void* f, dim3 grid, dim3 block,
                                        void** args, size_t, cudaStream_t);
// a plain launch runs the same way; it just never meets the grid barrier
inline cudaError_t cudaLaunchKernel(void* f, dim3 grid, dim3 block,
                                    void** args, size_t n, cudaStream_t s) {
  return cudaLaunchCooperativeKernel(f, grid, block, args, n, s);
}

struct HostBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::vector<float>> warp_buf;
  std::vector<std::vector<unsigned>> warp_frag;  // 6 registers a lane
  std::vector<float4> dynamic;  // `extern __shared__` memory of a launch
  std::mutex mu;
  std::map<std::string, std::vector<float4>> shared;
};
extern thread_local HostIdx threadIdx, blockIdx, gridDim, blockDim;
extern thread_local HostBlock* host_block;
extern std::barrier<>* host_grid_bar;

// `__shared__ float name[n];` becomes `float* name = host_shared("name", n);`
inline float* host_shared(const char* name, size_t n) {
  std::lock_guard<std::mutex> lock(host_block->mu);
  auto& buf = host_block->shared[name];
  if (buf.empty()) buf.resize(n / 4 + 1);
  return reinterpret_cast<float*>(buf.data());
}
inline void __syncthreads() { host_block->bar->arrive_and_wait(); }
inline void __syncwarp() {
  host_block->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  host_block->warp_buf[w][l] = v;
  host_block->warp_bar[w]->arrive_and_wait();
  const float r = host_block->warp_buf[w][l ^ lane_mask];
  host_block->warp_bar[w]->arrive_and_wait();
  return r;
}

// the other warp collectives the kernels use, through the same buffer
inline float __shfl_down_sync(unsigned, float v, unsigned delta) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  host_block->warp_buf[w][l] = v;
  host_block->warp_bar[w]->arrive_and_wait();
  const float r = l + delta < 32 ? host_block->warp_buf[w][l + delta] : v;
  host_block->warp_bar[w]->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32;
  host_block->warp_buf[w][threadIdx.x % 32] = v;
  host_block->warp_bar[w]->arrive_and_wait();
  const float r = host_block->warp_buf[w][src & 31];
  host_block->warp_bar[w]->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int w = threadIdx.x / 32;
  host_block->warp_buf[w][threadIdx.x % 32] = pred ? 1.f : 0.f;
  host_block->warp_bar[w]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (host_block->warp_buf[w][i] != 0.f) r |= 1u << i;
  host_block->warp_bar[w]->arrive_and_wait();
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int w = threadIdx.x / 32;
  host_block->warp_buf[w][threadIdx.x % 32] = static_cast<float>(v);
  host_block->warp_bar[w]->arrive_and_wait();
  float r = host_block->warp_buf[w][0];
  for (int i = 1; i < 32; ++i) r = std::max(r, host_block->warp_buf[w][i]);
  host_block->warp_bar[w]->arrive_and_wait();
  return static_cast<int>(r);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

// `extern __shared__ float name[];` becomes
// `float* name = host_dynamic_shared();`
inline float* host_dynamic_shared() {
  return reinterpret_cast<float*>(host_block->dynamic.data());
}

// bf16 rounding to nearest, ties to even, as cvt.rn.bf16x2.f32 does:
// bf16_pack(lo, hi) holds lo in its low half
inline unsigned bf16_bits(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}
inline unsigned bf16_pack(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
inline float bf16_round(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}

// Asynchronous copies: plain copies here; a wait has nothing to wait for.
inline void cp_async16(float* dst, const float* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async4(float* dst, const float* src) { *dst = *src; }
inline void cp_async_commit() {}
inline void cp_async_wait(int) {}

// Stand-in for mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with the
// instruction's fragment layout: the warp's lanes pool their fragments,
// rebuild the 16 x 16 bf16 matrix a and the 16 x 8 matrix b, and each lane
// adds its four entries of a b (rows g and g + 8, columns 2t and 2t + 1,
// g = lane / 4, t = lane % 4) to c in float32.
inline void mma_bf16_16816(float c[4], const unsigned a[4],
                           const unsigned b[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  unsigned* buf = host_block->warp_frag[w].data();
  for (int i = 0; i < 4; ++i) buf[l * 6 + i] = a[i];
  buf[l * 6 + 4] = b[0];
  buf[l * 6 + 5] = b[1];
  host_block->warp_bar[w]->arrive_and_wait();
  float A[16][16], Bm[16][8];
  auto lo = [](unsigned r) { return __uint_as_float(r << 16); };
  auto hi = [](unsigned r) { return __uint_as_float(r & 0xffff0000u); };
  for (int L = 0; L < 32; ++L) {
    const int g = L / 4, t = (L % 4) * 2;
    const unsigned* f = buf + L * 6;
    A[g][t] = lo(f[0]);         A[g][t + 1] = hi(f[0]);
    A[g + 8][t] = lo(f[1]);     A[g + 8][t + 1] = hi(f[1]);
    A[g][t + 8] = lo(f[2]);     A[g][t + 9] = hi(f[2]);
    A[g + 8][t + 8] = lo(f[3]); A[g + 8][t + 9] = hi(f[3]);
    Bm[t][g] = lo(f[4]);        Bm[t + 1][g] = hi(f[4]);
    Bm[t + 8][g] = lo(f[5]);    Bm[t + 9][g] = hi(f[5]);
  }
  host_block->warp_bar[w]->arrive_and_wait();
  const int g = l / 4, t = (l % 4) * 2;
  for (int j = 0; j < 4; ++j) {
    const int row = g + (j / 2) * 8, col = t + (j % 2);
    float s = c[j];
    for (int k = 0; k < 16; ++k) s += A[row][k] * Bm[k][col];
    c[j] = s;
  }
}

// Thread block clusters (cooperative_groups.h reads these): a cluster
// launch runs one cluster at a time, all its blocks' threads together, so
// `map_shared_rank` can reach a neighbour's dynamic shared memory and
// `cluster.sync()` is one barrier over the cluster's threads.
struct HostCluster {
  std::vector<HostBlock>* blocks;
  unsigned size;
  std::barrier<>* bar;
};
inline thread_local HostCluster* host_cluster = nullptr;

enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct {
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

template <class A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(A), A a) {
  unsigned cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cs = cfg->attrs[i].val.clusterDim.x;
  const dim3 grid = cfg->gridDim, block = cfg->blockDim;
  if (cs < 1 || grid.x % cs != 0) return cudaErrorInvalidValue;
  for (unsigned c0 = 0; c0 < grid.x; c0 += cs) {
    std::vector<HostBlock> blocks(cs);
    std::barrier<> bar(cs * block.x);
    HostCluster cluster{&blocks, cs, &bar};
    for (auto& b : blocks) {
      b.bar.reset(new std::barrier<>(block.x));
      b.dynamic.resize(cfg->dynamicSmemBytes / sizeof(float4) + 1);
      for (unsigned w = 0; w < block.x / 32; ++w) {
        b.warp_bar.emplace_back(new std::barrier<>(32));
        b.warp_buf.emplace_back(32);
        b.warp_frag.emplace_back(32 * 6);
      }
    }
    std::vector<std::thread> threads;
    for (unsigned bi = 0; bi < cs; ++bi)
      for (unsigned ti = 0; ti < block.x; ++ti)
        threads.emplace_back([&, bi, ti] {
          threadIdx = {ti, 0, 0};
          blockIdx = {c0 + bi, 0, 0};
          gridDim = {grid.x, 1, 1};
          blockDim = {block.x, 1, 1};
          host_block = &blocks[bi];
          host_cluster = &cluster;
          kernel(a);
        });
    for (auto& t : threads) t.join();
  }
  return cudaSuccess;
}
