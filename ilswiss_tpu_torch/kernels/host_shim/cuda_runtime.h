// A host stand-in for the parts of the CUDA runtime that the port's
// cooperative kernels use, so that a .cu source can be compiled by g++ and
// run on CPU threads (see ../host_build.py).  One std::thread per CUDA
// thread; std::barrier for __syncthreads, for a warp's shuffles and for
// grid.sync().  It checks a kernel's logic at small sizes, not its speed.
#pragma once
#include <algorithm>
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
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

struct alignas(16) float4 { float x, y, z, w; };
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

inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error"
         : e == cudaErrorInvalidValue ? "invalid argument" : "launch refused";
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// the "SM count" is the number of blocks to run: three, an odd number, so
// that round-robin dealing of work to blocks wraps unevenly
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 3 : 1;
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
  std::mutex mu;
  std::map<std::string, std::vector<float4>> shared;
};
extern thread_local HostIdx threadIdx, blockIdx, gridDim;
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
