// Cooperative launches of the persistent kernels (hamming_mutual_nn.cu,
// project_match.cu, p3p_ransac.cu, pgo_matvec.cu, gba_reproj_blocks.cu,
// gba_reduced_matvec.cu): the grid is at most the blocks the card holds at
// once, so the kernels' grid barriers are safe, and a launch the card
// refuses returns its error, which the Python wrapper raises.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <tuple>

namespace coop {

// what a launch does when its grid would exceed the block slots its caller
// allocated for per-block partial sums: refuse it, or cut the grid to them
enum class Slots { kRefuse, kCap };

// the blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that fit on the current device at once: its occupancy times the
// SM count, queried once per kernel, device, block size and shared memory
inline cudaError_t co_resident(const void* kernel, int threads, size_t smem, int* blocks) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int, size_t>, int> cached;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  {
    std::lock_guard<std::mutex> hold(lock);
    const auto it = cached.find(key);
    if (it != cached.end()) {
      *blocks = it->second;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  *blocks = cached[key] = per_sm * sms;
  return cudaSuccess;
}

// the dynamic shared memory a block of `kernel` may take on the current
// device: the opt-in limit less the kernel's static shared memory, which
// the kernel is allowed to take, set once per kernel and device
inline cudaError_t smem_room(const void* kernel, int* room) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int>, int> cached;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev);
  std::lock_guard<std::mutex> hold(lock);
  const auto it = cached.find(key);
  if (it != cached.end()) {
    *room = it->second;
    return cudaSuccess;
  }
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int r = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, r);
  if (err != cudaSuccess) return err;
  *room = cached[key] = r;
  return cudaSuccess;
}

// one cooperative launch of `kernel` in blocks of `threads` over min(the
// co-resident blocks, the blocks `items` work items need); a grid above
// `slot_cap` is refused or cut to it, as `slots` says.  Returns 0 or the
// CUDA error (cudaErrorInvalidConfiguration for a refused grid).
template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, long long items, int slot_cap, Slots slots,
           void** args, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int max_blocks = 0;
  cudaError_t err = co_resident(fn, threads, smem, &max_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (std::max(items, 1LL) + threads - 1) / threads;
  int grid = static_cast<int>(std::min<long long>(max_blocks, need));
  if (slots == Slots::kCap) grid = std::min(grid, slot_cap);
  if (grid < 1 || grid > slot_cap) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchCooperativeKernel(fn, grid, threads, args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace coop
