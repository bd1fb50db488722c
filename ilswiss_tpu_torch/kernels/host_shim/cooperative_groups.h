// Host stand-in for cooperative_groups' grid barrier and thread block
// clusters (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { host_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group(); }

struct cluster_group {
  unsigned num_blocks() const { return host_cluster->size; }
  unsigned block_rank() const { return blockIdx.x % host_cluster->size; }
  // the same offset in block `rank`'s dynamic shared memory
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const char* mine = reinterpret_cast<const char*>(host_block->dynamic.data());
    char* theirs =
        reinterpret_cast<char*>((*host_cluster->blocks)[rank].dynamic.data());
    return reinterpret_cast<T*>(theirs + (reinterpret_cast<char*>(p) - mine));
  }
  void sync() const { host_cluster->bar->arrive_and_wait(); }
};
inline cluster_group this_cluster() { return cluster_group(); }
}  // namespace cooperative_groups
