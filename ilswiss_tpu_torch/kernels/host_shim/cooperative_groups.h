// Host stand-in for cooperative_groups' grid barrier (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { host_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group(); }
}  // namespace cooperative_groups
