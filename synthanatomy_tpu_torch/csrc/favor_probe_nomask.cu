// The kernel-body probe's nomask ablation of row 5's chunk-parallel route
// (favor_probe.cuh).

#define FAVOR_PROBE_BODY fv::FavorBody::kNoMask
#include "favor_probe.cuh"
