// The kernel-body probe's idfeat ablation of row 5's chunk-parallel route
// (favor_probe.cuh).

#define FAVOR_PROBE_BODY fv::FavorBody::kIdFeat
#include "favor_probe.cuh"
