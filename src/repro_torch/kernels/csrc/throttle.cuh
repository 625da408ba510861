// The thermal DVFS throttle of the replay tick, defined once for both
// kernels (power_scatter.cu's derate and job clocks, rack_thermal.cu's
// throttled seconds): kernels/throttle.py::throttle_curve of one outlet
// temperature, op by op. With --fmad=false it has the plain version's
// bits.

#pragma once

#include <cuda_runtime.h>

// kernels/throttle.py::Throttle (and its ctypes mirror CThrottle), field
// for field.
struct Throttle {
  float start;   // outlet temperature where the ramp begins
  float span;    // its width, > 0
  float drop;    // the clock lost over the span
  float floor;   // the lowest clock
};

__device__ __forceinline__ float throttle(const Throttle& p, float temp) {
  const float ramp = (temp - p.start) / p.span;
  return fminf(fmaxf(1.0f - p.drop * ramp, p.floor), 1.0f);
}
