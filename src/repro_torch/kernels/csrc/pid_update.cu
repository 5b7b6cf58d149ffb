// Fused Tier-1 fleet PID tick for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pid_update.py::_pid_kernel
// (pl.pallas_call in pid_update, file line 75).  Per chip:
//   err    = target - power
//   integ  = clip(integ + err * dt, -windup, windup)
//   u      = clip(target + kp*err + ki*integ + kd*(err - prev_err),
//                 u_min, u_max)
//   u      = min(u, fallback_cap) when the one-step junction prediction
//            t_inf + (temp - t_inf) * exp(-dt / tau), t_inf = t_amb + r_th*power,
//            is above t_limit
// and writes (integ, prev_err = err, u).
//
// What bounds it on this card: bytes.  Each chip reads 5 floats and writes
// 3 (32 B) for about 20 flops, far below the ~20 flop/B an H100 needs
// before arithmetic matters, so the least time is 32*n B / 3.35 TB/s.
// The design does the one thing that matters for such a kernel: one pass,
// one thread per chip with consecutive threads on consecutive addresses
// (coalesced 128 B transactions), no padding of n (the grid-stride loop
// masks the ragged edge), no shared memory, nothing kept between launches.
// The TPU kernel's (8, 128) VMEM tiling has no counterpart here.
//
// Plain C interface, loaded with ctypes: pid_update_launch returns the
// cudaError_t of the launch (0 on success).  Gains and limits are
// arguments, so the constants live in one place (repro_torch/core/pid.py).

#include <cuda_runtime.h>

namespace {

__global__ void pid_update_kernel(
    const float* __restrict__ target, const float* __restrict__ power,
    const float* __restrict__ temp, const float* __restrict__ integ_in,
    const float* __restrict__ perr_in, float* __restrict__ integ_out,
    float* __restrict__ perr_out, float* __restrict__ u_out, long long n,
    float dt_s, float kp, float ki, float kd, float windup, float u_min,
    float u_max, float t_amb_int, float r_th, float thermal_tau,
    float t_limit, float fallback_cap) {
  const float decay = expf(-dt_s / thermal_tau);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float tgt = target[i];
    const float pwr = power[i];
    const float err = tgt - pwr;
    float integ = integ_in[i] + err * dt_s;
    integ = fminf(fmaxf(integ, -windup), windup);
    const float deriv = err - perr_in[i];
    float u = tgt + kp * err + ki * integ + kd * deriv;
    u = fminf(fmaxf(u, u_min), u_max);
    const float t_inf = t_amb_int + r_th * pwr;
    const float t_pred = t_inf + (temp[i] - t_inf) * decay;
    if (t_pred > t_limit) u = fminf(u, fallback_cap);
    integ_out[i] = integ;
    perr_out[i] = err;
    u_out[i] = u;
  }
}

}  // namespace

extern "C" int pid_update_launch(
    const float* target, const float* power, const float* temp,
    const float* integ_in, const float* perr_in, float* integ_out,
    float* perr_out, float* u_out, long long n, float dt_s, float kp,
    float ki, float kd, float windup, float u_min, float u_max,
    float t_amb_int, float r_th, float thermal_tau, float t_limit,
    float fallback_cap, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond ~30 blocks per SM
  pid_update_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      target, power, temp, integ_in, perr_in, integ_out, perr_out, u_out, n,
      dt_s, kp, ki, kd, windup, u_min, u_max, t_amb_int, r_th, thermal_tau,
      t_limit, fallback_cap);
  return static_cast<int>(cudaGetLastError());
}
