// fused_fit_moments: fit, subtract, weight, centre and moment diagnostics of
// every (subint, channel) profile, in one pass over the cube.
//
// Replaces the TPU kernel iterative_cleaner_tpu/ops/pallas_kernels.py::
// fused_fit_moments (pallas_call at :201, body _fused_kernel at :84-142).
// Per profile p with template t:
//   amp  = <t,p>/<t,t>, or 1 where <t,t> is 0 or not finite
//   wr   = (amp*t - p) * bin_scale * w0
//   mean = sum(wr)/nbin;  c = wr - mean (written out for the FFT diagnostic)
//   std  = sqrt(sum(c*c)/nbin);  ptp = max(wr) - min(wr)
//   with `valid`: mean, std -> 0 and ptp -> 1e20 where !valid (numpy.ma fills)
//
// One launch covers `narch` same-shape archives (the directory batch, the
// leading grid axis the JAX package gets from jax.vmap of the pallas_call):
// blockIdx.y is the archive, blockIdx.x a block of its profiles, so the 4
// profiles of a block share one archive's template and <t,t>.  The
// per-profile arithmetic does not depend on the archive count, so each
// archive's outputs are bit-identical to a launch over that archive alone.
//
// What bounds it on an H100: device-memory bytes.  It reads D once and
// writes `centred` once (8 bytes per element) plus 4 (nsub, nchan) maps;
// about 12 floating-point operations per element is far below the card's
// f32 rate for those bytes.  The design meets the bound as far as a simple
// kernel can: one warp per profile, lanes on neighbouring bins so every load
// and store is coalesced, the profile staged once in shared memory so the
// three dependent passes (tp -> amp -> sum(wr) -> mean -> sum(c*c)) never
// re-read device memory, and the template and pulse-region scale loaded
// once per block.  The reductions are warp shuffles in f32, in the two-pass
// mean/variance form the parity contract pins.  Several rows in flight per
// warp, TMA staging and fusing the rfft's input are later work.
//
// Built by iterative_cleaner_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// into a plain-C shared library loaded with ctypes.  -fmad=false keeps each
// multiply and add separately rounded, as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;            // profiles per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  // NaN-propagating, as jnp.max / torch.amax (fmaxf drops NaNs).
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
fused_fit_moments_kernel(const float* __restrict__ D,
                         const float* __restrict__ tmpl,
                         const float* __restrict__ bin_scale,
                         const float* __restrict__ w0,
                         const unsigned char* __restrict__ valid,
                         const float* __restrict__ tt_ptr,
                         float* __restrict__ centred,
                         float* __restrict__ mean_out,
                         float* __restrict__ std_out,
                         float* __restrict__ ptp_out,
                         long long nprof, int nbin) {
  extern __shared__ float smem[];
  float* s_t = smem;                 // this archive's template, shared by the block
  float* s_bs = smem + nbin;         // pulse-region bin scale
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = smem + (size_t)(2 + warp) * nbin;  // this warp's profile
  const long long arch = blockIdx.y;               // nprof profiles per archive

  const float* t_arch = tmpl + arch * (long long)nbin;
  for (int b = threadIdx.x; b < nbin; b += blockDim.x) {
    s_t[b] = t_arch[b];
    s_bs[b] = bin_scale[b];
  }
  __syncthreads();

  const long long local = (long long)blockIdx.x * kWarps + warp;
  if (local >= nprof) return;        // no barrier follows
  const long long prof = arch * nprof + local;   // 64-bit: a*nsub*nchan*nbin passes 2^31
  const float* p = D + prof * (long long)nbin;

  // Pass 1: stage the profile, <t,p>.  Each lane only ever touches bins
  // lane, lane+32, ..., so the passes need no barrier between them.
  float tp = 0.f;
  for (int b = lane; b < nbin; b += 32) {
    const float v = p[b];
    row[b] = v;
    tp += v * s_t[b];
  }
  tp = warp_sum(tp);
  const float tt = tt_ptr[arch];
  const bool ok = (tt != 0.f) && isfinite(tt);
  const float amp = ok ? tp / tt : 1.f;
  const float w = w0[prof];

  // Pass 2: the weighted residual, its sum, max and min over exactly nbin
  // values (no padded bins exist on this side).
  float s = 0.f, mx = -INFINITY, mn = INFINITY;
  for (int b = lane; b < nbin; b += 32) {
    const float wr = (amp * s_t[b] - row[b]) * s_bs[b] * w;
    row[b] = wr;
    s += wr;
    mx = nan_max(mx, wr);
    mn = nan_min(mn, wr);
  }
  s = warp_sum(s);
  mx = warp_max(mx);
  mn = warp_min(mn);
  const float mean = s / (float)nbin;

  // Pass 3: centre, write out, sum of squares.
  float* c_out = centred + prof * (long long)nbin;
  float ss = 0.f;
  for (int b = lane; b < nbin; b += 32) {
    const float c = row[b] - mean;
    c_out[b] = c;
    ss += c * c;
  }
  ss = warp_sum(ss);

  if (lane == 0) {
    float m = mean, sd = sqrtf(ss / (float)nbin), pp = mx - mn;
    if (valid != nullptr && !valid[prof]) {
      m = 0.f;
      sd = 0.f;
      pp = 1e20f;
    }
    mean_out[prof] = m;
    std_out[prof] = sd;
    ptp_out[prof] = pp;
  }
}

// Shared memory one block needs: template + bin scale + one row per warp.
long long smem_bytes(int nbin) {
  return (long long)(2 + kWarps) * nbin * (long long)sizeof(float);
}

}  // namespace

extern "C" {

int fused_fit_moments_warps() { return kWarps; }

// Launches on `stream` over `narch` archives of `nprof` profiles each (D is
// (narch, nprof, nbin), tmpl (narch, nbin), tt (narch,), the maps
// (narch, nprof)); allocates nothing, does not synchronise.  Returns the
// cudaError_t of the attribute call or of the launch (0 = success).
int fused_fit_moments_launch(const float* D, const float* tmpl,
                             const float* bin_scale, const float* w0,
                             const unsigned char* valid, const float* tt,
                             float* centred, float* mean, float* std_,
                             float* ptp, long long nprof, int nbin, int narch,
                             void* stream) {
  const long long smem = smem_bytes(nbin);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fit_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (nprof + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)blocks, (unsigned)narch);
  fused_fit_moments_kernel<<<grid, kWarps * 32, (size_t)smem,
                             (cudaStream_t)stream>>>(
      D, tmpl, bin_scale, w0, valid, tt, centred, mean, std_, ptp, nprof, nbin);
  return (int)cudaGetLastError();
}

const char* fused_fit_moments_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
