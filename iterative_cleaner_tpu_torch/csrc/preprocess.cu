// preprocess: the surgical clean's iteration-invariant preprocessing on the
// card, in place on the uploaded raw plane, bit for bit with the native host
// pass (native/ict_native.cc, ict_preprocess):
//
//   (a) dedisperse: each (subint, channel) row rotated by its channel's
//       shift, o[b] = p[(b + sh) % nbin] (ict_native.cc:114-118);
//   (b) the weighted total profile in float64, every bin's sum advanced
//       profile by profile in (subint, channel) order, total[b] +=
//       (double)w * (double)o[b], the product rounded before the add
//       (ict_native.cc:123-131);
//   (c) the baseline window: the first minimum of the circular running
//       mean of the total profile, with native's csum arithmetic and its
//       strict < (ict_native.cc:133-144), on one thread;
//   (d) each row less its own mean over that window, the mean summed in
//       window order in float64 and divided by the width,
//       o[b] = (float)((double)o[b] - mean) (ict_native.cc:147-158); in the
//       same pass the NaN-ignoring minimum and maximum of the result go to
//       one device pair, the input scan's peak (core/cleaner._parity_warnings).
//
// No TPU kernel corresponds to it: both packages preprocess on the host
// (the JAX package's ops/preprocess.py and native.py).  It was added because
// the host pass was 0.35-0.54 s of a 0.65-1.05 s LOFAR archive while the card
// waited; the wrapper is ops/preprocess.preprocess_plane, its plain twin
// ops/preprocess.preprocess_plane_plain.
//
// Every float64 product, sum, difference and quotient is rounded on its own
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, and -fmad=false), as the host
// compiles them (g++ -std=c++17 contracts nothing); float to double is exact
// and double to float rounds to nearest, as on the host.
//
// What bounds it on an H100.  (a) and (d) each read and write the cube once:
// 2 x 2 GiB at 3.35 TB/s, 1.28 ms; (b) reads it once more, 0.32 ms, but each
// bin's sum is a chain of nsub x nchan dependent float64 adds: 262144 x the
// card's 4.036 ns a dependent add is 1.058 ms at 256 x 1024 x 1024, whatever
// the design.  (b) is therefore built as ordered_template.cu's float64
// instantiation is: a block owns kBins neighbouring bins, its warp 0 runs
// their chains, one lane each, and three producer warps keep a ring of
// kStages stages in shared memory filled with cp.async (16-byte copies of
// the float32 rows where the pitch and the base allow, 4-byte ones
// elsewhere), each stage kRows rows of the block's bins and those rows'
// weights, already widened to float64 by a first small kernel, so that the
// chain warp converts only the sample.  (c) is a few microseconds.  (d)
// streams the rows in blocks of kBaseRows: a thread per row sums its window
// (the window's samples are a few sectors of the row, mostly L1 hits after
// the first), then the whole block subtracts, row after row, and reduces the
// block's minimum and maximum, which one compare-and-swap loop per block
// folds into the pair.
//
// Built by iterative_cleaner_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// into a plain-C shared library loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "ring.cuh"

namespace {

constexpr int kRollThreads = 256;
constexpr int kWidenThreads = 256;
// The largest row the roll stages in shared memory: a block's 227 KB.
constexpr int kMaxBins = 232448 / 4;

constexpr int kBins = 16;    // bins, and chains, per block of the total profile
constexpr int kRows = 256;   // rows (profiles) per stage
constexpr int kStages = 6;
constexpr int kProducerWarps = 3;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kTotalThreads = 32 + kProducers;
constexpr int kBarrierBytes = 2 * kStages * 8;       // full[kStages], empty[kStages]
constexpr int kTileBytes = kRows * kBins * 4;        // float32 samples
constexpr int kStageBytes = kTileBytes + kRows * 8;  // then the rows' float64 weights
constexpr int kTotalSmem = kBarrierBytes + kStages * kStageBytes;
constexpr int kUnroll = 16;

constexpr int kWindowThreads = 256;

constexpr int kBaseThreads = 256;
constexpr int kBaseRows = 32;   // rows per step of a baseline block
constexpr int kBlocksPerSm = 8;

static_assert(kBarrierBytes % 16 == 0 && kStageBytes % 16 == 0,
              "stages must start on 16-byte boundaries");
static_assert(kRows % kUnroll == 0, "a full stage is whole steps of the chain");
static_assert(kBaseRows <= kBaseThreads, "a thread per row sums the window");

// ------------------------------------------------------------ (a) the roll

__global__ void __launch_bounds__(kRollThreads)
preprocess_roll_kernel(float* __restrict__ D, const int* __restrict__ shifts, long long nrows,
                       int nchan, int nbin) {
  extern __shared__ float row[];
  for (long long r = blockIdx.x; r < nrows; r += gridDim.x) {
    int sh = shifts[r % nchan] % nbin;
    if (sh < 0) sh += nbin;
    if (sh == 0) continue;  // the same for every thread of the block
    float* o = D + r * nbin;
    for (int b = threadIdx.x; b < nbin; b += kRollThreads) row[b] = o[b];
    __syncthreads();
    for (int b = threadIdx.x; b < nbin; b += kRollThreads) {
      int src = b + sh;
      if (src >= nbin) src -= nbin;
      o[b] = row[src];
    }
    __syncthreads();
  }
}

// -------------------------------------------------- (b) the total profile

__global__ void __launch_bounds__(kWidenThreads)
preprocess_widen_kernel(const float* __restrict__ w, double* __restrict__ w64, long long n) {
  for (long long i = blockIdx.x * (long long)kWidenThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kWidenThreads)
    w64[i] = (double)w[i];
}

template <bool kAligned>
__global__ void __launch_bounds__(kTotalThreads)
preprocess_total_kernel(const float* __restrict__ D, const double* __restrict__ w64,
                        double* __restrict__ total, long long nprof, int nbin) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;

  const int g0 = blockIdx.x * kBins;
  const long long nstages = (nprof + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), kProducers);
      mbar_init(smem_addr(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // Producers: fill stage k once the chain has released it.
    const int p = threadIdx.x - 32;
    int s = 0;
    uint32_t phase = 0;
    for (long long k = 0; k < nstages; ++k) {
      mbar_wait(smem_addr(&empty[s]), phase ^ 1);  // passes at once on the first lap
      float* tile = reinterpret_cast<float*>(ring + s * kStageBytes);
      double* wt = reinterpret_cast<double*>(ring + s * kStageBytes + kTileBytes);
      const long long i0 = k * kRows;
      const int rows = (int)min((long long)kRows, nprof - i0);
      const float* src = D + i0 * nbin + g0;
      if (kAligned) {
        constexpr int kChunks = kBins / 4;  // 16-byte chunks per row
        for (int q = p; q < kRows * kChunks; q += kProducers) {
          const int r = q / kChunks, c = 4 * (q % kChunks);
          if (r < rows && g0 + c < nbin)
            cp_async_16(smem_addr(tile + r * kBins + c), src + (long long)r * nbin + c);
        }
      } else {
        for (int q = p; q < kRows * kBins; q += kProducers) {
          const int r = q / kBins, c = q % kBins;
          if (r < rows && g0 + c < nbin)
            cp_async_4(smem_addr(tile + r * kBins + c), src + (long long)r * nbin + c);
        }
      }
      for (int r = p; r < rows; r += kProducers) cp_async_8(smem_addr(wt + r), w64 + i0 + r);
      cp_async_arrive(smem_addr(&full[s]));
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // Warp 0: the chains, lane g on bin g0 + g (lanes past kBins mirror).
  const int g = lane % kBins;
  const int b = g0 + g;
  double acc = 0.0;
  int s = 0;
  uint32_t phase = 0;
  for (long long k = 0; k < nstages; ++k) {
    mbar_wait(smem_addr(&full[s]), phase);
    const float* tile = reinterpret_cast<const float*>(ring + s * kStageBytes);
    const double* wt = reinterpret_cast<const double*>(ring + s * kStageBytes + kTileBytes);
    const int rows = (int)min((long long)kRows, nprof - k * kRows);
    if (rows == kRows) {
      // Two steps in flight: while the chain adds one step's kUnroll
      // products, the warp loads and multiplies the next step's rows.
      double cur[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) cur[j] = __dmul_rn(wt[j], (double)tile[j * kBins + g]);
      for (int r0 = kUnroll; r0 < kRows; r0 += kUnroll) {
        double nxt[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          nxt[j] = __dmul_rn(wt[r0 + j], (double)tile[(r0 + j) * kBins + g]);
          acc = __dadd_rn(acc, cur[j]);
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) cur[j] = nxt[j];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = __dadd_rn(acc, cur[j]);
    } else {
      for (int r = 0; r < rows; ++r)
        acc = __dadd_rn(acc, __dmul_rn(wt[r], (double)tile[r * kBins + g]));
    }
    __syncwarp();  // every lane's reads of this stage are done
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (lane < kBins && b < nbin) total[b] = acc;
}

// ------------------------------------------------------- (c) the window

// csum holds nbin + width + 1 values, means nbin.  Also resets the peak
// pair that (d) folds into.
__global__ void __launch_bounds__(kWindowThreads)
preprocess_window_kernel(const double* __restrict__ total, double* __restrict__ csum,
                         double* __restrict__ means, int nbin, int width, int* start_out,
                         float* peak) {
  if (threadIdx.x == 0) {
    double c = 0.0;
    csum[0] = c;
    int i = 0;
    for (int b = 0; b < nbin + width; ++b) {
      c = __dadd_rn(c, total[i]);
      csum[b + 1] = c;
      if (++i == nbin) i = 0;
    }
    peak[0] = CUDART_INF_F;   // nothing seen yet
    peak[1] = -CUDART_INF_F;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbin; b += kWindowThreads)
    means[b] = __ddiv_rn(__dsub_rn(csum[b + width], csum[b]), (double)width);
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
    double best = means[0];
    for (int b = 1; b < nbin; ++b) {
      const double m = means[b];
      if (m < best) {
        best = m;
        start = b;
      }
    }
    *start_out = start;
  }
}

// ----------------------------------------------------- (d) the baseline

// Lower (max: raise) *addr to v; NaN never reaches here.
__device__ void fold_min(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(a);
  while (v < __int_as_float(old)) {
    const int prev = atomicCAS(a, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}

__device__ void fold_max(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(a);
  while (v > __int_as_float(old)) {
    const int prev = atomicCAS(a, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}

__global__ void __launch_bounds__(kBaseThreads)
preprocess_baseline_kernel(float* __restrict__ D, long long nrows, int nbin, int width,
                           const int* __restrict__ start_p, float* peak) {
  __shared__ double mean[kBaseRows];
  __shared__ float lo_w[kBaseThreads / 32], hi_w[kBaseThreads / 32];
  const int start = *start_p;
  // fminf/fmaxf return the other operand of a NaN: NaN is never kept.
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (long long r0 = blockIdx.x * (long long)kBaseRows; r0 < nrows;
       r0 += (long long)gridDim.x * kBaseRows) {
    const int nr = (int)min((long long)kBaseRows, nrows - r0);
    float* base = D + r0 * nbin;
    if (threadIdx.x < nr) {
      const float* o = base + (long long)threadIdx.x * nbin;
      double acc = 0.0;
      int i = start;
#pragma unroll 8
      for (int k = 0; k < width; ++k) {
        acc = __dadd_rn(acc, (double)o[i]);
        if (++i == nbin) i = 0;
      }
      mean[threadIdx.x] = __ddiv_rn(acc, (double)width);
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      float* o = base + (long long)r * nbin;
      const double m = mean[r];
      for (int b = threadIdx.x; b < nbin; b += kBaseThreads) {
        const float v = __double2float_rn(__dsub_rn((double)o[b], m));
        o[b] = v;
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
    }
    __syncthreads();  // mean[] is rewritten by the next step
  }
  for (int off = 16; off > 0; off /= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 1; j < kBaseThreads / 32; ++j) {
      lo = fminf(lo, lo_w[j]);
      hi = fmaxf(hi, hi_w[j]);
    }
    fold_min(&peak[0], lo);
    fold_max(&peak[1], hi);
  }
}

int sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

long long clamp_grid(long long want, long long most) {
  return want < most ? (want < 1 ? 1 : want) : most;
}

}  // namespace

extern "C" {

// The widest row (bins) the roll takes; the wrapper mirrors it.
int preprocess_max_bins() { return kMaxBins; }

// Preprocess the contiguous float32 cube D (nsub x nchan x nbin) in place on
// `stream`: (a) rotate each row by shifts[channel] (int32, any sign; a row
// whose shift is 0 is not touched); (b) the float64 total profile under the weights w
// (nsub x nchan float32); (c) the window of `width` bins, its start to
// *start; (d) each row less its window mean, and the NaN-ignoring (min, max)
// of the result to peak[0], peak[1] (+inf, -inf where every value is NaN).
// `scratch` holds nsub * nchan + 3 * nbin + width + 1 doubles.  path 0 is the
// aligned load path of (b) (D 16-byte aligned and nbin a multiple of 4, or
// the call is refused), path 1 the one that takes any input.  Allocates
// nothing, does not synchronise; returns the first failed launch's
// cudaError_t (0 = success).
int preprocess_launch(float* D, const float* w, const int* shifts, double* scratch, int* start,
                      float* peak, long long nsub, int nchan, int nbin, int width, int path,
                      void* stream) {
  if (nsub <= 0 || nchan <= 0 || nbin <= 0 || nbin > kMaxBins || width <= 0 || width > nbin)
    return (int)cudaErrorInvalidValue;
  if (path == 0 && (reinterpret_cast<uintptr_t>(D) % 16 != 0 || nbin % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (path != 0 && path != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nprof = nsub * nchan;
  double* w64 = scratch;
  double* total = w64 + nprof;
  double* csum = total + nbin;
  double* means = csum + nbin + width + 1;
  int nsm = 0;
  int err = sm_count(&nsm);
  if (err != 0) return err;

  preprocess_widen_kernel<<<(unsigned)clamp_grid((nprof + kWidenThreads - 1) / kWidenThreads,
                                                   (long long)nsm * kBlocksPerSm),
                            kWidenThreads, 0, st>>>(w, w64, nprof);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  static std::atomic<bool> roll_allowed[kMaxAllowDevices];
  const int bytes = nbin * 4;
  if (bytes > 48 * 1024) {
    err = (int)allow_dynamic_smem(reinterpret_cast<const void*>(preprocess_roll_kernel),
                                  kMaxBins * 4, roll_allowed);
    if (err != 0) return err;
  }
  preprocess_roll_kernel<<<(unsigned)clamp_grid(nprof, (long long)nsm * kBlocksPerSm),
                           kRollThreads, bytes, st>>>(D, shifts, nprof, nchan, nbin);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  static std::atomic<bool> total_allowed[2][kMaxAllowDevices];
  const void* total_kernel = path == 0
      ? reinterpret_cast<const void*>(preprocess_total_kernel<true>)
      : reinterpret_cast<const void*>(preprocess_total_kernel<false>);
  err = (int)allow_dynamic_smem(total_kernel, kTotalSmem, total_allowed[path]);
  if (err != 0) return err;
  const unsigned groups = (unsigned)((nbin + kBins - 1) / kBins);
  if (path == 0)
    preprocess_total_kernel<true><<<groups, kTotalThreads, kTotalSmem, st>>>(D, w64, total,
                                                                             nprof, nbin);
  else
    preprocess_total_kernel<false><<<groups, kTotalThreads, kTotalSmem, st>>>(D, w64, total,
                                                                              nprof, nbin);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  preprocess_window_kernel<<<1, kWindowThreads, 0, st>>>(total, csum, means, nbin, width, start,
                                                         peak);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  preprocess_baseline_kernel<<<(unsigned)clamp_grid((nprof + kBaseRows - 1) / kBaseRows,
                                                      (long long)nsm * kBlocksPerSm),
                               kBaseThreads, 0, st>>>(D, nprof, nbin, width, start, peak);
  return (int)cudaGetLastError();
}

const char* preprocess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
