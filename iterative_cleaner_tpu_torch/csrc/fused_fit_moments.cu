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
// D is (narch, nprof, nbin), the template (narch, nbin).
//
// <t,t> is the kernel's own: each consumer warp sums it from the template
// it staged, in the lane map's order below, so the wrapper launches nothing
// else before it.
//
// What bounds it on an H100: device-memory bytes.  It reads D once and
// writes `centred` once (8 bytes per element) plus 4 (nsub, nchan) maps;
// about 12 floating-point operations per element is far below the card's
// f32 rate for those bytes.  The first design (a block of 4 warps per 4
// profiles, one row in flight per warp, the template and the bin scale
// copied into shared memory by every block) reached 42 % of that bound on
// a 32 x 1024 x 1024 slab and 73 % at 256 x 1024 x 1024, a call with its
// launch.
//
// The design:
// - Persistent blocks, tiles taken as they go.  The grid is a few blocks
//   per SM (the wrapper's ops/fused_kernels.launch_plan); a tile is `rows`
//   consecutive profiles of one archive, and each block's producer takes
//   the next tile index from a counter in device memory whenever a stage
//   of its ring is free, so an SM that runs ahead takes more tiles.  The
//   last producer to finish sets the counter back to 0 for the next launch
//   on its stream (no memset before each launch).  The archive comes from
//   the tile index.  A block copies the bin scale into shared memory once
//   and an archive's template once per archive it meets.
// - A ring of `stages` stages in shared memory, each one tile and its
//   weights, kept full by a producer warp: on the aligned path one lane
//   copies the whole tile with one 1-D TMA bulk copy (cp.async.bulk ...
//   complete_tx::bytes on the stage's full mbarrier); on the unaligned
//   path (a pitch or a base off 16 bytes) the warp's 32 lanes issue 4-byte
//   cp.async copies; the weights come by 4-byte cp.async on both.  Consumer
//   warps take a tile's rows in turn and give the stage back through its
//   empty mbarrier, so up to stages - 1 tiles are in flight while they work.
// - Wide stores: a lane owns 4 neighbouring bins of each 128-bin chunk and
//   writes `centred` with 16-byte stores on the aligned path (4-byte stores
//   on the unaligned one).
// At 256 x 1024 x 1024 this takes 0.730 ms of device time, 88 % of the
// byte bound; 89 % over 8 such cubes and 80 % on the 32 x 1024 x 1024
// slab, against 83 %, 83 % and 69 % for the first design (NVIDIA H100
// 80GB HBM3, 700 W; tools_torch/fit_moments_probe.py --against, launches
// back to back).
//
// The order inside a profile is fixed by the lane map alone: lane l keeps
// 4 partial sums, bin 128k + 4l + j going to sum j in k order, folds them
// as (s0 + s1) + (s2 + s3), then the warp's butterfly of shuffles adds the
// lanes.  No block, stage, tile or archive count and neither load path
// changes a profile's bits, so each archive of a batched launch is
// bit-identical to a launch on it alone, and the two paths agree bit for
// bit.  The passes are two-pass mean / variance over exactly nbin values,
// max and min propagate NaN (max.NaN / min.NaN), and -fmad=false keeps
// every multiply and add separately rounded, as the plain version does.
// Offsets are 64-bit: a batch of 8 cubes of 256 x 1024 x 1024 has 2^31
// elements.  A wait on a ring barrier that has not completed after
// kHangNs (ring.cuh) traps, so a fault in the handshake is a launch failure
// that the wrapper raises, never a hang.
//
// Built by iterative_cleaner_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// into a plain-C shared library loaded with ctypes.  The ring's stages and
// rows and the grid are launch arguments (the wrapper's plan); the aligned
// path's copy engine is a build constant, its other value only for
// tools_torch/fit_moments_probe.py.

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>

#include "ring.cuh"

// The aligned path's copies: 0 = one TMA bulk copy per tile, 1 = 16-byte
// cp.async from the producer warp's lanes.
#ifndef ICT_FIT_COPY
#define ICT_FIT_COPY 0
#endif

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // the consumers, then the producer
constexpr int kMaxStages = 8;
constexpr int kBlocksPerSM = 3;                      // the registers' budget: 3 blocks an SM
// full[kMaxStages] and empty[kMaxStages] mbarriers, then each stage's tile.
constexpr int kHeaderBytes = 3 * kMaxStages * 8;
constexpr int kMaxSmemBytes = 232448;                // a Hopper block's dynamic shared memory
constexpr int kMaxRows = 128;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kHeaderBytes % 16 == 0, "the template must start on 16 bytes");

// The consumer warps only (named barrier 1; the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kConsumerWarps * 32) : "memory");
}

// NaN-propagating, as jnp.max / torch.amax (fmaxf drops NaNs).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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


__device__ __forceinline__ float4 splat(float x) { return make_float4(x, x, x, x); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A profile's arithmetic, one group of 4 bins at a time.  Lane l owns the
// groups g = l, l + 32, ... (bins 4g .. 4g + 3); m is how many of a group's
// bins exist (4 on the aligned path, where nbin % 4 == 0; else 4 but in the
// last group).  Each lane keeps 4 partial sums (and maxima, minima): bin
// 4g + j goes to chain j, each chain advances group by group, and the
// chains fold as (c0 + c1) + (c2 + c3) before the warp's butterfly of
// shuffles (four short chains, not one long one, for the latency of a
// dependent add); so the order is the lane map's alone.
template <bool kAligned>
__device__ __forceinline__ int group_bins(int nbin, int g) {
  return kAligned ? 4 : min(4, nbin - 4 * g);
}

__device__ __forceinline__ float& chain(float4& acc, int j) {
  return j == 0 ? acc.x : j == 1 ? acc.y : j == 2 ? acc.z : acc.w;
}

__device__ __forceinline__ float fold_sum(const float4& a) { return (a.x + a.y) + (a.z + a.w); }

__device__ __forceinline__ float fold_max(const float4& a) {
  return nan_max(nan_max(a.x, a.y), nan_max(a.z, a.w));
}

__device__ __forceinline__ float fold_min(const float4& a) {
  return nan_min(nan_min(a.x, a.y), nan_min(a.z, a.w));
}

__device__ __forceinline__ void dot_group(float4& tp, const float4& v, const float4& t, int m) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < m) chain(tp, j) += at(v, j) * at(t, j);
}

__device__ __forceinline__ float4 residual(const float4& v, const float4& t, const float4& bs,
                                           float amp, float w) {
  return make_float4((amp * t.x - v.x) * bs.x * w, (amp * t.y - v.y) * bs.y * w,
                     (amp * t.z - v.z) * bs.z * w, (amp * t.w - v.w) * bs.w * w);
}

__device__ __forceinline__ void moments_group(float4& s, float4& mx, float4& mn,
                                              const float4& r, int m) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < m) {
      chain(s, j) += at(r, j);
      chain(mx, j) = nan_max(chain(mx, j), at(r, j));
      chain(mn, j) = nan_min(chain(mn, j), at(r, j));
    }
}

// Centre, write out (16 bytes at once on the aligned path), add the squares.
template <bool kAligned>
__device__ __forceinline__ void centre_group(float4& ss, const float4& r, float mean,
                                             float* __restrict__ c_out, int g, int m) {
  const float4 c = make_float4(r.x - mean, r.y - mean, r.z - mean, r.w - mean);
  if (kAligned) {
    *reinterpret_cast<float4*>(c_out + 4 * g) = c;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < m) c_out[4 * g + j] = at(c, j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < m) chain(ss, j) += at(c, j) * at(c, j);
}

// <t,t> of the staged template, in the same lane map as a profile's sums.
template <bool kAligned>
__device__ __forceinline__ float template_norm(const float* __restrict__ s_t, int nbin, int lane) {
  const int ngroups = (nbin + 3) / 4;
  float4 acc = splat(0.f);
  for (int g = lane; g < ngroups; g += 32) {
    const float4 t = ld4(s_t + 4 * g);
    dot_group(acc, t, t, group_bins<kAligned>(nbin, g));
  }
  return warp_sum(fold_sum(acc));
}

__device__ __forceinline__ float amplitude(float tp, float tt) {
  const bool ok = (tt != 0.f) && isfinite(tt);
  return ok ? tp / tt : 1.f;
}

__device__ __forceinline__ void write_maps(float mean, float ss, float mx, float mn, bool keep,
                                           int nbin, float* mean_out, float* std_out,
                                           float* ptp_out) {
  float me = mean, sd = sqrtf(ss / (float)nbin), pp = mx - mn;
  if (!keep) {
    me = 0.f;
    sd = 0.f;
    pp = 1e20f;
  }
  *mean_out = me;
  *std_out = sd;
  *ptp_out = pp;
}

// One profile, staged at `row` in shared memory: each pass reads it there,
// and pass 2 overwrites it with the weighted residual.
template <bool kAligned>
__device__ __forceinline__ void fit_row(float* __restrict__ row,
                                             const float* __restrict__ s_t,
                                             const float* __restrict__ s_bs, float tt, float w,
                                             bool keep, float* __restrict__ c_out,
                                             float* mean_out, float* std_out, float* ptp_out,
                                             int nbin, int lane) {
  const int ngroups = (nbin + 3) / 4;
  float4 tp = splat(0.f);
#pragma unroll 4
  for (int g = lane; g < ngroups; g += 32)
    dot_group(tp, ld4(row + 4 * g), ld4(s_t + 4 * g), group_bins<kAligned>(nbin, g));
  const float amp = amplitude(warp_sum(fold_sum(tp)), tt);
  float4 s = splat(0.f), mx = splat(-INFINITY), mn = splat(INFINITY);
#pragma unroll 4
  for (int g = lane; g < ngroups; g += 32) {
    const float4 r = residual(ld4(row + 4 * g), ld4(s_t + 4 * g), ld4(s_bs + 4 * g), amp, w);
    *reinterpret_cast<float4*>(row + 4 * g) = r;
    moments_group(s, mx, mn, r, group_bins<kAligned>(nbin, g));
  }
  const float mean = warp_sum(fold_sum(s)) / (float)nbin;
  const float hi = warp_max(fold_max(mx)), lo = warp_min(fold_min(mn));
  float4 ss = splat(0.f);
#pragma unroll 4
  for (int g = lane; g < ngroups; g += 32)
    centre_group<kAligned>(ss, ld4(row + 4 * g), mean, c_out, g, group_bins<kAligned>(nbin, g));
  const float sq = warp_sum(fold_sum(ss));
  if (lane == 0) write_maps(mean, sq, hi, lo, keep, nbin, mean_out, std_out, ptp_out);
}

// A tile: `n` profiles of archive `arch` from profile `first` of the cube.
struct Tile {
  long long arch, first;
  int n;
};

__device__ __forceinline__ Tile tile_at(long long tile, long long nprof, int rows,
                                        long long tiles_per_arch) {
  const long long a = tile / tiles_per_arch;
  const long long i0 = (tile - a * tiles_per_arch) * rows;
  return {a, a * nprof + i0, (int)min((long long)rows, nprof - i0)};
}

// Floats of one stage: its rows, then their weights (a multiple of 4).
__host__ __device__ __forceinline__ int stage_floats(int pitch, int rows) {
  return rows * pitch + ((rows + 3) & ~3);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_fit_moments_kernel(const float* __restrict__ D, const float* __restrict__ tmpl,
                         const float* __restrict__ bin_scale, const float* __restrict__ w0,
                         const unsigned char* __restrict__ valid, float* __restrict__ centred,
                         float* __restrict__ mean_out, float* __restrict__ std_out,
                         float* __restrict__ ptp_out, long long nprof, int nbin, int stages,
                         int rows, long long tiles_per_arch, long long ntiles,
                         unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  long long* stage_tile = reinterpret_cast<long long*>(empty + kMaxStages);
  const int pitch = (nbin + 3) & ~3;                 // floats; 16-byte rows in shared memory
  float* s_t = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* s_bs = s_t + pitch;
  float* ring = s_bs + pitch;
  const int stride = stage_floats(pitch, rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr bool kBulk = kAligned && ICT_FIT_COPY == 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&full[s]), 33);   // the producer's 32 lanes and its lane 0 again
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int b = threadIdx.x; b < pitch; b += kThreads) s_bs[b] = b < nbin ? bin_scale[b] : 0.f;
  __syncthreads();

  int s = 0;
  uint32_t phase = 0;
  if (warp == kConsumerWarps) {
    // The producer: tile after tile into the ring, once its stage is free;
    // a tile index past the end tells the consumers to stop.  Lane 0 takes
    // the next tile from the counter and copies its rows; every lane copies
    // a row's weight.
    for (;;) {
      mbar_wait(smem_addr(&empty[s]), phase ^ 1);    // passes at once on the first lap
      long long tile = 0;
      if (lane == 0) tile = (long long)atomicAdd(&counters[0], 1ull);
      tile = __shfl_sync(kFull, tile, 0);
      float* dst = ring + s * stride;
      const uint32_t bar = smem_addr(&full[s]);
      if (tile < ntiles) {
        const Tile t = tile_at(tile, nprof, rows, tiles_per_arch);
        const float* src = D + t.first * nbin;
        if (lane == 0) {
          stage_tile[s] = tile;
          if (kBulk) {                                 // pitch == nbin: the tile is one span
            const uint32_t bytes = (uint32_t)t.n * (uint32_t)nbin * 4u;
            mbar_expect_tx(bar, bytes);
            bulk_copy(smem_addr(dst), src, bytes, bar);
          } else {
            mbar_arrive(bar);
          }
        }
        if (!kBulk && kAligned) {
          for (int q = lane; q < t.n * nbin / 4; q += 32)
            cp_async_16(smem_addr(dst + 4 * q), src + 4 * q);
        } else if (!kBulk) {
          for (int r = 0; r < t.n; ++r)
            for (int b = lane; b < nbin; b += 32)
              cp_async_4(smem_addr(dst + r * pitch + b), src + (long long)r * nbin + b);
        }
        for (int r = lane; r < t.n; r += 32)
          cp_async_4(smem_addr(dst + rows * pitch + r), w0 + t.first + r);
        cp_async_arrive(bar);
      } else {
        if (lane == 0) {
          stage_tile[s] = tile;
          mbar_arrive(bar);
        }
        cp_async_arrive(bar);
        break;
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    // This block takes no more tiles.  The last block to get here knows
    // that no block will (each took its index past the end first), and sets
    // both counters back to 0 for the next launch on the stream.
    if (lane == 0) {
      __threadfence();
      if (atomicAdd(&counters[1], 1ull) == gridDim.x - 1) {
        __threadfence();
        atomicExch(&counters[0], 0ull);
        atomicExch(&counters[1], 0ull);
      }
    }
    return;
  }

  // The consumers: warp `warp` takes rows warp, warp + kConsumerWarps, ...
  // of each tile, its weights from the stage.
  long long arch = -1;
  float tt = 0.f;
  for (;;) {
    mbar_wait(smem_addr(&full[s]), phase);
    const long long tile = stage_tile[s];
    if (tile >= ntiles) break;
    const Tile cur = tile_at(tile, nprof, rows, tiles_per_arch);
    if (cur.arch != arch) {          // a new archive: its template, once
      consumers_sync();              // every consumer is done with the last one
      for (int b = threadIdx.x; b < pitch; b += kConsumerWarps * 32)
        s_t[b] = b < nbin ? tmpl[cur.arch * nbin + b] : 0.f;
      consumers_sync();
      arch = cur.arch;
      tt = template_norm<kAligned>(s_t, nbin, lane);
    }
    float* stage = ring + s * stride;
    for (int r = warp; r < cur.n; r += kConsumerWarps) {
      const long long prof = cur.first + r;
      // Used at the row's end only: the load is in flight meanwhile.
      const bool keep = valid == nullptr || valid[prof] != 0;
      const float w = stage[rows * pitch + r];
      fit_row<kAligned>(stage + r * pitch, s_t, s_bs, tt, w, keep, centred + prof * nbin,
                        mean_out + prof, std_out + prof, ptp_out + prof, nbin, lane);
    }
    // This warp's writes to the stage come before the copy that refills it.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

long long smem_bytes(int nbin, int stages, int rows) {
  const int pitch = (nbin + 3) & ~3;
  return kHeaderBytes + 4 * (2 * (long long)pitch + (long long)stages * stage_floats(pitch, rows));
}

template <bool kAligned>
int launch(const float* D, const float* tmpl, const float* bin_scale, const float* w0,
           const unsigned char* valid, float* centred, float* mean, float* std_, float* ptp,
           long long nprof, int nbin, int narch, int stages, int rows, long long blocks,
           unsigned long long* counters, cudaStream_t stream) {
  // Once per process (the warm-up's launch): above 48 KB a block's dynamic
  // shared memory must be allowed explicitly.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fused_fit_moments_kernel<kAligned>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const long long tiles_per_arch = (nprof + rows - 1) / rows;
  const long long ntiles = tiles_per_arch * narch;
  if (blocks > ntiles) blocks = ntiles;
  fused_fit_moments_kernel<kAligned><<<(unsigned)blocks, kThreads,
                                       (size_t)smem_bytes(nbin, stages, rows), stream>>>(
      D, tmpl, bin_scale, w0, valid, centred, mean, std_, ptp, nprof, nbin, stages, rows,
      tiles_per_arch, ntiles, counters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// {threads per block, consumer warps, most stages, header bytes (the
// barriers and the stages' tiles), the aligned path's copies (0 bulk, 1
// 16-byte cp.async), most dynamic shared bytes per block}: the constants
// the wrapper mirrors.
void fused_fit_moments_constants(int* out) {
  out[0] = kThreads;
  out[1] = kConsumerWarps;
  out[2] = kMaxStages;
  out[3] = kHeaderBytes;
  out[4] = ICT_FIT_COPY;
  out[5] = kMaxSmemBytes;
}

// Launches on `stream` over `narch` archives of `nprof` profiles each (D and
// centred (narch, nprof, nbin), tmpl (narch, nbin), w0, valid and the maps
// (narch, nprof); valid may be null) with a ring of `stages` stages of
// `rows` profiles and `blocks` blocks (at most one per tile).  `counters`
// is two 8-byte counters in device memory, both 0 before the first launch
// and left at 0 by every launch that completes, from which the blocks take
// their tiles; the launches that share them must run one after another
// (one stream).
// path 0 is the aligned path (D and centred 16-byte aligned and nbin a
// multiple of 4, or the call is refused), path 1 the unaligned one, which
// takes any input.  Allocates nothing, does not synchronise.  Returns the
// cudaError_t of the attribute call or of the launch (0 = success).
int fused_fit_moments_launch(const float* D, const float* tmpl, const float* bin_scale,
                             const float* w0, const unsigned char* valid, float* centred,
                             float* mean, float* std_, float* ptp, long long nprof, int nbin,
                             int narch, int path, int stages, int rows, long long blocks,
                             unsigned long long* counters, void* stream) {
  if (counters == nullptr || nprof <= 0 || nbin <= 0 || narch <= 0 || stages < 1 ||
      stages > kMaxStages ||
      rows < 1 || rows > kMaxRows || blocks < 1 || blocks > INT_MAX ||
      smem_bytes(nbin, stages, rows) > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0) {
    if (reinterpret_cast<uintptr_t>(D) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(centred) % 16 != 0 || nbin % 4 != 0)
      return (int)cudaErrorInvalidValue;
    return launch<true>(D, tmpl, bin_scale, w0, valid, centred, mean, std_, ptp, nprof, nbin,
                        narch, stages, rows, blocks, counters, st);
  }
  if (path == 1)
    return launch<false>(D, tmpl, bin_scale, w0, valid, centred, mean, std_, ptp, nprof, nbin,
                         narch, stages, rows, blocks, counters, st);
  return (int)cudaErrorInvalidValue;
}

const char* fused_fit_moments_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
