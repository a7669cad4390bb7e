// ordered_template: the weighted scrunch of a cube into its template
// profile, summed in the numpy oracle's order.
//
//   out[a, b] = init[a, b] (or 0), then for every profile i = 0 .. nprof-1
//   in (subint, channel) row-major order:
//       out[a, b] = out[a, b] + w[a, i] * D[a, i, b]
//   each product and each sum rounded to the element type on its own.
//
// Two instantiations: float32 (every route by default) and float64 (the
// --x64 routes, whose template is the same sum in one float64 accumulator
// per bin; ops/template.build_template_plain in float64 bit for bit).
//
// This is the order of the oracle's np.einsum("sc,scb->b", w, D,
// dtype=float32) (backends/numpy_backend.build_template) for nbin >= 2: one
// float32 accumulator per bin, advanced profile by profile.  (With one bin
// numpy reduces over the profiles with a blocked sum instead; the cleaner's
// parity is documented from 3 bins.)  A blocked or tree-shaped sum
// (cuBLAS's matrix-vector product) is more accurate but rounds differently,
// and over 2^18 profiles the difference moves the outlier scores by about
// 5e-5 of their value — the documented envelope between routes.  Summing in
// the oracle's order gives its template bit for bit, whatever the route.
// `init` continues a sum: the chunked route streams the cube in subint
// blocks and passes each block the running template, which gives the
// whole-cube sum exactly.
//
// No TPU kernel corresponds to it: the JAX package leaves its template to
// XLA's dot (iterative_cleaner_tpu/ops/template.py::build_template).
//
// What bounds it on an H100.  Each (archive, bin) sum is a chain of nprof
// dependent adds, so no design goes under nprof x (the latency of one
// dependent FADD).  The chain probe below measures 4.109 cycles, 2.078 ns at
// 1980 MHz: 0.545 ms over the 262144 profiles of a 256 x 1024 x 1024 cube,
// above the 0.32 ms its 1.075 GB take at 3.35 TB/s (NVIDIA H100 80GB HBM3,
// 700 W; tools_torch/template_probe.py).  A thread per chain reading its
// own rows from device memory cannot reach it: 1024 chains with 16 loads
// ahead each keep 64 KiB in flight across the card, and take 9.9 ms.
//
// The design separates the loads from the chain.  A block owns one archive
// and kBins neighbouring bins; its warp 0 runs their kBins chains, one lane
// each; warps 1..kProducerWarps keep a ring of kStages stages in shared
// memory filled with cp.async, each stage kRows rows of the block's bins
// and those rows' weights, with a full and an empty mbarrier per stage.  The
// producers issue the copies of the next stages while the chain works
// through the current one: up to (kStages - 1) x 16 KB in flight per block,
// ~5 MB over the 64 blocks of a 1024-bin cube.  The chain warp multiplies
// each row by its weight and adds it, every product and every sum rounded on
// its own (__fmul_rn / __fadd_rn, -fmad=false), in row order, so nothing of
// the contract moves.
//
// What holds it above the chain floor now (0.84-0.93 ms, ~6.3 SM cycles a
// row) is the chain warp's own schedule: a build whose producers copy the
// weights but not the rows (-DICT_TEMPLATE_SKIP_COPIES, measurement only)
// takes as long as the real one (0.825 ms against 0.837 ms in one run), so
// the ring keeps up; the compiler pairs each multiply with its add and
// places the shared-memory loads a few instructions before their use, and
// the warp, which issues in order, waits on them.
//
// Two load paths fill the same row-major ring (kRows x kBins per stage):
// - aligned (the row pitch a multiple of 16 bytes and a 16-byte aligned
//   base, as every cube of the main path): 16-byte copies, four floats or
//   two doubles each;
// - unaligned (any other pitch or base: nbin = 31 or 257 in float32, an odd
//   nbin in float64, a sum continued from a subint whose offset is not a
//   multiple of 16 bytes): a copy per element (4 or 8 bytes), the
//   producers' issue rate their limit.
// A layout that transposes the tile as it lands (so that one 16-byte load
// gives a lane four rows) bought the chain warp nothing and cost 4-byte
// copies everywhere.  The wrapper (ops/template.launch_plan) picks the path
// from the pointer and the pitch; a call of the aligned path on an unaligned
// input is refused.
//
// Archive strides make a batch one launch: D's is nprof x nbin for a
// contiguous batch and 0 for the threshold sweep's pair axis (one cube
// broadcast over the pairs), w's 0 for the sweep's first iteration.  With a
// stride of 0 each archive's blocks still load their own tiles: the pairs
// run their chains at about the same pace, so most repeated reads come from
// L2 (the sweep's 9 pairs at 256 x 1024 x 1024 take 3.55 ms, 8 separate
// cubes 3.99 ms).  A block that staged a tile once for several archives'
// chains would read the cube once; at a few ms a sweep iteration it is not
// worth its code yet.
//
// The float64 ring holds half the rows a stage (kRows64 = 128), so that a
// stage is the same 16 KB and a block the same shared memory in both
// instantiations (two blocks an SM either way); its chain warp works
// through 8 rows a step instead of 16, which keeps its registers (two
// blocks of rows and their products in flight) under the float32 build's.
// Each float64 add waits on the one before as each float32 add does, so the
// float64 build is bound by its chain as well: nprof x the card's dependent
// float64 add (8.05 SM cycles, 4.05 ns: 1.06 ms at 256 x 1024 x 1024).  At
// that shape 128 rows a stage took 1.455 ms and 256 rows (twice the shared
// memory, one block an SM) 1.380 ms (tools_torch/template_probe.py, one
// run, NVIDIA H100 80GB HBM3, 700 W); the 5 % is not worth a second
// shared-memory size, nor halving the blocks an SM where a pair axis puts
// more blocks than SMs on the card.
//
// kBins = 16, kRows = 256, kStages = 6: of the widths and depths measured at
// 256 x 1024 x 1024, 16 bins (64 blocks on 64 SMs) took 0.837 ms, 8 bins
// 0.841 ms and 32 bins 0.906-1.166 ms.  With more blocks than SMs, 32 bins
// (128 rows, 4 stages) is faster: 2.89 ms against 3.99 ms over 8 cubes,
// 2.36 ms against 3.55 ms over the sweep's 9 pairs; the main path has one
// archive.  The ring's depth moves these by less than the spread between
// runs.  (tools_torch/template_probe.py, one run, NVIDIA H100 80GB HBM3,
// 700 W.)
//
// ordered_template_chain_probe (and _f64) is measurement code: one warp
// running a chain of dependent __fadd_rn (__dadd_rn) from registers, whose
// time per add is the chain floor above (chip_smoke.py phase 3 and
// tools_torch/template_probe.py time it; the package never launches it).
//
// Built by iterative_cleaner_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// into a plain-C shared library loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ring.cuh"

// The launch constants; other values only for tools_torch/template_probe.py.
#ifndef ICT_TEMPLATE_BINS
#define ICT_TEMPLATE_BINS 16
#endif
#ifndef ICT_TEMPLATE_ROWS
#define ICT_TEMPLATE_ROWS 256
#endif
#ifndef ICT_TEMPLATE_ROWS64
#define ICT_TEMPLATE_ROWS64 128
#endif
#ifndef ICT_TEMPLATE_STAGES
#define ICT_TEMPLATE_STAGES 6
#endif

namespace {

constexpr int kBins = ICT_TEMPLATE_BINS;      // bins, and chains, per block
constexpr int kStages = ICT_TEMPLATE_STAGES;  // stages in the ring
constexpr int kProducerWarps = 3;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = 32 + kProducers;
constexpr int kBarrierBytes = 2 * kStages * 8;     // full[kStages], empty[kStages]

static_assert(kBins == 8 || kBins == 16 || kBins == 32, "one chain per lane of warp 0");
static_assert(kBarrierBytes % 16 == 0, "stages must start on 16-byte boundaries");

constexpr int kProbeUnroll = 16;

// What differs between the instantiations: the rounded product and sum, the
// 16-byte vector of weights, the copy of one element, and the ring's shape.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Vec = float4;
  static constexpr int kRows = ICT_TEMPLATE_ROWS;  // rows (profiles) per stage
  static constexpr int kBlk = 16;                  // rows per step of the chain warp
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float lane(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void copy(uint32_t dst, const float* src) {
    cp_async_4(dst, src);
  }
};

template <>
struct Elem<double> {
  using Vec = double2;
  static constexpr int kRows = ICT_TEMPLATE_ROWS64;
  static constexpr int kBlk = 8;
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double lane(const double2& v, int k) {
    return k == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ void copy(uint32_t dst, const double* src) {
    cp_async_8(dst, src);
  }
};

template <typename T>
struct Ring {
  static constexpr int kRows = Elem<T>::kRows;
  static constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16 bytes
  static constexpr int kTile = kRows * kBins;
  static constexpr int kStageElems = kTile + kRows;      // the tile, then its weights
  static constexpr int kSmemBytes = kBarrierBytes + kStages * kStageElems * (int)sizeof(T);
  // The chain warp works through its rows kBlk at a time, in a three-step
  // software pipeline: while it adds block n's products, it multiplies
  // block n + 1 (loaded one step earlier) and loads block n + 2,
  // interleaved row by row, so that the source offers three independent
  // instructions between two dependent adds (the compiler still reorders
  // them; see above).
  static constexpr int kBlk = Elem<T>::kBlk;
  static constexpr int kBlocksPerStage = kRows / kBlk;
  static_assert((kStageElems * sizeof(T)) % 16 == 0, "stages must start on 16-byte boundaries");
  static_assert(kRows % kBlk == 0 && kBlocksPerStage % 2 == 0, "blocks of rows go in pairs");
  static_assert(kBlk % kVec == 0, "a block's weights are whole 16-byte vectors");
};

template <typename T>
struct Rows {
  T d[Ring<T>::kBlk];
  typename Elem<T>::Vec w[Ring<T>::kBlk / Ring<T>::kVec];
};

template <typename T>
__device__ __forceinline__ T weight(const Rows<T>& x, int j) {
  return Elem<T>::lane(x.w[j / Ring<T>::kVec], j % Ring<T>::kVec);
}

template <typename T>
__device__ __forceinline__ void load_rows(const T* tile, int g, int r0, Rows<T>& x) {
  using R = Ring<T>;
#pragma unroll
  for (int j = 0; j < R::kBlk; ++j) x.d[j] = tile[(r0 + j) * kBins + g];
#pragma unroll
  for (int j = 0; j < R::kBlk / R::kVec; ++j)
    x.w[j] = *reinterpret_cast<const typename Elem<T>::Vec*>(tile + R::kTile + r0 + R::kVec * j);
}

template <typename T>
__device__ __forceinline__ void multiply(const Rows<T>& x, T (&p)[Ring<T>::kBlk]) {
#pragma unroll
  for (int j = 0; j < Ring<T>::kBlk; ++j) p[j] = Elem<T>::mul(weight(x, j), x.d[j]);
}

// One step: add the products `sum`, multiply the rows `mul` into `prod`,
// load rows r0.. of `tile` into `load`.
template <typename T>
__device__ __forceinline__ T step(T acc, const T (&sum)[Ring<T>::kBlk], const Rows<T>& mul,
                                  T (&prod)[Ring<T>::kBlk], const T* tile, int r0, int g,
                                  Rows<T>& load) {
  using R = Ring<T>;
#pragma unroll
  for (int j = 0; j < R::kBlk; ++j) {
    acc = Elem<T>::add(acc, sum[j]);
    prod[j] = Elem<T>::mul(weight(mul, j), mul.d[j]);
    load.d[j] = tile[(r0 + j) * kBins + g];
    if (j % R::kVec == R::kVec - 1)
      load.w[j / R::kVec] = *reinterpret_cast<const typename Elem<T>::Vec*>(
          tile + R::kTile + r0 + j - (R::kVec - 1));
  }
  return acc;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
ordered_template_kernel(const T* __restrict__ D, const T* __restrict__ w,
                        const T* __restrict__ init, T* __restrict__ out,
                        long long nprof, int nbin, int ngroups, long long d_stride,
                        long long w_stride) {
  using R = Ring<T>;
  constexpr int kRows = R::kRows, kBlk = R::kBlk;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  T* ring = reinterpret_cast<T*>(smem + kBarrierBytes);

  const long long a = blockIdx.x / ngroups;
  const int g0 = (blockIdx.x % ngroups) * kBins;
  const T* Da = D + a * d_stride + g0;
  const T* wa = w + a * w_stride;
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
    // Producers: fill stage k, row by row, once the chain has released it.
    const int p = threadIdx.x - 32;
    int s = 0;
    uint32_t phase = 0;
    for (long long k = 0; k < nstages; ++k) {
      mbar_wait(smem_addr(&empty[s]), phase ^ 1);  // passes at once on the first lap
      T* tile = ring + s * R::kStageElems;
      const long long i0 = k * kRows;
      const int rows = (int)min((long long)kRows, nprof - i0);
      const T* src = Da + i0 * nbin;
#ifndef ICT_TEMPLATE_SKIP_COPIES
      if (kAligned) {
        constexpr int kChunks = kBins / R::kVec;  // 16-byte chunks per row
        for (int q = p; q < kRows * kChunks; q += kProducers) {
          const int r = q / kChunks, c = R::kVec * (q % kChunks);
          if (r < rows && g0 + c < nbin)
            cp_async_16(smem_addr(tile + r * kBins + c), src + (long long)r * nbin + c);
        }
      } else {
        for (int q = p; q < kRows * kBins; q += kProducers) {
          const int r = q / kBins, c = q % kBins;
          if (r < rows && g0 + c < nbin)
            Elem<T>::copy(smem_addr(tile + r * kBins + c), src + (long long)r * nbin + c);
        }
      }
#endif
      for (int r = p; r < rows; r += kProducers)
        Elem<T>::copy(smem_addr(tile + R::kTile + r), wa + i0 + r);
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
  const bool owner = lane < kBins && b < nbin;
  T acc = (owner && init != nullptr) ? init[a * nbin + b] : T(0);
  const long long nfull = nprof / kRows;
  int s = 0;
  uint32_t phase = 0;
  Rows<T> x[2];    // block n + 1's rows, then block n + 2's
  T p[2][kBlk];    // block n's products, then block n + 1's
  if (nfull > 0) {
    mbar_wait(smem_addr(&full[0]), 0);
    load_rows(ring, g, 0, x[0]);
    load_rows(ring, g, kBlk, x[1]);
    multiply(x[0], p[0]);
  }
  for (long long k = 0; k < nfull; ++k) {
    const T* tile = ring + s * R::kStageElems;
    const int s_next = s + 1 == kStages ? 0 : s + 1;
    const uint32_t phase_next = s_next == 0 ? phase ^ 1 : phase;
    const bool more = k + 1 < nfull;
    // The last stage's last two steps reload its own rows: harmless, unused.
    const T* next = more ? ring + s_next * R::kStageElems : tile;
#pragma unroll
    for (int j = 0; j < R::kBlocksPerStage; ++j) {
      // Add block j of this stage, multiply block j + 1, load block j + 2;
      // the last two of these lie in the next stage.
      if (j + 2 == R::kBlocksPerStage && more) mbar_wait(smem_addr(&full[s_next]), phase_next);
      acc = step(acc, p[j % 2], x[(j + 1) % 2], p[(j + 1) % 2],
                 j + 2 < R::kBlocksPerStage ? tile : next,
                 ((j + 2) % R::kBlocksPerStage) * kBlk, g, x[j % 2]);
    }
    __syncwarp();  // every lane's reads of this stage are done
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    s = s_next;
    phase = phase_next;
  }
  if (nfull < nstages) {  // the last, partial stage
    mbar_wait(smem_addr(&full[s]), phase);
    const T* tile = ring + s * R::kStageElems;
    for (int r = 0; r < (int)(nprof - nfull * kRows); ++r)
      acc = Elem<T>::add(acc, Elem<T>::mul(tile[R::kTile + r], tile[r * kBins + g]));
  }
  if (owner) out[a * nbin + b] = acc;
}

template <typename T, bool kAligned>
int launch(const T* D, const T* w, const T* init, T* out, long long nprof, int nbin, int narch,
           long long d_stride, long long w_stride, cudaStream_t stream) {
  // Once per device and instantiation (the warm-up's launch on the first):
  // above 48 KB a block's dynamic shared memory must be allowed explicitly.
  static std::atomic<bool> allowed[kMaxAllowDevices];
  const cudaError_t err = allow_dynamic_smem(
      reinterpret_cast<const void*>(ordered_template_kernel<T, kAligned>), Ring<T>::kSmemBytes,
      allowed);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (nbin + kBins - 1) / kBins;
  const long long blocks = (long long)ngroups * narch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  ordered_template_kernel<T, kAligned>
      <<<(unsigned)blocks, kThreads, Ring<T>::kSmemBytes, stream>>>(
          D, w, init, out, nprof, nbin, ngroups, d_stride, w_stride);
  return (int)cudaGetLastError();
}

// The aligned path wants every row on 16 bytes: the base, the pitch and the
// archive stride; a call that asks for it otherwise is refused.
template <typename T>
int launch_path(const T* D, const T* w, const T* init, T* out, long long nprof, int nbin,
                int narch, long long d_arch_stride, long long w_arch_stride, int path,
                void* stream) {
  if (nprof <= 0 || nbin <= 0 || narch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 0) {
    if (reinterpret_cast<uintptr_t>(D) % 16 != 0 || (nbin * sizeof(T)) % 16 != 0 ||
        (d_arch_stride * (long long)sizeof(T)) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch<T, true>(D, w, init, out, nprof, nbin, narch, d_arch_stride, w_arch_stride,
                           st);
  }
  if (path == 1)
    return launch<T, false>(D, w, init, out, nprof, nbin, narch, d_arch_stride, w_arch_stride,
                            st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
__global__ void __launch_bounds__(32)
chain_probe_kernel(T* out, long long* cycles, long long n_adds, T x) {
  T acc = x * (T)threadIdx.x;
  const long long t0 = clock64();
  for (long long i = 0; i < n_adds; i += kProbeUnroll) {
#pragma unroll
    for (int k = 0; k < kProbeUnroll; ++k) acc = Elem<T>::add(acc, x);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <typename T>
int chain_probe(T* out, long long* cycles, long long n_adds, T x, void* stream) {
  if (n_adds <= 0 || n_adds % kProbeUnroll != 0) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<T><<<1, 32, 0, (cudaStream_t)stream>>>(out, cycles, n_adds, x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// {threads per block, bins per block, rows per stage, stages, dynamic
// shared bytes per block, then the float64 build's rows per stage and
// shared bytes}: the launch constants the wrapper mirrors.
void ordered_template_constants(int* out) {
  out[0] = kThreads;
  out[1] = kBins;
  out[2] = Ring<float>::kRows;
  out[3] = kStages;
  out[4] = Ring<float>::kSmemBytes;
  out[5] = Ring<double>::kRows;
  out[6] = Ring<double>::kSmemBytes;
}

// Launches on `stream` over `narch` archives: archive a's profiles at
// D + a * d_arch_stride (nprof x nbin, row-major), its weights at
// w + a * w_arch_stride (nprof), init and out (narch, nbin) contiguous; init
// may be null.  path 0 is the aligned load path (D 16-byte aligned, the row
// pitch and d_arch_stride multiples of 16 bytes, or the call is refused),
// path 1 the unaligned one, which takes any input.  Allocates nothing, does
// not synchronise.  Returns the launch's cudaError_t (0 = success).
int ordered_template_launch(const float* D, const float* w, const float* init, float* out,
                            long long nprof, int nbin, int narch, long long d_arch_stride,
                            long long w_arch_stride, int path, void* stream) {
  return launch_path<float>(D, w, init, out, nprof, nbin, narch, d_arch_stride, w_arch_stride,
                            path, stream);
}

// The same in float64 (the --x64 routes).
int ordered_template_launch_f64(const double* D, const double* w, const double* init,
                                double* out, long long nprof, int nbin, int narch,
                                long long d_arch_stride, long long w_arch_stride, int path,
                                void* stream) {
  return launch_path<double>(D, w, init, out, nprof, nbin, narch, d_arch_stride,
                             w_arch_stride, path, stream);
}

// Measurement only: one warp, each lane a chain of n_adds dependent
// __fadd_rn (n_adds a multiple of 16); the SM cycles the chain took go to
// cycles[0], each lane's sum to out[0..31].
int ordered_template_chain_probe(float* out, long long* cycles, long long n_adds, float x,
                                 void* stream) {
  return chain_probe<float>(out, cycles, n_adds, x, stream);
}

// The same with __dadd_rn.
int ordered_template_chain_probe_f64(double* out, long long* cycles, long long n_adds,
                                     double x, void* stream) {
  return chain_probe<double>(out, cycles, n_adds, x, stream);
}

const char* ordered_template_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
