// ordered_template: the weighted scrunch of a cube into its template
// profile, summed in the numpy oracle's order.
//
//   out[a, b] = init[a, b] (or 0), then for every profile i = 0 .. nprof-1
//   in (subint, channel) row-major order:
//       out[a, b] = out[a, b] + w[a, i] * D[a, i, b]
//   each product and each sum rounded to float32 on its own.
//
// This is the order of the oracle's np.einsum("sc,scb->b", w, D,
// dtype=float32) (backends/numpy_backend.build_template) for nbin >= 2: one
// float32 accumulator per bin, advanced profile by profile.  (With one bin
// numpy reduces over the profiles with a blocked sum instead; the cleaner's
// parity is documented from 3 bins.)  A blocked or
// tree-shaped sum (cuBLAS's matrix-vector product) is more accurate but
// rounds differently, and over 2^18 profiles the difference moves the
// outlier scores by about 5e-5 of their value — the documented envelope
// between routes.  Summing in the oracle's order gives its template bit for
// bit, whatever the route.  `init` continues a sum: the chunked route
// streams the cube in subint blocks and passes each block the running
// template, which gives the whole-cube sum exactly.
//
// No TPU kernel corresponds to it: the JAX package leaves its template to
// XLA's dot (iterative_cleaner_tpu/ops/template.py::build_template).
//
// What bounds it on an H100: the dependency chain of each bin's sum, not
// bytes.  A bin's nprof additions must run one after another, so the work
// has only nbin * narch independent chains (1024 at 256 x 1024 x 1024); the
// cube is read once, but with so few threads the loads in flight, not the
// memory's rate, set the pace.  This simple form gives each thread one
// (archive, bin) chain, lanes on neighbouring bins (coalesced 128-byte rows
// per warp), one warp per block so the chains spread over as many SMs as
// there are 32-bin groups, and issues kUnroll rows' loads before their
// dependent adds.  A shared-memory ring fed by bulk asynchronous copies
// would keep far more bytes in flight per chain: later work.
//
// Built by iterative_cleaner_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// into a plain-C shared library loaded with ctypes.  The explicit
// __fmul_rn / __fadd_rn, like -fmad=false, keep each product and sum
// separately rounded, as numpy's loop and the plain PyTorch version do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // one warp per block: 32 neighbouring bins
constexpr int kUnroll = 16;    // rows whose loads are issued ahead

__global__ void __launch_bounds__(kThreads)
ordered_template_kernel(const float* __restrict__ D,
                        const float* __restrict__ w,
                        const float* __restrict__ init,
                        float* __restrict__ out,
                        long long nprof, int nbin) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nbin) return;
  const long long a = blockIdx.y;
  const float* Da = D + a * nprof * (long long)nbin + b;
  const float* wa = w + a * nprof;
  float acc = init != nullptr ? init[a * nbin + b] : 0.0f;
  long long i = 0;
  for (; i + kUnroll <= nprof; i += kUnroll) {
    float d[kUnroll], wv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      d[k] = __ldg(Da + (i + k) * nbin);
      wv[k] = __ldg(wa + i + k);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = __fadd_rn(acc, __fmul_rn(wv[k], d[k]));
  }
  for (; i < nprof; ++i) acc = __fadd_rn(acc, __fmul_rn(__ldg(wa + i), __ldg(Da + i * nbin)));
  out[a * nbin + b] = acc;
}

}  // namespace

extern "C" {

int ordered_template_threads() { return kThreads; }

// Launches on `stream` over `narch` archives (D (narch, nprof, nbin), w
// (narch, nprof), init and out (narch, nbin); init may be null); allocates
// nothing, does not synchronise.  Returns the launch's cudaError_t
// (0 = success).
int ordered_template_launch(const float* D, const float* w, const float* init,
                            float* out, long long nprof, int nbin, int narch,
                            void* stream) {
  const dim3 grid((unsigned)((nbin + kThreads - 1) / kThreads), (unsigned)narch);
  ordered_template_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      D, w, init, out, nprof, nbin);
  return (int)cudaGetLastError();
}

const char* ordered_template_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
