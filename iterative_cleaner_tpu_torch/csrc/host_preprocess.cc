// The port's host preprocess pass: pscrunch, integer dedispersion and
// baseline removal of a raw archive into the float32 cube the loop reads.
//
// It computes what the shared pass ict_preprocess (native/ict_native.cc)
// computes, bit for bit: each profile's pscrunched row rolled by its
// channel's shift, the float64 total profile `total[b] += w * (double)o[b]`
// summed profile after profile in (subint, channel) order, the first
// minimum of the total's circular running means (strict `<`, so a NaN first
// mean keeps start 0), and each row less its float64 window mean, summed in
// window order and truly divided by the width, rounded to float32.  Coherence
// keeps its float32 `pol0 + pol1`.  It is built beside ict_native.cc with the
// same flags (native.py: CXXFLAGS; -march=native and GCC's default
// contraction decide where FMAs fall, alike in both).
//
// The window start depends on the whole total, so the pass reads the data
// twice and writes the output once, each on every core:
//
//   1. the total, partitioned by bins: the bins are cut into ranges of whole
//      cache lines, one a thread; the range's owner reads its slice of every
//      source row (at most two contiguous segments of the row, found from
//      the shift) and adds it to its own float64 totals in (subint, channel)
//      order, so every bin keeps its order of adds; it prefetches the slice a
//      few rows ahead, since its reads jump a row at a time.  Where nbin gives
//      fewer ranges than threads, fewer threads run; where the runtime gives
//      a smaller team than asked (OMP_THREAD_LIMIT, OMP_DYNAMIC, a nested
//      region), each member takes ranges in turn, so every range is summed;
//   2. the window, on one core (nbin values);
//   3. row by row in parallel: the window mean read from the source row (two
//      segments at most), then the output row written as the rolled source
//      less that mean (two segments, no modulo), with AVX by stores that
//      bypass the cache, so the output's lines are not read before they are
//      written.
//
// C API bound by iterative_cleaner_tpu_torch/native.py through ctypes.

#include <omp.h>
#ifdef __AVX__
#include <immintrin.h>
#endif

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

const uint32_t kCoherence = 2;
const uint32_t kLineFloats = 16;  // one 64-byte cache line of floats
const uint32_t kPrefetchRows = 8;

struct Plane {
  const float* data;
  uint32_t npol, nchan, nbin;
  bool sum2;  // Coherence with two or more pols: pol 0 + pol 1

  // Pol 0 of profile (s, c).
  const float* row(size_t s, uint32_t c) const {
    return data + s * ((size_t)npol * nchan * nbin) + (size_t)c * nbin;
  }
  size_t pol_stride() const { return (size_t)nchan * nbin; }
};

uint32_t wrap(int32_t shift, uint32_t nbin) {
  int32_t sh = shift % (int32_t)nbin;
  if (sh < 0) sh += nbin;
  return (uint32_t)sh;
}

// Step 1.  `sh` holds each channel's shift in [0, nbin).  Returns the
// threads that ran it.
int total_by_bins(const Plane& p, const float* weights, const std::vector<uint32_t>& sh,
                  uint32_t nsub, double* total) {
  const uint32_t nbin = p.nbin, nchan = p.nchan;
  const size_t nprof = (size_t)nsub * nchan;
  const int want = std::max(1, std::min(omp_get_max_threads(), (int)(nbin / kLineFloats)));
  uint32_t chunk = (nbin + want - 1) / want;
  chunk = (chunk + kLineFloats - 1) / kLineFloats * kLineFloats;
  const int ranges = (int)((nbin + chunk - 1) / chunk);
  int team = 1;
#pragma omp parallel num_threads(ranges)
  {
    const int n = omp_get_num_threads();
    if (omp_get_thread_num() == 0) team = n;
    for (int q = omp_get_thread_num(); q < ranges; q += n) {  // range q
      const uint32_t b0 = (uint32_t)q * chunk;
      const uint32_t b1 = std::min(nbin, b0 + chunk);
      std::vector<double> own(b1 - b0, 0.0);
      double* t = own.data();  // t[b - b0] is bin b's total
      size_t i = 0;            // the profile (s, c)
      for (uint32_t s = 0; s < nsub; ++s) {
        for (uint32_t c = 0; c < nchan; ++c, ++i) {
          if (i + kPrefetchRows < nprof) {
            const size_t j = i + kPrefetchRows;
            const uint32_t cj = (uint32_t)(j % nchan);
            const float* xj = p.row(j / nchan, cj);
            uint32_t at = b0 + sh[cj];
            for (uint32_t k = b0; k < b1; k += kLineFloats, at += kLineFloats) {
              if (at >= nbin) at -= nbin;
              __builtin_prefetch(xj + at);
            }
          }
          const double w = weights[i];
          const uint32_t r = sh[c], cut = nbin - r;  // output bin b < cut reads source b + r
          const uint32_t mid = std::min(b1, std::max(b0, cut));
          const float* x = p.row(s, c);
          if (p.sum2) {
            const float* y = x + p.pol_stride();
            for (uint32_t b = b0; b < mid; ++b) t[b - b0] += w * (double)(x[b + r] + y[b + r]);
            for (uint32_t b = mid; b < b1; ++b) t[b - b0] += w * (double)(x[b - cut] + y[b - cut]);
          } else {
            for (uint32_t b = b0; b < mid; ++b) t[b - b0] += w * (double)x[b + r];
            for (uint32_t b = mid; b < b1; ++b) t[b - b0] += w * (double)x[b - cut];
          }
        }
      }
      std::copy(own.begin(), own.end(), total + b0);
    }
  }
  return team;
}

// Step 2: ict_preprocess's step 3, as it is written there.
uint32_t window_start(const double* total, uint32_t nbin, uint32_t width) {
  std::vector<double> ext(nbin + width);
  for (uint32_t b = 0; b < nbin + width; ++b) ext[b] = total[b % nbin];
  std::vector<double> csum(nbin + width + 1, 0.0);
  for (uint32_t b = 0; b < nbin + width; ++b) csum[b + 1] = csum[b] + ext[b];
  uint32_t start = 0;
  double best = (csum[width] - csum[0]) / width;
  for (uint32_t b = 1; b < nbin; ++b) {
    double m = (csum[b + width] - csum[b]) / width;
    if (m < best) { best = m; start = b; }
  }
  return start;
}

// o[b] = (float)((double)v[b] - mean) for b < n, where v = x, or x + y in
// float32; with AVX, 8 at a time by stores that bypass the cache wherever o
// is 32-byte aligned (the same conversions and subtraction, so the same bits).
inline void subtract_segment(const float* x, const float* y, double mean, float* o,
                             uint32_t n) {
  uint32_t b = 0;
#ifdef __AVX__
  for (; b < n && ((uintptr_t)(o + b) & 31); ++b)
    o[b] = (float)((double)(y ? x[b] + y[b] : x[b]) - mean);
  const __m256d m = _mm256_set1_pd(mean);
  for (; b + 8 <= n; b += 8) {
    __m256 v = _mm256_loadu_ps(x + b);
    if (y) v = _mm256_add_ps(v, _mm256_loadu_ps(y + b));
    const __m256d lo = _mm256_sub_pd(_mm256_cvtps_pd(_mm256_castps256_ps128(v)), m);
    const __m256d hi = _mm256_sub_pd(_mm256_cvtps_pd(_mm256_extractf128_ps(v, 1)), m);
    _mm256_stream_ps(o + b, _mm256_set_m128(_mm256_cvtpd_ps(hi), _mm256_cvtpd_ps(lo)));
  }
#endif
  if (y) {
    for (; b < n; ++b) o[b] = (float)((double)(x[b] + y[b]) - mean);
  } else {
    for (; b < n; ++b) o[b] = (float)((double)x[b] - mean);
  }
}

// Step 3 for one profile: x its pol 0, y its pol 1 or null, r its shift.
inline void baseline_row(const float* x, const float* y, uint32_t nbin, uint32_t r,
                         uint32_t start, uint32_t width, float* o) {
  uint32_t j0 = start + r;  // the window's first source bin
  if (j0 >= nbin) j0 -= nbin;
  const uint32_t first = std::min(width, nbin - j0);
  double acc = 0.0;
  if (y) {
    for (uint32_t k = 0; k < first; ++k) acc += (double)(x[j0 + k] + y[j0 + k]);
    for (uint32_t k = first; k < width; ++k) acc += (double)(x[k - first] + y[k - first]);
  } else {
    for (uint32_t k = 0; k < first; ++k) acc += (double)x[j0 + k];
    for (uint32_t k = first; k < width; ++k) acc += (double)x[k - first];
  }
  const double mean = acc / width;
  const uint32_t cut = nbin - r;
  subtract_segment(x + r, y ? y + r : nullptr, mean, o, cut);
  subtract_segment(x, y, mean, o + cut, r);
}

}  // namespace

extern "C" {

// Arguments as ict_preprocess takes them, with a window of 1 to nbin bins (0
// reads as 1).  Returns the threads the pass ran on, the fewer of the teams
// that ran its two parallel steps (at least 1), or -1 for a window wider than
// nbin.
int ict_host_preprocess(const float* data, const float* weights, const int32_t* shifts,
                        uint32_t nsub, uint32_t npol, uint32_t nchan, uint32_t nbin,
                        uint32_t state, uint32_t baseline_width, float* out) {
  const uint32_t width = baseline_width ? baseline_width : 1;
  if (width > nbin && nbin > 0) return -1;
  const size_t nprof = (size_t)nsub * nchan;
  if (nprof == 0 || nbin == 0) return 1;
  const Plane p{data, npol, nchan, nbin, npol > 1 && state == kCoherence};
  std::vector<uint32_t> sh(nchan);
  for (uint32_t c = 0; c < nchan; ++c) sh[c] = wrap(shifts[c], nbin);

  std::vector<double> total(nbin, 0.0);
  const int bin_team = total_by_bins(p, weights, sh, nsub, total.data());
  const uint32_t start = window_start(total.data(), nbin, width);

  int row_team = 1;
#pragma omp parallel num_threads((int)std::min<size_t>(omp_get_max_threads(), nprof))
  {
    if (omp_get_thread_num() == 0) row_team = omp_get_num_threads();
#pragma omp for collapse(2) schedule(static)
    for (uint32_t s = 0; s < nsub; ++s) {
      for (uint32_t c = 0; c < nchan; ++c) {
        const float* x = p.row(s, c);
        baseline_row(x, p.sum2 ? x + p.pol_stride() : nullptr, nbin, sh[c], start, width,
                     out + ((size_t)s * nchan + c) * nbin);
      }
    }
#ifdef __AVX__
    _mm_sfence();  // the streamed stores, before the region's closing barrier
#endif
  }
  return std::min(bin_team, row_team);
}

}  // extern "C"
