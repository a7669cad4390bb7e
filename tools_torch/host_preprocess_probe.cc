// Design variants of the host preprocess pass, timed step by step, for
// tools_torch/host_preprocess_probe.py.  Built by that probe with the flags of
// iterative_cleaner_tpu_torch/native.py (CXXFLAGS); not part of the package.
//
// Every variant computes what native/ict_native.cc's ict_preprocess computes,
// bit for bit: the pscrunched row rolled by its channel's shift, the float64
// total profile summed profile after profile in (subint, channel) order, the
// first-minimum window of its running means, and each row less its float64
// window mean, rounded to float32.  They differ in how often each byte
// crosses memory and on how many cores:
//
//   probe_old       the shared pass with timers: a modulo-indexed roll into
//                   the output, the total on one core, a modulo-indexed
//                   window mean and the subtract in place;
//   probe_fused     each thread owns a range of bins, rolls every profile's
//                   slice of them into the output as contiguous copies and
//                   adds it to its own totals; then the subtract in place;
//   probe_split     a row-parallel roll of two contiguous copies a profile,
//                   then the total partitioned by bins over the output, then
//                   the subtract in place;
//   probe_deferred  the total partitioned by bins read straight from the
//                   source rows (no output yet), then one row-parallel pass
//                   that rolls, takes the window mean and writes the output.
//
// The design the package took, the deferred pass with no division a row in
// its total and the output written by stores that bypass the cache, is
// iterative_cleaner_tpu_torch/csrc/host_preprocess.cc, which the probe times
// through the package's own library.
//
// steps[0..3] receive seconds: old (roll, total, window, subtract); fused
// (roll and total, -, window, subtract); split (roll, total, window,
// subtract); deferred (-, total, window, roll and subtract).  Each returns
// the number of threads its bin-partitioned step ran on (old: 1).

#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint32_t kCoherence = 2;
const uint32_t kLineFloats = 16;  // one 64-byte cache line of floats

uint32_t wrap(int32_t shift, uint32_t nbin) {
  int32_t sh = shift % (int32_t)nbin;
  if (sh < 0) sh += nbin;
  return (uint32_t)sh;
}

// The shared pass's step 3, verbatim.
uint32_t window_start(const std::vector<double>& total, uint32_t nbin, uint32_t width) {
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

struct Plane {
  const float* data;
  uint32_t npol, nchan, nbin;
  bool sum2;  // Coherence with two or more pols: pol 0 + pol 1
  const float* row(size_t s, uint32_t c) const {
    return data + s * (size_t)npol * nchan * nbin + (size_t)c * nbin;
  }
  size_t pol_stride() const { return (size_t)nchan * nbin; }
};

// Rows ahead whose slice the bin-partitioned total prefetches (0: none).
int g_prefetch_rows = 0;

// Bin ranges of whole cache lines, one a thread, at least a line each.
uint32_t bin_chunk(uint32_t nbin, int* threads) {
  int t = std::max(1, std::min(omp_get_max_threads(), (int)(nbin / kLineFloats)));
  uint32_t chunk = (nbin + t - 1) / t;
  chunk = (chunk + kLineFloats - 1) / kLineFloats * kLineFloats;
  *threads = (int)((nbin + chunk - 1) / chunk);
  return chunk;
}

// total[b] += w * v over rows, where v is row element (b + sh) of the source
// (rolled == false) or element b of the already rolled output.
void total_by_bins(const Plane& p, const float* rolled, const float* weights,
                   const int32_t* shifts, uint32_t nsub, std::vector<double>& total,
                   int* threads) {
  const uint32_t nbin = p.nbin, nchan = p.nchan;
  int nt;
  const uint32_t chunk = bin_chunk(nbin, &nt);
  *threads = nt;
#pragma omp parallel num_threads(nt)
  // Ranges in turn, so a team smaller than nt still sums them all.
  for (int q = omp_get_thread_num(); q < nt; q += omp_get_num_threads()) {
    const uint32_t b0 = (uint32_t)q * chunk;
    const uint32_t b1 = std::min(nbin, b0 + chunk);
    std::vector<double> t(b1 - b0, 0.0);
    double* tp = t.data();
    for (uint32_t s = 0; s < nsub; ++s) {
      for (uint32_t c = 0; c < nchan; ++c) {
        const double w = weights[(size_t)s * nchan + c];
        if (rolled) {
          const float* o = rolled + ((size_t)s * nchan + c) * nbin;
          for (uint32_t b = b0; b < b1; ++b) tp[b - b0] += w * (double)o[b];
          continue;
        }
        const uint32_t sh = wrap(shifts[c], nbin);
        const float* x = p.row(s, c);
        const float* y = x + p.pol_stride();
        if (g_prefetch_rows) {
          const size_t ahead = (size_t)s * nchan + c + g_prefetch_rows;
          if (ahead < (size_t)nsub * nchan) {
            const uint32_t ca = ahead % nchan;
            const float* xa = p.row(ahead / nchan, ca);
            const uint32_t sa = wrap(shifts[ca], nbin);
            for (uint32_t k = 0; k < b1 - b0; k += kLineFloats)
              __builtin_prefetch(xa + (b0 + sa + k) % nbin);
          }
        }
        const uint32_t cut = nbin - sh;  // output bins below cut read x[b + sh]
        const uint32_t e0 = std::min(b1, std::max(b0, cut));
        if (p.sum2) {
          for (uint32_t b = b0; b < e0; ++b) tp[b - b0] += w * (double)(x[b + sh] + y[b + sh]);
          for (uint32_t b = e0; b < b1; ++b) tp[b - b0] += w * (double)(x[b - cut] + y[b - cut]);
        } else {
          for (uint32_t b = b0; b < e0; ++b) tp[b - b0] += w * (double)x[b + sh];
          for (uint32_t b = e0; b < b1; ++b) tp[b - b0] += w * (double)x[b - cut];
        }
      }
    }
    std::copy(t.begin(), t.end(), total.begin() + b0);
  }
}

// out = the row rolled, as two contiguous copies.
inline void roll_row(const Plane& p, const float* x, uint32_t sh, float* o) {
  const uint32_t nbin = p.nbin, cut = nbin - sh;
  if (p.sum2) {
    const float* y = x + p.pol_stride();
    for (uint32_t b = 0; b < cut; ++b) o[b] = x[b + sh] + y[b + sh];
    for (uint32_t b = cut; b < nbin; ++b) o[b] = x[b - cut] + y[b - cut];
  } else {
    std::memcpy(o, x + sh, cut * sizeof(float));
    std::memcpy(o + cut, x, sh * sizeof(float));
  }
}

// Each rolled row of `out` less its mean over the window at `start`.
void subtract_in_place(float* out, size_t nprof, uint32_t nbin, uint32_t start,
                       uint32_t width) {
  const uint32_t first = std::min(width, nbin - start);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < nprof; ++i) {
    float* o = out + i * nbin;
    double acc = 0.0;
    for (uint32_t k = 0; k < first; ++k) acc += (double)o[start + k];
    for (uint32_t k = first; k < width; ++k) acc += (double)o[k - first];
    const double mean = acc / width;
    for (uint32_t b = 0; b < nbin; ++b) o[b] = (float)((double)o[b] - mean);
  }
}

}  // namespace

extern "C" {

int probe_old(const float* data, const float* weights, const int32_t* shifts,
              uint32_t nsub, uint32_t npol, uint32_t nchan, uint32_t nbin,
              uint32_t state, uint32_t baseline_width, float* out, double* steps) {
  const size_t prof_stride = nbin;
  const size_t chan_stride = (size_t)npol * nchan * nbin;
  double t0 = omp_get_wtime();
#pragma omp parallel for collapse(2) schedule(static)
  for (uint32_t s = 0; s < nsub; ++s) {
    for (uint32_t c = 0; c < nchan; ++c) {
      const float* p0 = data + (size_t)s * chan_stride + (size_t)c * nbin;
      const float* p1 = p0 + (size_t)nchan * nbin;
      float* o = out + ((size_t)s * nchan + c) * prof_stride;
      int32_t sh = shifts[c] % (int32_t)nbin;
      if (sh < 0) sh += nbin;
      for (uint32_t b = 0; b < nbin; ++b) {
        uint32_t src = (b + (uint32_t)sh) % nbin;
        float v = p0[src];
        if (npol > 1 && state == kCoherence) v += p1[src];
        o[b] = v;
      }
    }
  }
  double t1 = omp_get_wtime();
  std::vector<double> total(nbin, 0.0);
  for (uint32_t s = 0; s < nsub; ++s)
    for (uint32_t c = 0; c < nchan; ++c) {
      const double w = weights[(size_t)s * nchan + c];
      const float* o = out + ((size_t)s * nchan + c) * prof_stride;
      for (uint32_t b = 0; b < nbin; ++b) total[b] += w * (double)o[b];
    }
  double t2 = omp_get_wtime();
  uint32_t width = baseline_width ? baseline_width : 1;
  uint32_t start = window_start(total, nbin, width);
  double t3 = omp_get_wtime();
#pragma omp parallel for collapse(2) schedule(static)
  for (uint32_t s = 0; s < nsub; ++s) {
    for (uint32_t c = 0; c < nchan; ++c) {
      float* o = out + ((size_t)s * nchan + c) * prof_stride;
      double acc = 0.0;
      for (uint32_t k = 0; k < width; ++k) acc += (double)o[(start + k) % nbin];
      const double mean = acc / width;
      for (uint32_t b = 0; b < nbin; ++b) o[b] = (float)((double)o[b] - mean);
    }
  }
  double t4 = omp_get_wtime();
  steps[0] = t1 - t0; steps[1] = t2 - t1; steps[2] = t3 - t2; steps[3] = t4 - t3;
  return 1;
}

int probe_fused(const float* data, const float* weights, const int32_t* shifts,
                uint32_t nsub, uint32_t npol, uint32_t nchan, uint32_t nbin,
                uint32_t state, uint32_t baseline_width, float* out, double* steps) {
  const Plane p{data, npol, nchan, nbin, npol > 1 && state == kCoherence};
  const uint32_t width = baseline_width ? baseline_width : 1;
  std::vector<double> total(nbin, 0.0);
  int nt;
  const uint32_t chunk = bin_chunk(nbin, &nt);
  double t0 = omp_get_wtime();
#pragma omp parallel num_threads(nt)
  // Ranges in turn, so a team smaller than nt still sums them all.
  for (int q = omp_get_thread_num(); q < nt; q += omp_get_num_threads()) {
    const uint32_t b0 = (uint32_t)q * chunk;
    const uint32_t b1 = std::min(nbin, b0 + chunk);
    std::vector<double> t(b1 - b0, 0.0);
    double* tp = t.data();
    for (uint32_t s = 0; s < nsub; ++s) {
      for (uint32_t c = 0; c < nchan; ++c) {
        const double w = weights[(size_t)s * nchan + c];
        const uint32_t sh = wrap(shifts[c], nbin);
        const float* x = p.row(s, c);
        const float* y = x + p.pol_stride();
        float* o = out + ((size_t)s * nchan + c) * nbin;
        const uint32_t cut = nbin - sh;
        const uint32_t e0 = std::min(b1, std::max(b0, cut));
        if (p.sum2) {
          for (uint32_t b = b0; b < e0; ++b) o[b] = x[b + sh] + y[b + sh];
          for (uint32_t b = e0; b < b1; ++b) o[b] = x[b - cut] + y[b - cut];
        } else {
          if (e0 > b0) std::memcpy(o + b0, x + b0 + sh, (e0 - b0) * sizeof(float));
          if (b1 > e0) std::memcpy(o + e0, x + e0 - cut, (b1 - e0) * sizeof(float));
        }
        for (uint32_t b = b0; b < b1; ++b) tp[b - b0] += w * (double)o[b];
      }
    }
    std::copy(t.begin(), t.end(), total.begin() + b0);
  }
  double t1 = omp_get_wtime();
  const uint32_t start = window_start(total, nbin, width);
  double t2 = omp_get_wtime();
  subtract_in_place(out, (size_t)nsub * nchan, nbin, start, width);
  double t3 = omp_get_wtime();
  steps[0] = t1 - t0; steps[1] = 0.0; steps[2] = t2 - t1; steps[3] = t3 - t2;
  return nt;
}

int probe_split(const float* data, const float* weights, const int32_t* shifts,
                uint32_t nsub, uint32_t npol, uint32_t nchan, uint32_t nbin,
                uint32_t state, uint32_t baseline_width, float* out, double* steps) {
  const Plane p{data, npol, nchan, nbin, npol > 1 && state == kCoherence};
  const uint32_t width = baseline_width ? baseline_width : 1;
  double t0 = omp_get_wtime();
#pragma omp parallel for collapse(2) schedule(static)
  for (uint32_t s = 0; s < nsub; ++s)
    for (uint32_t c = 0; c < nchan; ++c)
      roll_row(p, p.row(s, c), wrap(shifts[c], nbin), out + ((size_t)s * nchan + c) * nbin);
  double t1 = omp_get_wtime();
  std::vector<double> total(nbin, 0.0);
  int nt;
  total_by_bins(p, out, weights, shifts, nsub, total, &nt);
  double t2 = omp_get_wtime();
  const uint32_t start = window_start(total, nbin, width);
  double t3 = omp_get_wtime();
  subtract_in_place(out, (size_t)nsub * nchan, nbin, start, width);
  double t4 = omp_get_wtime();
  steps[0] = t1 - t0; steps[1] = t2 - t1; steps[2] = t3 - t2; steps[3] = t4 - t3;
  return nt;
}

int probe_deferred(const float* data, const float* weights, const int32_t* shifts,
                   uint32_t nsub, uint32_t npol, uint32_t nchan, uint32_t nbin,
                   uint32_t state, uint32_t baseline_width, float* out, double* steps) {
  const Plane p{data, npol, nchan, nbin, npol > 1 && state == kCoherence};
  const uint32_t width = baseline_width ? baseline_width : 1;
  double t0 = omp_get_wtime();
  std::vector<double> total(nbin, 0.0);
  int nt;
  total_by_bins(p, nullptr, weights, shifts, nsub, total, &nt);
  double t1 = omp_get_wtime();
  const uint32_t start = window_start(total, nbin, width);
  double t2 = omp_get_wtime();
#pragma omp parallel for collapse(2) schedule(static)
  for (uint32_t s = 0; s < nsub; ++s) {
    for (uint32_t c = 0; c < nchan; ++c) {
      const uint32_t sh = wrap(shifts[c], nbin);
      const float* x = p.row(s, c);
      const float* y = x + p.pol_stride();
      float* o = out + ((size_t)s * nchan + c) * nbin;
      // The window over the rolled row starts at source element j0.
      const uint32_t j0 = (start + sh) % nbin;
      const uint32_t first = std::min(width, nbin - j0);
      double acc = 0.0;
      if (p.sum2) {
        for (uint32_t k = 0; k < first; ++k) acc += (double)(x[j0 + k] + y[j0 + k]);
        for (uint32_t k = first; k < width; ++k) acc += (double)(x[k - first] + y[k - first]);
      } else {
        for (uint32_t k = 0; k < first; ++k) acc += (double)x[j0 + k];
        for (uint32_t k = first; k < width; ++k) acc += (double)x[k - first];
      }
      const double mean = acc / width;
      const uint32_t cut = nbin - sh;
      if (p.sum2) {
        for (uint32_t b = 0; b < cut; ++b) o[b] = (float)((double)(x[b + sh] + y[b + sh]) - mean);
        for (uint32_t b = cut; b < nbin; ++b) o[b] = (float)((double)(x[b - cut] + y[b - cut]) - mean);
      } else {
        for (uint32_t b = 0; b < cut; ++b) o[b] = (float)((double)x[b + sh] - mean);
        for (uint32_t b = cut; b < nbin; ++b) o[b] = (float)((double)x[b - cut] - mean);
      }
    }
  }
  double t3 = omp_get_wtime();
  steps[0] = 0.0; steps[1] = t1 - t0; steps[2] = t2 - t1; steps[3] = t3 - t2;
  return nt;
}

void probe_set_prefetch(int rows) { g_prefetch_rows = rows; }

// Fault in a fresh output: every thread writes zeros over its share.
int probe_touch(float* out, size_t n) {
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i += 1024) out[i] = 0.0f;
  return omp_get_max_threads();
}

}  // extern "C"
