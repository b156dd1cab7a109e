// Exact 3-D squared Euclidean distance transform (Felzenszwalb-Huttenlocher,
// separable lower-envelope algorithm), the native workhorse behind
// tpustomp/world/edt.py.
//
// Reference equivalent: the arm_navigation `distance_field` package's
// PropagationDistanceField (C++), which the reference planner's collision
// space queries (SURVEY.md §3.2). That implementation propagates distances
// incrementally cell-by-cell; this one computes the exact EDT in three O(n)
// separable passes, parallelized across lines with std::thread — offline
// host work whose output grid ships to the device once per scene.
//
// Build: see native/Makefile (g++ -O3 -shared). ABI: plain C, used via ctypes.

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// 1-D squared distance transform of sampled function f (length n), with
// +inf entries allowed (they never contribute to the envelope).
// d[i] = min_j ( (i-j)^2 + f[j] ).  v/z are caller-provided scratch.
void dt1d(const double* f, int n, double* d, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    if (f[q] >= kInf) continue;  // parabola at +inf never wins
    while (true) {
      int p = v[k];
      double s;
      if (f[p] >= kInf) {
        s = -kInf;  // finite parabola dominates an infinite one everywhere
      } else {
        s = ((f[q] + (double)q * q) - (f[p] + (double)p * p)) /
            (2.0 * (q - p));
      }
      if (s <= z[k]) {
        if (k == 0) {  // replace the lone (infinite) parabola
          v[0] = q;
          z[0] = -kInf;
          z[1] = kInf;
          break;
        }
        --k;
      } else {
        ++k;
        v[k] = q;
        z[k] = s;
        z[k + 1] = kInf;
        break;
      }
    }
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    int p = v[k];
    double dq = q - p;
    d[q] = f[p] >= kInf ? kInf : dq * dq + f[p];
  }
}

struct Dims { int nx, ny, nz; };

// Apply dt1d along the given axis (0=x,1=y,2=z) of grid g (row-major x,y,z),
// processing the [lo, hi) slab of lines on this thread.
void pass_axis(double* g, Dims dim, int axis, long lo, long hi) {
  const int n = axis == 0 ? dim.nx : (axis == 1 ? dim.ny : dim.nz);
  std::vector<double> f(n), d(n), z(n + 1);
  std::vector<int> v(n);
  const long sy = dim.nz;            // stride of y
  const long sx = (long)dim.ny * dim.nz;
  for (long line = lo; line < hi; ++line) {
    long base;
    long stride;
    if (axis == 2) {                 // vary z; line indexes (x,y)
      base = line * dim.nz;
      stride = 1;
    } else if (axis == 1) {          // vary y; line indexes (x,z)
      long x = line / dim.nz, zz = line % dim.nz;
      base = x * sx + zz;
      stride = sy;
    } else {                         // vary x; line indexes (y,z)
      base = line;                   // (y*nz + z)
      stride = sx;
    }
    bool any = false;
    for (int i = 0; i < n; ++i) {
      f[i] = g[base + i * stride];
      if (f[i] < kInf) any = true;
    }
    if (!any) continue;
    dt1d(f.data(), n, d.data(), v.data(), z.data());
    for (int i = 0; i < n; ++i) g[base + i * stride] = d[i];
  }
}

void run_parallel(double* g, Dims dim, int axis, long nlines) {
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = std::max(1L, std::min<long>(hw ? hw : 1, nlines));
  if (nthreads == 1) {
    pass_axis(g, dim, axis, 0, nlines);
    return;
  }
  std::vector<std::thread> ts;
  long chunk = (nlines + nthreads - 1) / nthreads;
  for (long t = 0; t < nthreads; ++t) {
    long lo = t * chunk, hi = std::min(nlines, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(pass_axis, g, dim, axis, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// seed: nx*ny*nz uint8 (1 = seed voxel). out: squared distance in voxels^2
// to the nearest seed (inf encoded as 1e30 if no seeds at all).
void edt_sq_3d(const uint8_t* seed, double* out, int nx, int ny, int nz) {
  Dims dim{nx, ny, nz};
  const long total = (long)nx * ny * nz;
  for (long i = 0; i < total; ++i) out[i] = seed[i] ? 0.0 : kInf;
  run_parallel(out, dim, 2, (long)nx * ny);  // along z
  run_parallel(out, dim, 1, (long)nx * nz);  // along y
  run_parallel(out, dim, 0, (long)ny * nz);  // along x
  for (long i = 0; i < total; ++i)
    if (!(out[i] < kInf)) out[i] = 1e30;
}

}  // extern "C"
