// Flat grids over the vectors of a data-movement kernel's output, shared by
// paged.cu (page gather, row scatters) and routing.cu (MoD row gather and
// gated scatter-add). A Python plan (kernels/paged.py::flat_plan,
// kernels/routing.py::dispatch_plan) picks the vector width, the vectors a
// thread and the grid before launch; each entry point checks that plan
// with flat_grid_ok and refuses one it cannot run.
#pragma once

#include <limits.h>
#include <stdint.h>

// threads of every flat-grid block (kernels/paged.py: GATHER_THREADS)
constexpr int FLAT_THREADS = 256;

// the raw vector type of VEC bytes
template <int VEC>
struct Vec;
template <>
struct Vec<16> {
  typedef uint4 type;
};
template <>
struct Vec<4> {
  typedef uint32_t type;
};
template <>
struct Vec<2> {
  typedef unsigned short type;
};
template <>
struct Vec<1> {
  typedef unsigned char type;
};

// n / d for a divisor d fixed for a launch, as a multiply-high and two
// shifts (Granlund and Montgomery's round-up method; the constants are set
// on the host): a 32-bit division is a dozen dependent instructions,
// which a flat grid would pay per vector on its critical path. 64-bit
// vector indices (a wide grid) divide plainly.
struct FastDiv {
  unsigned d, m, l;  // l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1
  explicit FastDiv(unsigned divisor) : d(divisor), m(0), l(0) {
    while ((1ull << l) < d) ++l;
    m = (unsigned)((((1ull << l) - d) << 32) / d + 1);
  }
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    if (l == 0) return n;  // d == 1
    const unsigned t = __umulhi(n, m);
    return (t + ((n - t) >> 1)) >> (l - 1);
  }
  __device__ __forceinline__ unsigned long long operator()(unsigned long long n) const {
    return n / d;
  }
};

// Whether blocks of FLAT_THREADS x unroll vectors cover n_vec vectors as a
// plan says: the fewest blocks that do (at least one, at most INT_MAX), and
// 64-bit vector indices exactly when the grid reaches past 2^32 - 1.
inline bool flat_grid_ok(long long n_vec, int unroll, long long blocks, int wide) {
  const long long per_block = (long long)FLAT_THREADS * unroll;
  return blocks >= 1 && blocks <= INT_MAX && blocks == (n_vec + per_block - 1) / per_block &&
         wide == (blocks * per_block > (long long)UINT_MAX);
}
