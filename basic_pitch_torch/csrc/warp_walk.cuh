// Warp-synchronous building blocks of the greedy note decode (greedy_decode.cu).
//
// Every function here is called by all 32 lanes of one warp and returns the
// same result in every lane. None of them touches __syncthreads, so warps of
// one block run them on different notes at the same time.
//
// Positions are frames within one pitch row of an (88, T) row-major matrix;
// loads are aligned float4s of the flat array, so a row need not start on a
// 16-byte boundary. A float4 may reach up to 3 floats past the last frame of
// the matrix; the caching allocator rounds every allocation up to 512 bytes,
// so those reads stay inside the allocation and their values are masked.

#pragma once

#include <cuda_runtime.h>

namespace greedy {

constexpr int F = 88;              // pitch rows
constexpr int MIDI_OFFSET = 21;
constexpr int TB = 128;            // frames per level-0 table entry (one walk step)
constexpr int BIG = 2147483647;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -3.402823466e+38f;  // below every finite frame value

__device__ __forceinline__ float4 load4(const float* base, int flat) {
  return *reinterpret_cast<const float4*>(base + flat);
}

__device__ __forceinline__ float elem(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// The greater value wins, then the smaller position (or seed key): numpy's
// first-occurrence argmax, which also makes the first table block win ties.
__device__ __forceinline__ bool better(float v, int t, float v2, int t2) {
  return v > v2 || (v == v2 && t < t2);
}

__device__ __forceinline__ void take(float& v, int& t, float v2, int t2) {
  if (better(v2, t2, v, t)) { v = v2; t = t2; }
}

// Order-preserving map of a float onto uint32 (-0 and +0 map alike), so
// that one redux.sync instruction takes a warp-wide float max.
__device__ __forceinline__ unsigned ord(float v) {
  const unsigned b = __float_as_uint(v + 0.f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// N independent best pairs over the warp, in every lane: a redux.sync max
// of the values, then a redux.sync min of the positions that hold it.
template <int N>
__device__ __forceinline__ void warp_best_n(float (&v)[N], int (&t)[N]) {
  unsigned mu[N];
#pragma unroll
  for (int q = 0; q < N; ++q) mu[q] = __reduce_max_sync(FULL, ord(v[q]));
#pragma unroll
  for (int q = 0; q < N; ++q) {
    t[q] = static_cast<int>(__reduce_min_sync(FULL, ord(v[q]) == mu[q] ? static_cast<unsigned>(t[q]) : static_cast<unsigned>(BIG)));
    v[q] = unord(mu[q]);
  }
}

__device__ __forceinline__ void warp_best(float& v, int& t) {
  float vv[1] = {v};
  int tt[1] = {t};
  warp_best_n<1>(vv, tt);
  v = vv[0];
  t = tt[0];
}

// The float4 of a walk step for this lane, or zeros outside [lo_flat, hi_flat].
__device__ __forceinline__ float4 step_load(const float* row_base, int f, int lo_flat, int hi_flat) {
  if (f + 3 < lo_flat || f > hi_flat || f < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(row_base, f);
}

// A walk's first two steps, loaded before the walk is run.
struct Walk {
  int lo_flat, hi_flat, a0, n_steps;
  float4 cur, nxt;
};

// Forward walk of the row at flat offset row_off of `base` over positions
// t0+1 .. last, 128 frames a step (a float4 per lane). The run-length state
// is the latest above-threshold position, `la`, carried from step to step
// by a warp prefix max; positions <= t0 count as above. The walk stops at
// the first position with `tol` sub-threshold frames since `la`. The loads
// of the next two steps are in flight while a step is decided.
__device__ __forceinline__ Walk forward_begin(const float* base, int row_off, int t0, int last) {
  const int lane = threadIdx.x & 31;
  Walk w;
  w.lo_flat = row_off + t0 + 1;
  w.hi_flat = row_off + last;
  w.a0 = w.lo_flat & ~3;
  w.n_steps = last >= t0 + 1 ? (w.hi_flat - w.a0) / 128 + 1 : 0;
  w.cur = step_load(base, w.a0 + 4 * lane, w.lo_flat, w.hi_flat);
  w.nxt = step_load(base, w.a0 + 128 + 4 * lane, w.lo_flat, w.hi_flat);
  return w;
}

// Runs a walk begun by forward_begin. Returns the exclusive end of
// above-threshold frames; `i_final` is the exclusive end of the visited
// frames.
__device__ int forward_end(const float* base, Walk& w, int row_off, int t0, int last, float thresh, int tol,
                           int& i_final) {
  const int lane = threadIdx.x & 31;
  int la = t0;
  int t_stop = BIG;
  for (int k = 0; k < w.n_steps; ++k) {
    const int p0 = w.a0 + 128 * k + 4 * lane - row_off;
    int lp[4];
    int m = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + j;
      if (p >= t0 + 1 && p <= last && elem(w.cur, j) >= thresh) m = p;
      lp[j] = m;
    }
    int incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = max(incl, n);
    }
    int ex = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) ex = -1;
    const int la_in = max(la, ex);
    int my_stop = BIG;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int p = p0 + j;
      if (p >= t0 + 1 && p <= last && p - max(la_in, lp[j]) >= tol) my_stop = p;
    }
    const unsigned hit = __ballot_sync(FULL, my_stop != BIG);
    if (hit) {
      t_stop = __shfl_sync(FULL, my_stop, __ffs(hit) - 1);
      break;
    }
    la = max(la, __shfl_sync(FULL, incl, 31));
    w.cur = w.nxt;
    w.nxt = step_load(base, w.a0 + 128 * (k + 2) + 4 * lane, w.lo_flat, w.hi_flat);
  }
  if (t_stop != BIG) {
    i_final = t_stop + 1;
    return i_final - tol;
  }
  // no stop: the reference's tail, which keeps the run length at `last`
  i_final = max(t0 + 1, last + 1);
  const int k = (last >= t0 + 1) ? last - la : 0;
  return i_final - k;
}

__device__ __forceinline__ int walk_forward(const float* base, int row_off, int t0, int last, float thresh, int tol,
                                            int& i_final) {
  Walk w = forward_begin(base, row_off, t0, last);
  return forward_end(base, w, row_off, t0, last, thresh, tol, i_final);
}

// Backward walk, the mirror of the forward one, over positions t_mid-1
// down to 1; positions >= t_mid count as above. Lane 31 holds the highest
// frames of a step, and the carried state is the nearest above-threshold
// position, `na`, by a warp suffix min.
__device__ __forceinline__ Walk backward_begin(const float* base, int row_off, int t_mid) {
  const int lane = threadIdx.x & 31;
  Walk w;
  w.lo_flat = row_off + 1;
  w.hi_flat = row_off + t_mid - 1;
  w.a0 = (w.hi_flat & ~3) - 124;  // lane 0's float4 in the first step
  w.n_steps = t_mid - 1 >= 1 ? (w.a0 + 127 - w.lo_flat) / 128 + 1 : 0;
  w.cur = step_load(base, w.a0 + 4 * lane, w.lo_flat, w.hi_flat);
  w.nxt = step_load(base, w.a0 - 128 + 4 * lane, w.lo_flat, w.hi_flat);
  return w;
}

// Runs a walk begun by backward_begin. Returns the inclusive start of
// above-threshold frames; `i_final` is the inclusive end of the walk
// (frames (i_final, t_mid) were visited).
__device__ int backward_end(const float* base, Walk& w, int row_off, int t_mid, float thresh, int tol,
                            int& i_final) {
  const int lane = threadIdx.x & 31;
  int na = t_mid;
  int t_stop = -1;
  for (int k = 0; k < w.n_steps; ++k) {
    const int p0 = w.a0 - 128 * k + 4 * lane - row_off;
    int ls[4];
    int m = BIG;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int p = p0 + j;
      if (p >= 1 && p <= t_mid - 1 && elem(w.cur, j) >= thresh) m = p;
      ls[j] = m;
    }
    int incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_down_sync(FULL, incl, o);
      if (lane + o < 32) incl = min(incl, n);
    }
    int ex = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) ex = BIG;
    const int na_in = min(na, ex);
    int my_stop = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + j;
      if (p >= 1 && p <= t_mid - 1 && min(na_in, ls[j]) - p >= tol) my_stop = p;
    }
    const unsigned hit = __ballot_sync(FULL, my_stop >= 0);
    if (hit) {
      t_stop = __shfl_sync(FULL, my_stop, 31 - __clz(hit));
      break;
    }
    na = min(na, __shfl_sync(FULL, incl, 0));
    w.cur = w.nxt;
    w.nxt = step_load(base, w.a0 - 128 * (k + 2) + 4 * lane, w.lo_flat, w.hi_flat);
  }
  if (t_stop >= 0) {
    i_final = t_stop - 1;
    return i_final + 1 + tol;
  }
  i_final = min(t_mid - 1, 0);
  const int k = (t_mid - 1 >= 1) ? na - 1 : 0;
  return i_final + 1 + k;
}

// Sum of base[lo_flat, hi_flat) over the warp, 512 frames (4 float4 loads
// per lane, all in flight) a pass, accumulated in double so that the
// result does not depend on the summation order at float32 precision.
__device__ float warp_range_sum(const float* __restrict__ base, int lo_flat, int hi_flat) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int f0 = (lo_flat & ~3) + 4 * lane; f0 < hi_flat; f0 += 512) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = f0 + 128 * u < hi_flat ? __ldg(reinterpret_cast<const float4*>(base + f0 + 128 * u))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + 128 * u + j;
        if (f >= lo_flat && f < hi_flat) acc += elem(x[u], j);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return static_cast<float>(acc);
}

// Level-0 table entry of row r, block b, computed by 8 lanes (lane & 7) of
// the warp, so a warp computes 4 entries at once: the max over the block's
// frames and its first position, with the frames in [zlo, zhi) other than
// `keep` read as 0 (the zeroing a note writes). A block spans at most 33
// float4s; each lane loads its (up to) 5 before it compares. All 32 lanes
// must call it; the 8 lanes of a group end with the same result.
constexpr int ENTRY_LANES = 8;

__device__ void masked_entry(const float* residual, int T, int r, int b, int zlo, int zhi, int keep,
                             float& v, int& t) {
  constexpr int LOADS = (TB / 4 + 1 + ENTRY_LANES - 1) / ENTRY_LANES;
  const int sub = threadIdx.x & (ENTRY_LANES - 1);
  const int row_off = r * T;
  const int p_lo = b * TB, p_hi = min(p_lo + TB, T);
  const int a = (row_off + p_lo) & ~3;
  const int n4 = (row_off + p_hi - a + 3) >> 2;
  float4 x[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = sub + ENTRY_LANES * k;
    x[k] = i < n4 ? load4(residual, a + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  v = NEG_INF;
  t = BIG;
#pragma unroll
  for (int k = 0; k < LOADS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = a + 4 * (sub + ENTRY_LANES * k) + j - row_off;
      if (p >= p_lo && p < p_hi) {
        const float y = (p >= zlo && p < zhi && p != keep) ? 0.f : elem(x[k], j);
        if (y > v) { v = y; t = p; }
      }
    }
#pragma unroll
  for (int o = 1; o < ENTRY_LANES; o <<= 1) take(v, t, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, t, o));
}

}  // namespace greedy
