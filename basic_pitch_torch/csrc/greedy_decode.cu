// Greedy note decode (onset stage + melodia stage) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` of
// basic_pitch_tpu/decode/pallas_kernel.py (launched by pallas_greedy_stages),
// and computes what it computes; the plain PyTorch version of the same two
// stages is `decode_plain` in basic_pitch_torch/decode/device.py.
//
// What bounds it: latency, not bytes or operations. The greedy algorithm is
// sequential across notes (each note zeroes residual energy the next one
// sees), and each note is a short chain of dependent steps: read a candidate,
// scan a row forward (and, in melodia, backward) until `energy_tol`
// consecutive sub-threshold frames, zero up to three rows, refresh the block
// tables, sum an amplitude. The bytes it must move are the two (T, 88) input
// matrices read once (~13 MB at T = 18176, ~4 us at 3.35 TB/s); the time goes
// to the chain of block-wide barriers and global-memory round trips per note.
//
// What this design does about it: one thread block of 1024 threads runs the
// whole decode, so every step is a block-wide parallel pass over up to 1024
// frames separated by __syncthreads, with no second launch and no host round
// trip per note. The forward walk is a block-wide prefix max of
// `above ? pos : -1` (warp shuffles, then shared memory across the 32 warps),
// carried chunk to chunk, with an early exit at the first chunk holding a
// stop; the backward walk is the mirrored prefix min. Melodia's global argmax
// (ties: smallest t, then smallest f) reads per-row maxima and first
// positions derived from per-(row, 1024-frame block) tables in global memory
// (88 x ceil(T/1024) entries, L2-resident), and only the blocks a note
// touched are recomputed, so the seed search does not grow with T. The
// residual matrix lives in global memory and is updated in place. Running
// several notes at once, or spreading the work over the card's SMs, is left
// for later work.
//
// Built by basic_pitch_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from basic_pitch_torch/decode/greedy_kernel.py.

#include <cuda_runtime.h>

namespace {

constexpr int F = 88;               // pitch rows
constexpr int THREADS = 1024;       // one block; also the scan chunk width
constexpr int WARPS = THREADS / 32;
constexpr int TBLOCK = 1024;        // frames per block-table entry
constexpr int MIDI_OFFSET = 21;
constexpr int BIG = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

static_assert(WARPS == 32, "the cross-warp scan step runs in one warp");

struct Shared {
  int scan[WARPS];
  int red[WARPS];
  float redf[WARPS];
  int res;
  float resf;
  float rowmax[F];
  int tfirst[F];
  int seed_key;
  float seed_peak;
};

// Block-wide inclusive scan in thread order (max or min). Returns the
// thread's prefix and, in `total`, the whole block's value. Ends with no
// pending hazard on s.scan only after the caller's next __syncthreads.
template <bool IS_MAX>
__device__ __forceinline__ int block_scan(int v, Shared& s, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = IS_MAX ? max(v, n) : min(v, n);
  }
  if (lane == 31) s.scan[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = s.scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int n = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t = IS_MAX ? max(t, n) : min(t, n);
    }
    s.scan[lane] = t;
  }
  __syncthreads();
  if (wid > 0) {
    int p = s.scan[wid - 1];
    v = IS_MAX ? max(v, p) : min(v, p);
  }
  total = s.scan[WARPS - 1];
  return v;
}

// Block-wide min of an int. Safe to call back to back with block_scan: it
// only touches s.red / s.res, and it ends with a barrier after the read.
__device__ __forceinline__ int block_min(int v, Shared& s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) s.red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = s.red[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = min(t, __shfl_xor_sync(FULL, t, o));
    if (lane == 0) s.res = t;
  }
  __syncthreads();
  int r = s.res;
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, Shared& s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) s.redf[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = s.redf[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    if (lane == 0) s.resf = t;
  }
  __syncthreads();
  float r = s.resf;
  __syncthreads();
  return r;
}

// Forward walk from t0+1 over positions <= t_end-2: the first position with
// `tol` consecutive sub-threshold frames stops it. Returns the exclusive end
// of above-threshold frames; `i_final` is the exclusive end of visited frames.
__device__ int forward_scan(const float* row, int t0, float thresh, int tol, int t_end,
                            Shared& s, int& i_final) {
  const int last = t_end - 2;
  int la = t0;  // latest above-threshold position (positions <= t0 count as above)
  int t_stop = BIG;
  for (int c0 = t0 + 1; c0 <= last; c0 += THREADS) {
    const int p = c0 + threadIdx.x;
    const bool in = p <= last;
    int v = (in && row[p] >= thresh) ? p : -1;
    int total;
    int m = block_scan<true>(v, s, total);
    int lap = max(la, m);
    int stop = block_min((in && p - lap >= tol) ? p : BIG, s);
    if (stop != BIG) {
      t_stop = stop;
      break;
    }
    la = max(la, total);
  }
  if (t_stop != BIG) {
    i_final = t_stop + 1;
    return i_final - tol;
  }
  i_final = max(t0 + 1, t_end - 1);
  const int k = (last >= t0 + 1) ? last - la : 0;
  return i_final - k;
}

// Backward walk from t_mid-1 down to 1, the mirror of forward_scan. Returns
// the inclusive start of above-threshold frames; `i_final` is the inclusive
// end of the walk (frames (i_final, t_mid) were visited).
__device__ int backward_scan(const float* row, int t_mid, float thresh, int tol,
                             Shared& s, int& i_final) {
  int na = t_mid;  // next above-threshold position (positions >= t_mid count as above)
  int t_stop = -1;
  for (int c0 = t_mid - 1; c0 >= 1; c0 -= THREADS) {
    const int p = c0 - (int)threadIdx.x;
    const bool in = p >= 1;
    int v = (in && row[p] >= thresh) ? p : BIG;
    int total;
    int m = block_scan<false>(v, s, total);  // thread order = descending positions
    int nap = min(na, m);
    int stop_tid = block_min((in && nap - p >= tol) ? (int)threadIdx.x : BIG, s);
    if (stop_tid != BIG) {
      t_stop = c0 - stop_tid;
      break;
    }
    na = min(na, total);
  }
  if (t_stop >= 0) {
    i_final = t_stop - 1;
    return i_final + 1 + tol;
  }
  i_final = min(t_mid - 1, 0);
  const int k = (t_mid - 1 >= 1) ? na - 1 : 0;
  return i_final + 1 + k;
}

// Sum of frames[freq, lo:hi) over the block.
__device__ float span_sum(const float* frow, int lo, int hi, Shared& s) {
  float acc = 0.f;
  for (int p = lo + threadIdx.x; p < hi; p += THREADS) acc += frow[p];
  return block_sum(acc, s);
}

// One warp recomputes table entry (r, b): the block max and the first
// position achieving it.
__device__ void table_entry(const float* residual, int T, int nb, int r, int b,
                            float* bmax, int* btf) {
  const int lane = threadIdx.x & 31;
  const float* row = residual + (size_t)r * T;
  const int lo = b * TBLOCK, hi = min(lo + TBLOCK, T);
  float m = -3.4e38f;
  int t = BIG;
  for (int p = lo + lane; p < hi; p += 32) {
    float x = row[p];
    if (x > m) { m = x; t = p; }  // ascending p per lane: first occurrence kept
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float m2 = __shfl_xor_sync(FULL, m, o);
    int t2 = __shfl_xor_sync(FULL, t, o);
    if (m2 > m || (m2 == m && t2 < t)) { m = m2; t = t2; }
  }
  if (lane == 0) {
    bmax[(size_t)r * nb + b] = m;
    btf[(size_t)r * nb + b] = t;
  }
}

// Row max and first position of row r from its table entries (one thread).
__device__ void row_from_tables(const float* bmax, const int* btf, int nb, int r, Shared& s) {
  float m = bmax[(size_t)r * nb];
  int t = btf[(size_t)r * nb];
  for (int b = 1; b < nb; ++b) {
    float x = bmax[(size_t)r * nb + b];
    if (x > m) { m = x; t = btf[(size_t)r * nb + b]; }  // first block wins ties
  }
  s.rowmax[r] = m;
  s.tfirst[r] = t;
}

__global__ void __launch_bounds__(THREADS, 1) greedy_decode_kernel(
    const float* __restrict__ frames,  // (F, T) preprocessed frames, read-only
    float* residual,                   // (F, T) residual energy, starts as frames
    const int* __restrict__ order,     // (k,) flat onset ids, reference order
    const int* __restrict__ n_onsets,  // () candidates to visit
    float* bmax, int* btf,             // (F, nb) block tables
    int* notes,                        // (max_notes, 4) start, end, pitch, amp bits
    int* meta,                         // (4,) count, overflow, melodia iters, 0
    int T, int t_end, int min_note_len, int tol, int max_notes,
    int max_melodia_iters, int melodia_on, float thresh) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  int count = 0;      // kept notes, also past max_notes (uniform)
  int overflow = 0;   // uniform

  // ---------------- stage 1: onset-anchored notes ----------------
  const int n_cand = *n_onsets;
  for (int i = 0; i < n_cand; ++i) {
    const int flat = order[i];
    const int t0 = flat / F, freq = flat % F;
    if (flat < 0 || t0 >= t_end - 1) continue;
    int i_final;
    const int end = forward_scan(residual + (size_t)freq * T, t0, thresh, tol, t_end, s, i_final);
    if (end - t0 <= min_note_len) continue;
    const int r0 = max(freq - 1, 0), r1 = min(freq + 1, F - 1);
    for (int r = r0; r <= r1; ++r)
      for (int p = t0 + tid; p < end; p += THREADS) residual[(size_t)r * T + p] = 0.f;
    const float amp = span_sum(frames + (size_t)freq * T, t0, end, s) / (float)max(end - t0, 1);
    if (count < max_notes) {
      if (tid == 0) {
        int* out = notes + (size_t)count * 4;
        out[0] = t0; out[1] = end; out[2] = freq + MIDI_OFFSET; out[3] = __float_as_int(amp);
      }
    } else {
      overflow = 1;
    }
    ++count;
  }
  __syncthreads();

  // ---------------- stage 2: melodia ----------------
  int it = 0;
  if (melodia_on) {
    const int nb = (T + TBLOCK - 1) / TBLOCK;
    const int warp = tid >> 5, lane = tid & 31;
    for (int e = warp; e < F * nb; e += WARPS) table_entry(residual, T, nb, e / nb, e % nb, bmax, btf);
    __syncthreads();
    if (tid < F) row_from_tables(bmax, btf, nb, tid, s);
    __syncthreads();

    while (true) {
      // global argmax in numpy's row-major (t, then f) tie order
      if (warp == 0) {
        float peak = -3.4e38f;
        for (int r = lane; r < F; r += 32) peak = fmaxf(peak, s.rowmax[r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) peak = fmaxf(peak, __shfl_xor_sync(FULL, peak, o));
        int key = BIG;
        for (int r = lane; r < F; r += 32)
          if (s.rowmax[r] == peak) key = min(key, s.tfirst[r] * F + r);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
        if (lane == 0) { s.seed_peak = peak; s.seed_key = key; }
      }
      __syncthreads();
      const float peak = s.seed_peak;
      const int key = s.seed_key;
      __syncthreads();
      if (!(peak > thresh)) break;
      if (it >= max_melodia_iters) {  // cut with energy left
        overflow = 1;
        break;
      }
      const int t_mid = key / F, freq = key % F;
      const float* row = residual + (size_t)freq * T;
      // the walks treat t_mid itself as above threshold, so its own value
      // (zeroed by the reference before the walks) never matters
      int fwd_final, bwd_final;
      const int fwd_end = forward_scan(row, t_mid, thresh, tol, t_end, s, fwd_final);
      const int bwd_start = backward_scan(row, t_mid, thresh, tol, s, bwd_final);
      const int lo = bwd_final + 1, hi = fwd_final;  // zeroed region, contains t_mid

      const int r0 = max(freq - 1, 0), r1 = min(freq + 1, F - 1);
      for (int r = r0; r <= r1; ++r) {
        float* rr = residual + (size_t)r * T;
        for (int p = lo + tid; p < hi; p += THREADS)
          if (r == freq || p != t_mid) rr[p] = 0.f;
      }
      __syncthreads();
      // refresh the touched table entries, then those rows' aggregates
      const int b0 = lo / TBLOCK, b1 = (hi - 1) / TBLOCK;
      const int nbt = b1 - b0 + 1, nrows = r1 - r0 + 1;
      for (int e = warp; e < nrows * nbt; e += WARPS)
        table_entry(residual, T, nb, r0 + e / nbt, b0 + e % nbt, bmax, btf);
      __syncthreads();
      if (tid <= r1 - r0) row_from_tables(bmax, btf, nb, r0 + tid, s);
      __syncthreads();

      const int i_start = bwd_start, i_end = fwd_end - 1;
      if (i_end - i_start > min_note_len) {
        const float amp =
            span_sum(frames + (size_t)freq * T, i_start, i_end, s) / (float)max(i_end - i_start, 1);
        if (count < max_notes) {
          if (tid == 0) {
            int* out = notes + (size_t)count * 4;
            out[0] = i_start; out[1] = i_end; out[2] = freq + MIDI_OFFSET; out[3] = __float_as_int(amp);
          }
        } else {
          overflow = 1;
        }
        ++count;
      }
      ++it;
    }
  }
  if (tid == 0) {
    meta[0] = count;
    meta[1] = overflow;
    meta[2] = it;
    meta[3] = 0;
  }
}

}  // namespace

extern "C" int greedy_decode_launch(const float* frames, float* residual, const int* order,
                                    const int* n_onsets, float* bmax, int* btf, int* notes,
                                    int* meta, int T, int t_end, int min_note_len, int tol,
                                    int max_notes, int max_melodia_iters, int melodia_on,
                                    float thresh, void* stream) {
  greedy_decode_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, residual, order, n_onsets, bmax, btf, notes, meta, T, t_end, min_note_len, tol,
      max_notes, max_melodia_iters, melodia_on, thresh);
  return static_cast<int>(cudaGetLastError());
}
