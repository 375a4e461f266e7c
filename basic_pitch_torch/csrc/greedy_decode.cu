// Greedy note decode (onset stage + melodia stage) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` of
// basic_pitch_tpu/decode/pallas_kernel.py (launched by pallas_greedy_stages),
// and computes what it computes; the plain PyTorch version of the same two
// stages is `decode_plain` in basic_pitch_torch/decode/device.py.
//
// What bounds it: latency, not bytes or operations. The greedy algorithm is
// sequential across notes (each note zeroes residual energy the next one
// sees), and each note is a short chain of dependent steps: walk a row
// forward (and, in melodia, backward) until `energy_tol` consecutive
// sub-threshold frames, zero up to three rows, refresh the block tables, sum
// an amplitude. The bytes it must move are the two (T, 88) input matrices
// read once (up to ~13 MB at T = 18176, ~4 us at 3.35 TB/s); the time goes
// to the chain of dependent steps per note (memory round trips and warp
// reductions, one after another), and on dense material to melodia, which
// takes one iteration per scrap of energy above the threshold.
//
// What this design does about it. One block of 32 warps decodes one
// recording (one launch), and the chain per note is kept inside one warp:
// - Walks, amplitude sums and table refreshes are warp-synchronous
//   (warp_walk.cuh): a walk step covers 128 frames with one float4 per lane,
//   carries its run-length state by a warp prefix max (min backward), finds
//   the stop with a ballot, and has the next two steps' loads in flight;
//   argmaxes are two redux.sync instructions. No __syncthreads is taken
//   inside a note.
// - Several notes are in flight, one per warp, and are committed in the
//   reference order with a conservative test, so the result stays exact:
//   * Stage 1 walks up to 32 onset candidates at once on the residual as
//     it stands when the batch begins. Candidate j is committed unless an
//     earlier kept note i of the batch, |f_i - f_j| <= 1, zeroes frames
//     [t0_i, end_i) that meet j's visited frames [t0_j + 1, i_final_j). The
//     first such j and all after it are walked again in the next batch.
//   * Melodia takes the longest prefix of the rows in argmax order (peak
//     desc, then seed key t*88 + f asc) whose rows are pairwise >= 3 apart
//     and above the threshold, so their rows and zeroing bands are
//     disjoint. Every seed walks on its own warp and works out, before
//     anything is written, what its rows will hold once it is applied (from
//     the tables and a masked re-read of the blocks it zeroes; its "stash").
//     Seed k is committed if it still outranks the rows that seeds 0..k-1
//     leave behind; seed 0 always is. The first seed that fails and all
//     after it are dropped. Warps 1..c then apply the c committed seeds
//     from their stashes while warp 0 chooses the next batch from the row
//     aggregates, which the stashes bring up to date, so a batch costs two
//     block barriers.
//   meta[3] counts the candidates and seeds walked again or dropped.
// - The block tables live on chip: a level-0 entry holds the max and first
//   position of one row over 128 frames (one walk step, so a short note
//   touches one or two entries per row), a level-1 entry the same over a
//   group of G level-0 entries, with G the smallest power of two >= 32 that
//   leaves at most 32 groups per row. A row's max is then one warp
//   reduction over its groups. The tables cover the frames before t_end
//   only (the wrapper zeroes the padding after it, which then can neither
//   seed nor win a tie), or all T frames when the threshold is negative.
//   Level 1 always fits in shared memory (at most 88 x 32 x 8 B); level 0
//   (88 x ceil(t_end/128) x 8 B) is placed in dynamic shared memory when
//   both fit in 216 KB (t_end up to about 36 000 frames) and in global
//   memory (L2) otherwise. Ties keep the first position.
//
// Built by basic_pitch_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from basic_pitch_torch/decode/greedy_kernel.py.

#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

using namespace greedy;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int DYN_SMEM_BUDGET = 216 * 1024;  // with the static part, within the 227 KB a block may use
constexpr int STASH = 12;                    // level-0 entries a melodia seed keeps for its commit

static_assert(WARPS == 32, "a batch holds one note per warp, committed by the lanes of one warp");

struct Tables {
  float* residual;       // (F, T) residual energy, updated in place
  int T, nb, G, ng;
  float* bmax;           // level 0 (F, nb): block max
  int* btf;              //   and its first position
  float* gmax;           // level 1 (F, ng): group max
  int* gtf;              //   and its first position
};

// What a melodia seed leaves behind in rows r0 = max(f-1, 0) .. r0+2,
// computed before anything is written: each row's new max (for the commit
// test and the row aggregates) and, when the zeroed span stays within one
// level-1 group and touches at most STASH level-0 entries, the new entries
// and group values, so that applying the seed reads no memory.
struct Stash {
  float ev[STASH];       // level-0 entries, e = q * nbt + (b - b0)
  int et[STASH];
  float gv[3];           // the touched group of row r0 + q
  int gt[3];
  float rv[3];           // row r0 + q: max and seed key (first position * F + row)
  int rk[3];
  int n;                 // entries stashed, or -1: applying recomputes them
};

// The seeds of one melodia batch, chosen by warp 0. Two of them alternate,
// so warp 0 chooses the next batch while the other warps apply this one.
struct Batch {
  int row[WARPS];        // seed row
  int t_mid[WARPS];      // seed frame
  float peak[WARPS];     // seed value
  int key[WARPS];        // seed key t_mid * F + row
  int n;                 // seeds
  int stop;              // no seed above the threshold, or the iteration cap
  int it;                // melodia iterations before this batch
};

// One slot per warp: a stage-1 candidate or a melodia seed of the batch.
struct Shared {
  float rowmax[F];       // melodia: row max and seed key (t * F + row), kept by warp 0
  int rowkey[F];
  int row[WARPS];        // stage 1: pitch row
  int start[WARPS];      // note start (stage 1: t0)
  int end[WARPS];        // note end (exclusive)
  int i_final[WARPS];    // stage 1: end of the visited frames
  int keep[WARPS];       // stage 1: kept as a note
  float amp[WARPS];
  int lo[WARPS];         // melodia: zeroed frames [lo, hi)
  int hi[WARPS];
  Stash stash[WARPS];
  Batch batch[2];
  int n_commit;
};

__device__ __forceinline__ void clear3(float (&v)[3], int (&t)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) { v[q] = NEG_INF; t[q] = BIG; }
}

// Best level-0 entry of rows r0.. (up to 3) over blocks [b_lo, b_hi), into
// this lane's running bests.
__device__ __forceinline__ void take_blocks(const Tables& tb, int r0, int nrows, int b_lo, int b_hi,
                                            float (&v)[3], int (&t)[3]) {
  for (int b = b_lo + (threadIdx.x & 31); b < b_hi; b += 32) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < nrows) take(v[q], t[q], tb.bmax[(r0 + q) * tb.nb + b], tb.btf[(r0 + q) * tb.nb + b]);
  }
}

// The level-1 entries of rows r0.. (up to 3) outside groups [g_lo, g_hi],
// into this lane's running bests (one group per lane).
__device__ __forceinline__ void take_groups(const Tables& tb, int r0, int nrows, int g_lo, int g_hi,
                                            float (&v)[3], int (&t)[3]) {
  const int lane = threadIdx.x & 31;
  if (lane < tb.ng && (lane < g_lo || lane > g_hi)) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < nrows) take(v[q], t[q], tb.gmax[(r0 + q) * tb.ng + lane], tb.gtf[(r0 + q) * tb.ng + lane]);
  }
}

// Masked re-read of blocks [b0, b1] of rows r0..r0+nrows-1 (4 entries a
// pass) into this lane's running bests; each entry also goes to `ev`/`et`
// (index q * nbt + b - b0) when given, and to level 0 with `to_table`.
__device__ __forceinline__ void masked_blocks(const Tables& tb, int r0, int nrows, int b0, int b1, int zlo, int zhi,
                                              int center, int t_mid, float* ev, int* et, bool to_table,
                                              float (&v)[3], int (&t)[3]) {
  const int lane = threadIdx.x & 31;
  const int nbt = b1 - b0 + 1, total = nrows * nbt;
  for (int e0 = 0; e0 < total; e0 += 32 / ENTRY_LANES) {
    const int e = e0 + lane / ENTRY_LANES;
    const bool active = e < total;
    const int ee = active ? e : 0;
    const int q = ee / nbt, r = r0 + q, b = b0 + ee % nbt;
    float bv;
    int bt;
    masked_entry(tb.residual, tb.T, r, b, zlo, zhi, r == center ? -1 : t_mid, bv, bt);
    if (active) {
      if (lane % ENTRY_LANES == 0) {
        if (ev) { ev[e] = bv; et[e] = bt; }
        if (to_table) { tb.bmax[r * tb.nb + b] = bv; tb.btf[r * tb.nb + b] = bt; }
      }
#pragma unroll
      for (int qq = 0; qq < 3; ++qq)
        if (qq == q) take(v[qq], t[qq], bv, bt);
    }
  }
}

// Fills the seed's stash: rows f-1..f+1 once the seed at (f, t_mid) zeroes
// [lo, hi), from the tables and a masked re-read of the touched blocks.
// Nothing outside the stash is written.
__device__ void rows_after(const Tables& tb, int f, int lo, int hi, int t_mid, Stash& st) {
  const int lane = threadIdx.x & 31;
  const int r0 = max(f - 1, 0), nrows = min(f + 1, F - 1) - r0 + 1;
  const int b0 = lo / TB, b1 = (hi - 1) / TB, g0 = b0 / tb.G, g1 = b1 / tb.G;
  const int total = nrows * (b1 - b0 + 1);
  const bool fits = g0 == g1 && total <= STASH;
  // v[0..2]: the touched groups; v[3..5]: the whole rows
  float v[6], gv[3], rv[3];
  int t[6], gt[3], rt[3];
  clear3(gv, gt);
  clear3(rv, rt);
  take_blocks(tb, r0, nrows, g0 * tb.G, b0, gv, gt);
  take_blocks(tb, r0, nrows, b1 + 1, min((g1 + 1) * tb.G, tb.nb), gv, gt);
  masked_blocks(tb, r0, nrows, b0, b1, lo, hi, f, t_mid, fits ? st.ev : nullptr, st.et, false, gv, gt);
  take_groups(tb, r0, nrows, g0, g1, rv, rt);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    take(rv[q], rt[q], gv[q], gt[q]);
    v[q] = gv[q]; t[q] = gt[q];
    v[3 + q] = rv[q]; t[3 + q] = rt[q];
  }
  warp_best_n<6>(v, t);
  if (lane < 3) {
    const int q = lane;
    const float gq = q == 0 ? v[0] : q == 1 ? v[1] : v[2];
    const int gtq = q == 0 ? t[0] : q == 1 ? t[1] : t[2];
    const float rq = q == 0 ? v[3] : q == 1 ? v[4] : v[5];
    const int rtq = q == 0 ? t[3] : q == 1 ? t[4] : t[5];
    st.gv[q] = gq;
    st.gt[q] = gtq;
    st.rv[q] = q < nrows ? rq : NEG_INF;
    st.rk[q] = q < nrows ? rtq * F + r0 + q : BIG;
  }
  if (lane == 0) st.n = fits ? total : -1;
}

// Apply a melodia seed: zero rows f-1..f+1 over [lo, hi) (the side rows
// keep t_mid), then write the touched level-0 and level-1 entries, from the
// stash when it holds them. The rows' aggregates are in the stash already.
__device__ void apply_seed(const Tables& tb, const Shared& s, int f, int t_mid, int w) {
  const int lane = threadIdx.x & 31;
  const int lo = s.lo[w], hi = s.hi[w];
  const int r0 = max(f - 1, 0), r1 = min(f + 1, F - 1), nrows = r1 - r0 + 1;
  for (int r = r0; r <= r1; ++r) {
    float* rr = tb.residual + r * tb.T;
    for (int p = lo + lane; p < hi; p += 32)
      if (r == f || p != t_mid) rr[p] = 0.f;
  }
  const int b0 = lo / TB, b1 = (hi - 1) / TB, nbt = b1 - b0 + 1;
  const Stash& st = s.stash[w];
  if (st.n >= 0) {
    const int g = b0 / tb.G;
    if (lane < st.n) {
      const int r = r0 + lane / nbt, b = b0 + lane % nbt;
      tb.bmax[r * tb.nb + b] = st.ev[lane];
      tb.btf[r * tb.nb + b] = st.et[lane];
    }
    if (lane < nrows) {
      tb.gmax[(r0 + lane) * tb.ng + g] = st.gv[lane];
      tb.gtf[(r0 + lane) * tb.ng + g] = st.gt[lane];
    }
    return;
  }
  float v[3], gv[3];
  int t[3], gt[3];
  clear3(v, t);
  masked_blocks(tb, r0, nrows, b0, b1, lo, hi, f, t_mid, nullptr, nullptr, true, v, t);
  __syncwarp();
  for (int g = b0 / tb.G; g <= b1 / tb.G; ++g) {
    clear3(gv, gt);
    take_blocks(tb, r0, nrows, g * tb.G, min((g + 1) * tb.G, tb.nb), gv, gt);
    warp_best_n<3>(gv, gt);
    if (lane < nrows) {
      tb.gmax[(r0 + lane) * tb.ng + g] = lane == 0 ? gv[0] : lane == 1 ? gv[1] : gv[2];
      tb.gtf[(r0 + lane) * tb.ng + g] = lane == 0 ? gt[0] : lane == 1 ? gt[1] : gt[2];
    }
  }
}

// Bit r of a 96-bit row set held in three registers (0 outside 0..F-1).
__device__ __forceinline__ bool in_set(unsigned w0, unsigned w1, unsigned w2, int r) {
  if (r < 0 || r >= F) return false;
  const unsigned w = r < 32 ? w0 : r < 64 ? w1 : w2;
  return (w >> (r & 31)) & 1u;
}

// Warp 0 chooses a melodia batch from the row aggregates: the longest
// prefix of the argmax order with rows >= 3 apart and peaks above the
// threshold.
__device__ void choose_batch(const Shared& s, Batch& bt, float thresh, int it, int max_iters, int& overflow) {
  const int lane = threadIdx.x & 31;
  float rv[3];
  int rk[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int r = lane + 32 * q;
    rv[q] = r < F ? s.rowmax[r] : NEG_INF;
    rk[q] = r < F ? s.rowkey[r] : BIG;
  }
  unsigned w0 = 0u, w1 = 0u, w2 = 0u;  // rows taken
  int m = 0;
  while (m < WARPS) {
    float v = NEG_INF;
    int k = BIG;
    if (!((w0 >> lane) & 1u)) take(v, k, rv[0], rk[0]);
    if (!((w1 >> lane) & 1u)) take(v, k, rv[1], rk[1]);
    if (!((w2 >> lane) & 1u)) take(v, k, rv[2], rk[2]);
    warp_best(v, k);
    if (!(v > thresh)) break;
    const int r = k % F;
    if (in_set(w0, w1, w2, r - 2) || in_set(w0, w1, w2, r - 1) || in_set(w0, w1, w2, r + 1) ||
        in_set(w0, w1, w2, r + 2))
      break;
    if (lane == 0) {
      bt.row[m] = r; bt.t_mid[m] = k / F; bt.peak[m] = v; bt.key[m] = k;
    }
    const unsigned bit = 1u << (r & 31);
    if (r < 32) w0 |= bit; else if (r < 64) w1 |= bit; else w2 |= bit;
    ++m;
  }
  if (m > 0 && it >= max_iters) overflow = 1;  // cut with energy left
  if (lane == 0) {
    bt.n = m;
    bt.stop = m == 0 || it >= max_iters;
    bt.it = it;
  }
}

// Both tables and the row aggregates from the whole residual, by all warps.
__device__ void build_tables(const Tables& tb, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int PER_WARP = 32 / ENTRY_LANES;
  const int total = F * tb.nb;
  for (int e0 = warp * PER_WARP; e0 < total; e0 += WARPS * PER_WARP) {
    const int e = e0 + lane / ENTRY_LANES;
    const int ee = e < total ? e : 0;
    float v;
    int t;
    masked_entry(tb.residual, tb.T, ee / tb.nb, ee % tb.nb, 0, 0, -1, v, t);
    if (e < total && lane % ENTRY_LANES == 0) {
      tb.bmax[ee] = v;
      tb.btf[ee] = t;
    }
  }
  __syncthreads();
  for (int pair = warp; pair < F * tb.ng; pair += WARPS) {
    const int r = pair / tb.ng, g = pair % tb.ng;
    float v = NEG_INF;
    int t = BIG;
    for (int b = g * tb.G + lane; b < min((g + 1) * tb.G, tb.nb); b += 32) take(v, t, tb.bmax[r * tb.nb + b], tb.btf[r * tb.nb + b]);
    warp_best(v, t);
    if (lane == 0) {
      tb.gmax[pair] = v;
      tb.gtf[pair] = t;
    }
  }
  __syncthreads();
  for (int r = warp; r < F; r += WARPS) {
    float v = NEG_INF;
    int t = BIG;
    if (lane < tb.ng) take(v, t, tb.gmax[r * tb.ng + lane], tb.gtf[r * tb.ng + lane]);
    warp_best(v, t);
    if (lane == 0) {
      s.rowmax[r] = v;
      s.rowkey[r] = t * F + r;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) greedy_decode_kernel(
    const float* __restrict__ frames,  // (F, T) preprocessed frames, read-only
    float* residual,                   // (F, T) residual energy, starts as frames
    const int* __restrict__ order,     // (k,) flat onset ids, reference order
    const int* __restrict__ n_onsets,  // () candidates to visit
    float* bmax_global, int* btf_global,  // (F, nb) level 0 when it is not on chip
    int* notes,                        // (max_notes, 4) start, end, pitch, amp bits
    int* meta,                         // (4,) count, overflow, melodia iters, re-walks
    int T, int t_end, int min_note_len, int tol, int max_notes,
    int max_melodia_iters, int melodia_on, float thresh, int nb, int G, int ng, int l0_shared) {
  __shared__ Shared s;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  // the kernel's tallies; warp 0's copies are the ones written out
  int count = 0, overflow = 0, it = 0, rewalks = 0;

  // ---------------- stage 1: onset-anchored notes ----------------
  const int n_cand = *n_onsets;
  for (int i = 0; i < n_cand;) {
    const int n_b = min(WARPS, n_cand - i);
    if (warp < n_b) {
      const int flat = order[i + warp];
      const int t0 = flat / F, f = flat % F;
      int end = 0, i_final = -1, keep = 0;
      float amp = 0.f;
      if (!(flat < 0 || t0 >= t_end - 1)) {
        end = walk_forward(residual, f * T, t0, t_end - 2, thresh, tol, i_final);
        keep = end - t0 > min_note_len;
        if (keep) amp = warp_range_sum(frames, f * T + t0, f * T + end) / (float)max(end - t0, 1);
      }
      if (lane == 0) {
        s.row[warp] = f; s.start[warp] = t0; s.end[warp] = end;
        s.i_final[warp] = i_final; s.keep[warp] = keep; s.amp[warp] = amp;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // candidate `lane` is walked again if an earlier kept note of the
      // batch zeroed frames it visited; the kept notes' slots come by shuffle
      const bool in_batch = lane < n_b;
      const int f = in_batch ? s.row[lane] : -8, t0 = in_batch ? s.start[lane] : 0;
      const int end = in_batch ? s.end[lane] : 0, i_final = in_batch ? s.i_final[lane] : -1;
      const int keep = in_batch && s.keep[lane];
      bool invalid = false;
      for (unsigned kept_before = __ballot_sync(FULL, keep); kept_before; kept_before &= kept_before - 1) {
        const int j = __ffs(kept_before) - 1;
        const int fj = __shfl_sync(FULL, f, j), t0j = __shfl_sync(FULL, t0, j), endj = __shfl_sync(FULL, end, j);
        if (j < lane && abs(fj - f) <= 1 && t0j < i_final && endj > t0 + 1) invalid = true;
      }
      const unsigned bad = __ballot_sync(FULL, invalid);
      const int c = bad ? __ffs(bad) - 1 : n_b;
      const bool is_note = lane < c && keep;
      const unsigned kept = __ballot_sync(FULL, is_note);
      const int idx = count + __popc(kept & below);
      if (is_note && idx < max_notes) {
        int* out = notes + (size_t)idx * 4;
        out[0] = t0; out[1] = end; out[2] = f + MIDI_OFFSET;
        out[3] = __float_as_int(s.amp[lane]);
      }
      if (__ballot_sync(FULL, is_note && idx >= max_notes)) overflow = 1;
      count += __popc(kept);
      rewalks += n_b - c;
      if (lane == 0) s.n_commit = c;
    }
    __syncthreads();
    const int c = s.n_commit;
    if (warp < c && s.keep[warp]) {
      const int f = s.row[warp], t0 = s.start[warp], end = s.end[warp];
      for (int r = max(f - 1, 0); r <= min(f + 1, F - 1); ++r)
        for (int p = t0 + lane; p < end; p += 32) residual[r * T + p] = 0.f;
    }
    __syncthreads();
    i += c;
  }

  // ---------------- stage 2: melodia ----------------
  if (melodia_on) {
    Tables tb;
    tb.residual = residual;
    tb.T = T;
    tb.nb = nb;
    tb.G = G;
    tb.ng = ng;
    tb.gmax = reinterpret_cast<float*>(dyn);
    tb.gtf = reinterpret_cast<int*>(dyn + sizeof(float) * F * ng);
    if (l0_shared) {
      tb.bmax = reinterpret_cast<float*>(dyn + 2 * sizeof(float) * F * ng);
      tb.btf = reinterpret_cast<int*>(dyn + 2 * sizeof(float) * F * ng + sizeof(float) * F * tb.nb);
    } else {
      tb.bmax = bmax_global;
      tb.btf = btf_global;
    }
    build_tables(tb, s);

    if (warp == 0) choose_batch(s, s.batch[0], thresh, it, max_melodia_iters, overflow);
    __syncthreads();

    for (int cur = 0; !s.batch[cur].stop; cur ^= 1) {
      const Batch& bt = s.batch[cur];
      const int m = bt.n;

      // walks, one seed per warp, and the rows each seed leaves behind
      if (warp < m) {
        const int f = bt.row[warp], t_mid = bt.t_mid[warp];
        // the walks treat t_mid itself as above threshold, so its own value
        // (zeroed by the reference before the walks) never matters
        Walk fw = forward_begin(residual, f * T, t_mid, t_end - 2);
        Walk bw = backward_begin(residual, f * T, t_mid);
        int fwd_final, bwd_final;
        const int fwd_end = forward_end(residual, fw, f * T, t_mid, t_end - 2, thresh, tol, fwd_final);
        const int bwd_start = backward_end(residual, bw, f * T, t_mid, thresh, tol, bwd_final);
        const int lo = bwd_final + 1, hi = fwd_final;
        const int i_start = bwd_start, i_end = fwd_end - 1;
        float amp = 0.f;
        if (i_end - i_start > min_note_len)
          amp = warp_range_sum(frames, f * T + i_start, f * T + i_end) / (float)max(i_end - i_start, 1);
        rows_after(tb, f, lo, hi, t_mid, s.stash[warp]);
        if (lane == 0) {
          s.lo[warp] = lo; s.hi[warp] = hi; s.start[warp] = i_start; s.end[warp] = i_end; s.amp[warp] = amp;
        }
      }
      __syncthreads();

      if (warp <= m) {
        // commit in order: seed k while it still outranks what seeds 0..k-1
        // leave (warps 0..m reach the same count; warp 0 keeps the tallies
        // and chooses the next batch while warps 1..c apply this one)
        bool invalid = false;
        const bool in_batch = lane < m;
        const float pv = in_batch ? bt.peak[lane] : 0.f;
        const int pk = in_batch ? bt.key[lane] : 0;
        float av[3];
        int ak[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          av[q] = in_batch ? s.stash[lane].rv[q] : NEG_INF;
          ak[q] = in_batch ? s.stash[lane].rk[q] : BIG;
        }
        for (int j = 0; j < m - 1; ++j)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float vj = __shfl_sync(FULL, av[q], j);
            const int kj = __shfl_sync(FULL, ak[q], j);
            if (j < lane && in_batch && better(vj, kj, pv, pk)) invalid = true;
          }
        const unsigned bad = __ballot_sync(FULL, invalid);
        const int c = min(bad ? __ffs(bad) - 1 : m, max_melodia_iters - bt.it);
        if (warp == 0) {
          const bool is_note = lane < c && s.end[lane] - s.start[lane] > min_note_len;
          const unsigned kept = __ballot_sync(FULL, is_note);
          const int idx = count + __popc(kept & below);
          if (is_note && idx < max_notes) {
            int* out = notes + (size_t)idx * 4;
            out[0] = s.start[lane]; out[1] = s.end[lane]; out[2] = bt.row[lane] + MIDI_OFFSET;
            out[3] = __float_as_int(s.amp[lane]);
          }
          if (__ballot_sync(FULL, is_note && idx >= max_notes)) overflow = 1;
          count += __popc(kept);
          it += c;
          rewalks += m - c;
          // the committed seeds' rows, from their stashes, then the next batch
          for (int l = lane; l < 3 * c; l += 32) {
            const int j = l / 3, q = l % 3, r = max(bt.row[j] - 1, 0) + q;
            if (r <= min(bt.row[j] + 1, F - 1)) {
              s.rowmax[r] = s.stash[j].rv[q];
              s.rowkey[r] = s.stash[j].rk[q];
            }
          }
          __syncwarp();
          choose_batch(s, s.batch[cur ^ 1], thresh, it, max_melodia_iters, overflow);
          if (c == WARPS) apply_seed(tb, s, bt.row[WARPS - 1], bt.t_mid[WARPS - 1], WARPS - 1);
        } else if (warp <= c) {
          apply_seed(tb, s, bt.row[warp - 1], bt.t_mid[warp - 1], warp - 1);
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    meta[0] = count;
    meta[1] = overflow;
    meta[2] = it;
    meta[3] = rewalks;
  }
}

}  // namespace

extern "C" int greedy_decode_launch(const float* frames, float* residual, const int* order,
                                    const int* n_onsets, float* bmax, int* btf, int* notes,
                                    int* meta, int T, int t_end, int min_note_len, int tol,
                                    int max_notes, int max_melodia_iters, int melodia_on,
                                    float thresh, void* stream) {
  // Frames past t_end are zero, and melodia seeds only above thresh: with
  // thresh >= 0 no seed, walk or zeroing reaches past t_end, so the tables
  // stop there. A negative thresh seeds the zeroed padding too.
  const int t_tab = thresh >= 0.f ? t_end : T;
  const int nb = (t_tab + TB - 1) / TB;
  int G = 32;
  while ((nb + G - 1) / G > 32) G *= 2;
  const int ng = (nb + G - 1) / G;
  const size_t l1 = 2 * sizeof(float) * F * ng, l0 = 2 * sizeof(float) * F * (size_t)nb;
  const int l0_shared = l1 + l0 <= DYN_SMEM_BUDGET;
  const size_t bytes = l1 + (l0_shared ? l0 : 0);
  cudaError_t err = cudaFuncSetAttribute(greedy_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_decode_kernel<<<1, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      frames, residual, order, n_onsets, bmax, btf, notes, meta, T, t_end, min_note_len, tol,
      max_notes, max_melodia_iters, melodia_on, thresh, nb, G, ng, l0_shared);
  return static_cast<int>(cudaGetLastError());
}
