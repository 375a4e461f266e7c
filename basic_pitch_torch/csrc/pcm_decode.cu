// Device half of the lossless PCM16 transport codec (ops/pcmcodec.py): one
// packed piece (its wire buffer, see pcmcodec.to_wire) -> float32 samples
// equal to pcm / 32768 bit for bit.
//
// Replaces the JAX package's decode programs (basic_pitch_tpu/ops/
// pcmcodec.py: _unpack_scatter_fn, _finish_fn, _finish_lpc_fn), which XLA
// ran as a chain of small programs: a dense unpack per bit-width group, a
// scatter into a residual buffer, then `order` int32 cumsums or a lax.scan
// of the LPC recurrence x[n] = r[n] + ((sum_j c_j x[n-j]) >> s), 248
// sequential steps. There is no Pallas kernel behind it; on the card the
// recurrence in plain PyTorch is ~4000 tiny launches per piece, so the whole
// decode is this one kernel.
//
// Bound: bytes. A 128-window chunk moves ~6.7 MB of wire in and 18.5 MB of
// float32 out (~7.5 us at 3.35 TB/s); the integer work is ~10 operations a
// sample (fixed orders) or ~25 (LPC). A CTA takes 32 consecutive stream
// rows (codec blocks). Rows lie back to back in the words buffer across
// group edges, so the CTA stages its rows' words into shared memory as one
// span of 16-byte cp.async copies (coalesced, no registers held), then:
//
// - fixed orders 1-3: a warp decodes one block at a time. Lane l holds
//   samples 8l .. 8l+7: it reads its residuals from shared memory through a
//   64-bit bit reservoir, and the block's order-`order` differences with
//   zero history (the heads' differences, then the residuals) are
//   integrated by `order` passes of a two-level int32 prefix sum: 8 in
//   registers, then the lane totals by a warp scan (__shfl_up_sync). Integer
//   addition is associative, so the scan gives the sequential cumsum's bits.
//   Each lane writes its 8 samples as two 16-byte stores (a warp writes the
//   block's 1 KB in one go). The 32 rows are staged in two halves, both
//   copies in flight at once; the first half is decoded while the second
//   lands.
// - LPC (order 8): the floor shift makes the recurrence sequential, so one
//   thread decodes one block, a one-warp CTA 32 blocks. The seven older
//   products are summed off the dependent chain, which is one multiply-add,
//   the shift and the add a sample. Samples go through a 32 x 33 shared tile
//   and out as 16-byte stores of 4 blocks' rows at a time.
//
// The accumulators are int32: exact, since the partial sums of the fixed
// orders are differences of int16 samples (|.| < 2^18) and the LPC's
// |sum c_j x| < 2^30 by the packer's sum|c| <= 32767 contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;      // samples per codec block
constexpr int kLpcOrder = 8;     // pcmcodec.LPC_ORDER
constexpr int kMaxGroups = 18;   // len(pcmcodec.KSET)
constexpr int kMaxK = 19;        // max(pcmcodec.KSET)
constexpr int kRows = 32;        // stream rows (blocks) per CTA
constexpr int kFixedWarps = 4;   // warps per fixed-order CTA
constexpr int kStages = 2;       // staged halves of a fixed-order CTA's rows
constexpr int kStageRows = kRows / kStages;
// 16-byte alignment of a span's start and end, and the bit reservoir's
// read of one word past a row, stay inside this slack
constexpr int kSlack = 8;
constexpr int kFixedStageWords = kStageRows * (((kBlock - 1) * kMaxK + 31) / 32) + kSlack;
constexpr int kLpcStageWords = kRows * (((kBlock - kLpcOrder) * kMaxK + 31) / 32) + kSlack;

struct Group {
    int k;         // residual width in bits
    int word_off;  // first word of the group's rows
    int row0;      // first stream row of the group
    int slot0;     // first idx slot of the group (idx is bucket-padded per group)
};

__device__ __forceinline__ int words_per_row(int k, int order) { return ((kBlock - order) * k + 31) >> 5; }

__device__ __forceinline__ int32_t sign_extend(uint32_t v, int k) {
    return (int32_t)(v << (32 - k)) >> (32 - k);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying words [w0, w1) of `words` (16-byte aligned) into `dst` (at
// most `cap` words); returns the index in `dst` of word w0.
__device__ __forceinline__ int stage_span(uint32_t* dst, int cap, const uint32_t* __restrict__ words, int w0, int w1,
                                          int tid, int nthreads) {
    const int a0 = w0 & ~3;
    const int chunks = min((((w1 + 3) & ~3) - a0) >> 2, cap >> 2);
    for (int c = tid; c < chunks; c += nthreads) cp_async16(dst + 4 * c, words + a0 + 4 * c);
    return w0 - a0;
}

// k-bit two's-complement residuals read in order from a row in shared
// memory, starting at bit `bit`; keeps 32 or more unread bits in hand
struct BitReader {
    const uint32_t* p;
    uint64_t buf;
    int have;

    __device__ __forceinline__ BitReader(const uint32_t* row, int bit) {
        p = row + (bit >> 5);
        const int sh = bit & 31;
        buf = ((((uint64_t)p[1]) << 32) | p[0]) >> sh;
        have = 64 - sh;
        p += 2;
    }

    __device__ __forceinline__ int32_t next(int k) {
        const uint32_t raw = (uint32_t)buf;
        buf >>= k;
        have -= k;
        if (have < 32) {
            buf |= ((uint64_t)*p++) << have;
            have += 32;
        }
        return sign_extend(raw, k);
    }
};

// The group of each of the CTA's rows: the CTA finds the group of its first
// row with one ballot over the table, and a row steps on from there across
// the group edges that fall inside the CTA.
__device__ __forceinline__ int first_group(const Group* groups, int n_groups, int r0) {
    const int lane = threadIdx.x & 31;
    const unsigned below = __ballot_sync(0xFFFFFFFFu, lane < n_groups && groups[lane].row0 <= r0);
    return __popc(below) - 1;
}

__device__ __forceinline__ int group_of(const Group* groups, int n_groups, int g, int r) {
    while (g + 1 < n_groups && groups[g + 1].row0 <= r) ++g;
    return g;
}

// 8 samples a lane (samples 8*lane .. 8*lane+7 of the block) to out, masked
// against n_out
__device__ __forceinline__ void store8(float* __restrict__ out, int64_t pos, int64_t n_out, const int32_t* x) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (float)x[i] * (1.0f / 32768.0f);
    if (pos + 8 <= n_out) {
        float4* o = reinterpret_cast<float4*>(out + pos);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (pos + i < n_out) out[pos + i] = v[i];
    }
}

template <int ORDER>
__global__ void __launch_bounds__(kFixedWarps * 32)
pcm_decode_fixed(const uint8_t* __restrict__ wire, int groups_off, int n_groups, int words_off, int idx_off,
                 int heads_off, int nb, int64_t n_out, float* __restrict__ out) {
    __shared__ __align__(16) uint32_t stage[kStages][kFixedStageWords];
    __shared__ Group groups[kMaxGroups];
    __shared__ int row_k[kRows], row_word[kRows], row_end[kRows], row_block[kRows];
    __shared__ int32_t row_head[kRows][ORDER];  // the block's first ORDER differences

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int r0 = blockIdx.x * kRows;
    const int n_rows = min(kRows, nb - r0);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(wire + words_off);

    if (tid < n_groups) {
        const int4 g = reinterpret_cast<const int4*>(wire + groups_off)[tid];
        groups[tid] = Group{g.x, g.y, g.z, g.w};
    }
    __syncthreads();
    int g = 0, j = 0;
    if (warp == 0) {
        g = first_group(groups, n_groups, r0);
        if (lane < n_rows) {
            g = group_of(groups, n_groups, g, r0 + lane);
            const Group grp = groups[g];
            j = r0 + lane - grp.row0;
            const int wpr = words_per_row(grp.k, ORDER);
            row_k[lane] = grp.k;
            row_word[lane] = grp.word_off + j * wpr;
            row_end[lane] = grp.word_off + (j + 1) * wpr;
        }
    }
    __syncthreads();
    // both halves in flight at once
    int base[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
        const int first = s * kStageRows;
        const int last = min(first + kStageRows, n_rows) - 1;
        base[s] = first <= last ? stage_span(stage[s], kFixedStageWords, words, row_word[first], row_end[last], tid,
                                             kFixedWarps * 32)
                                : 0;
        cp_async_commit();
    }
    // while they land: each row's block and its head differences
    if (warp == 0 && lane < n_rows) {
        const int b = reinterpret_cast<const int32_t*>(wire + idx_off)[groups[g].slot0 + j];
        const int16_t* heads = reinterpret_cast<const int16_t*>(wire + heads_off) + (int64_t)b * ORDER;
        int32_t h[ORDER];
#pragma unroll
        for (int i = 0; i < ORDER; ++i) h[i] = heads[i];
        // Delta^ORDER of the block with zero history: ORDER cumsums of it
        // give the heads back
        row_head[lane][0] = h[0];
        if constexpr (ORDER == 2) row_head[lane][1] = h[1] - 2 * h[0];
        if constexpr (ORDER == 3) {
            row_head[lane][1] = h[1] - 3 * h[0];
            row_head[lane][2] = h[2] - 3 * h[1] + 3 * h[0];
        }
        row_block[lane] = b;
    }

#pragma unroll
    for (int s = 0; s < kStages; ++s) {
        if (s == 0)
            cp_async_wait<kStages - 1>();
        else
            cp_async_wait<0>();
        __syncthreads();
        for (int row = s * kStageRows + warp; row < min((s + 1) * kStageRows, n_rows); row += kFixedWarps) {
            const int k = row_k[row];
            // lane's samples n = 8*lane + i carry residual n - ORDER
            const int m0 = 8 * lane - ORDER;
            BitReader rd(stage[s] + base[s] + (row_word[row] - row_word[s * kStageRows]), max(m0, 0) * k);
            uint32_t v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (i < ORDER && lane == 0)
                    v[i] = (uint32_t)row_head[row][i];
                else
                    v[i] = (uint32_t)rd.next(k);
            }
            // ORDER inclusive prefix sums over the block's 256 samples
#pragma unroll
            for (int pass = 0; pass < ORDER; ++pass) {
#pragma unroll
                for (int i = 1; i < 8; ++i) v[i] += v[i - 1];
                uint32_t total = v[7];
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, total, d);
                    if (lane >= d) total += up;
                }
                const uint32_t carry = total - v[7];
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] += carry;
            }
            int32_t x[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = (int32_t)v[i];
            store8(out, (int64_t)row_block[row] * kBlock + 8 * lane, n_out, x);
        }
    }
}

// LPC: one thread per block, 32 consecutive stream rows per one-warp CTA
__device__ __forceinline__ void lpc_steps(int i0, int32_t (&h)[kLpcOrder], const int32_t (&c)[kLpcOrder], int shift,
                                          int k, BitReader& rd, float (*tile_row)) {
    // h is a ring: at the chunk's start h[p] holds x[n0 - 8 + p]; the
    // chunk's sample i is h[i & 7] once computed (32 is a multiple of 8)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        if (i < i0) continue;
        int32_t rest = 0;  // the seven older products, off the chain
#pragma unroll
        for (int jj = 2; jj <= kLpcOrder; ++jj) rest += c[jj - 1] * h[(i + kLpcOrder - jj) & 7];
        const int32_t r = rd.next(k);
        const int32_t x = r + ((c[0] * h[(i + 7) & 7] + rest) >> shift);  // arithmetic shift, as the packer's
        h[i & 7] = x;
        tile_row[i] = (float)x * (1.0f / 32768.0f);
    }
}

__global__ void __launch_bounds__(32)
pcm_decode_lpc(const uint8_t* __restrict__ wire, int groups_off, int n_groups, int words_off, int idx_off,
               int heads_off, int coeffs_off, int shifts_off, int nb, int64_t n_out, float* __restrict__ out) {
    __shared__ __align__(16) uint32_t stage[kLpcStageWords];
    __shared__ Group groups[kMaxGroups];
    __shared__ float tile[32][33];

    const int lane = threadIdx.x;
    const int r0 = blockIdx.x * kRows;
    const int n_rows = min(kRows, nb - r0);
    const bool active = lane < n_rows;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(wire + words_off);

    if (lane < n_groups) {
        const int4 g = reinterpret_cast<const int4*>(wire + groups_off)[lane];
        groups[lane] = Group{g.x, g.y, g.z, g.w};
    }
    __syncwarp();
    int g = group_of(groups, n_groups, first_group(groups, n_groups, r0), r0 + min(lane, n_rows - 1));
    const Group grp = groups[g];
    const int j = r0 + min(lane, n_rows - 1) - grp.row0;
    const int wpr = words_per_row(grp.k, kLpcOrder);
    const int word = grp.word_off + j * wpr;
    const int w0 = __shfl_sync(0xFFFFFFFFu, word, 0);
    const int w1 = __shfl_sync(0xFFFFFFFFu, word + wpr, n_rows - 1);
    const int base = stage_span(stage, kLpcStageWords, words, w0, w1, lane, 32);
    cp_async_commit();

    // while the words land: the block's heads, coefficients and shift
    int b = -1;
    int32_t h[kLpcOrder], c[kLpcOrder];
    int shift = 0;
    if (active) {
        b = reinterpret_cast<const int32_t*>(wire + idx_off)[grp.slot0 + j];
        // a block's 8 heads and 8 coefficients are 16 aligned bytes each
        const int4 hv = reinterpret_cast<const int4*>(wire + heads_off)[b];
        const int4 cv = reinterpret_cast<const int4*>(wire + coeffs_off)[b];
        const int hw[4] = {hv.x, hv.y, hv.z, hv.w}, cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            h[2 * q] = (int16_t)(hw[q] & 0xFFFF);
            h[2 * q + 1] = (int16_t)((uint32_t)hw[q] >> 16);
            c[2 * q] = (int16_t)(cw[q] & 0xFFFF);
            c[2 * q + 1] = (int16_t)((uint32_t)cw[q] >> 16);
        }
        shift = reinterpret_cast<const int8_t*>(wire + shifts_off)[b];
    } else {
#pragma unroll
        for (int q = 0; q < kLpcOrder; ++q) h[q] = c[q] = 0;
    }
    const int k = active ? grp.k : 2;
    cp_async_wait<0>();
    __syncwarp();

    BitReader rd(stage + base + (active ? word - w0 : 0), 0);
    for (int t0 = 0; t0 < kBlock; t0 += 32) {
        if (t0 == 0) {
#pragma unroll
            for (int i = 0; i < kLpcOrder; ++i) tile[lane][i] = (float)h[i] * (1.0f / 32768.0f);
            lpc_steps(kLpcOrder, h, c, shift, k, rd, tile[lane]);
        } else {
            lpc_steps(0, h, c, shift, k, rd, tile[lane]);
        }
        __syncwarp();
        // rows q = 4*it + lane/8 of the tile, 4 samples a lane
#pragma unroll
        for (int it = 0; it < 8; ++it) {
            const int q = 4 * it + (lane >> 3);
            const int col = 4 * (lane & 7);
            const int bq = __shfl_sync(0xFFFFFFFFu, b, q);
            const int64_t pos = (int64_t)bq * kBlock + t0 + col;
            const float4 v = make_float4(tile[q][col], tile[q][col + 1], tile[q][col + 2], tile[q][col + 3]);
            if (bq >= 0) {
                if (pos + 4 <= n_out) {
                    *reinterpret_cast<float4*>(out + pos) = v;
                } else {
                    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (pos + e < n_out) out[pos + e] = vs[e];
                }
            }
        }
        __syncwarp();
    }
}

template <int ORDER>
cudaError_t launch_fixed(const uint8_t* wire, int groups_off, int n_groups, int words_off, int idx_off,
                         int heads_off, int nb, int64_t n_out, float* out, cudaStream_t stream) {
    const int grid = (nb + kRows - 1) / kRows;
    pcm_decode_fixed<ORDER><<<grid, kFixedWarps * 32, 0, stream>>>(wire, groups_off, n_groups, words_off, idx_off,
                                                                   heads_off, nb, n_out, out);
    return cudaGetLastError();
}

// One thread walking the LPC chain of `steps` samples (the multiply-add,
// the shift and the add of a step, as pcm_decode_lpc runs them): out[0] =
// the clock64() cycles it took, out[1] = its result (kept so the chain is
// not folded away).
__global__ void lpc_chain_probe(int steps, int c, int shift, long long* out) {
    int32_t x = (int32_t)threadIdx.x + 3, rest = 5;
    const long long t0 = clock64();
    for (int n = 0; n < steps; ++n) x = (n & 7) + ((c * x + rest) >> shift);
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = x;
}

}  // namespace

// Decode one wire buffer (device pointer, 16-byte aligned; offsets in bytes)
// into out[0:n_out] on `stream`. Returns the launch's cudaError_t (0 = ok);
// an order or group count the kernel does not take returns
// cudaErrorInvalidValue without launching. The out pointer must be 16-byte
// aligned.
extern "C" int pcm_decode_launch(const void* wire, int groups_off, int n_groups, int words_off, int idx_off,
                                 int heads_off, int coeffs_off, int shifts_off, int nb, int order, int lpc,
                                 int64_t n_out, float* out, void* stream) {
    if (n_groups < 1 || n_groups > kMaxGroups || nb < 1) return (int)cudaErrorInvalidValue;
    const uint8_t* w = static_cast<const uint8_t*>(wire);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lpc) {
        if (order != kLpcOrder) return (int)cudaErrorInvalidValue;
        pcm_decode_lpc<<<(nb + kRows - 1) / kRows, 32, 0, s>>>(w, groups_off, n_groups, words_off, idx_off,
                                                               heads_off, coeffs_off, shifts_off, nb, n_out, out);
        return (int)cudaGetLastError();
    }
    switch (order) {
        case 1:
            return (int)launch_fixed<1>(w, groups_off, n_groups, words_off, idx_off, heads_off, nb, n_out, out, s);
        case 2:
            return (int)launch_fixed<2>(w, groups_off, n_groups, words_off, idx_off, heads_off, nb, n_out, out, s);
        case 3:
            return (int)launch_fixed<3>(w, groups_off, n_groups, words_off, idx_off, heads_off, nb, n_out, out, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// Measure the LPC chain's latency: one thread, `steps` dependent steps;
// out (device, 2 x int64) as lpc_chain_probe. For the chain bound that
// chip_smoke.py prints beside the bytes bound.
extern "C" int pcm_lpc_chain_probe(int steps, int c, int shift, long long* out, void* stream) {
    lpc_chain_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(steps, c, shift, out);
    return (int)cudaGetLastError();
}
