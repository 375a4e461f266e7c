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
// Bound: bytes. A 128-window chunk moves ~6.6 MB of wire in and 18.5 MB of
// float32 out (~7.5 us at 3.35 TB/s); the integer work is ~20 operations a
// sample. Design: one thread per 256-sample block (the recurrence is
// sequential within a block and independent across blocks, ~18 000 blocks a
// chunk). A thread finds its block's bit-width group in a table in shared
// memory, reads its row's k-bit words (each row is 32-bit aligned and read
// in order, so its lines stay in L1), sign-extends and integrates in
// registers with an int32 accumulator (exact: |sum c_j x| < 2^30 by the
// packer's sum|c| <= 32767 contract), and stages 32 samples at a time in
// shared memory so that each warp writes 32 blocks' samples as 128-byte
// coalesced rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // samples per codec block
constexpr int kLpcOrder = 8;       // pcmcodec.LPC_ORDER
constexpr int kMaxGroups = 18;     // len(pcmcodec.KSET)
constexpr int kWarps = 4;          // warps per CTA
constexpr int kTile = 32;          // samples a lane stages per round

struct Group {
    int k;          // residual width in bits
    int word_off;   // first word of the group's rows
    int row0;       // first stream row of the group
    int slot0;      // first idx slot of the group (idx is bucket-padded per group)
};

// the k-bit two's-complement residual at bit position pos of a row
__device__ __forceinline__ int32_t residual_at(const uint32_t* __restrict__ row, int pos, int k,
                                               uint32_t mask, uint32_t sign) {
    const int w = pos >> 5;
    const int sh = pos & 31;
    uint32_t v = __ldg(row + w) >> sh;
    if (sh + k > 32) v |= __ldg(row + w + 1) << (32 - sh);
    v &= mask;
    return (int32_t)v - (int32_t)((v & sign) << 1);
}

template <int ORDER, bool LPC>
__global__ void __launch_bounds__(kWarps * 32)
pcm_decode_kernel(const uint8_t* __restrict__ wire, int groups_off, int n_groups, int words_off, int idx_off,
                  int heads_off, int coeffs_off, int shifts_off, int nb, int64_t n_out,
                  float* __restrict__ out) {
    __shared__ Group groups[kMaxGroups];
    __shared__ float tile[kWarps][32][kTile + 1];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if ((int)threadIdx.x < n_groups) {
        const int4 g = reinterpret_cast<const int4*>(wire + groups_off)[threadIdx.x];
        groups[threadIdx.x] = Group{g.x, g.y, g.z, g.w};
    }
    __syncthreads();

    const int r = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's stream row
    const bool active = r < nb;
    int b = -1;  // the block this row encodes
    const uint32_t* row = nullptr;
    int k = 2;
    if (active) {
        int g = 0;
        while (g + 1 < n_groups && groups[g + 1].row0 <= r) ++g;
        const Group grp = groups[g];
        k = grp.k;
        const int j = r - grp.row0;
        const int wpb = ((kBlock - ORDER) * k + 31) >> 5;
        b = reinterpret_cast<const int32_t*>(wire + idx_off)[grp.slot0 + j];
        row = reinterpret_cast<const uint32_t*>(wire + words_off) + grp.word_off + (int64_t)j * wpb;
    }
    const uint32_t mask = (k == 32) ? 0xFFFFFFFFu : ((1u << k) - 1u);
    const uint32_t sign = 1u << (k - 1);

    // the integration state: the block's first ORDER samples (heads)
    int32_t hist[ORDER];
    int32_t coef[LPC ? ORDER : 1];
    int shift = 0;
    if (active) {
        const int16_t* heads = reinterpret_cast<const int16_t*>(wire + heads_off) + (int64_t)b * ORDER;
#pragma unroll
        for (int h = 0; h < ORDER; ++h) hist[h] = heads[h];
        if constexpr (LPC) {
            const int16_t* c = reinterpret_cast<const int16_t*>(wire + coeffs_off) + (int64_t)b * ORDER;
#pragma unroll
            for (int h = 0; h < ORDER; ++h) coef[h] = c[h];
            shift = reinterpret_cast<const int8_t*>(wire + shifts_off)[b];
        }
    } else {
#pragma unroll
        for (int h = 0; h < ORDER; ++h) hist[h] = 0;
        if constexpr (LPC) {
#pragma unroll
            for (int h = 0; h < ORDER; ++h) coef[h] = 0;
        }
    }
    // fixed orders carry the running differences: order 1 x; order 2 dx, x;
    // order 3 d2x, dx, x (the JAX package's nested cumsums, one step each)
    int32_t d1 = 0, d2 = 0;
    if constexpr (!LPC && ORDER >= 2) d1 = hist[ORDER - 1] - hist[ORDER - 2];
    if constexpr (!LPC && ORDER == 3) d2 = hist[2] - 2 * hist[1] + hist[0];
    int32_t x = hist[ORDER - 1];

    for (int t0 = 0; t0 < kBlock; t0 += kTile) {
        for (int i = 0; i < kTile; ++i) {
            const int n = t0 + i;  // sample index within the block
            int32_t value;
            if (n < ORDER) {
                value = hist[0];
                if constexpr (ORDER > 1) {  // heads go out oldest first
#pragma unroll
                    for (int h = 0; h < ORDER; ++h)
                        if (h == n) value = hist[h];
                }
            } else {
                const int32_t res = active ? residual_at(row, (n - ORDER) * k, k, mask, sign) : 0;
                if constexpr (LPC) {
                    int32_t acc = 0;
#pragma unroll
                    for (int j = 1; j <= ORDER; ++j) acc += coef[j - 1] * hist[ORDER - j];
                    x = res + (acc >> shift);  // arithmetic shift, as the packer's ashr64
#pragma unroll
                    for (int h = 0; h + 1 < ORDER; ++h) hist[h] = hist[h + 1];
                    hist[ORDER - 1] = x;
                } else if constexpr (ORDER == 1) {
                    x += res;
                } else if constexpr (ORDER == 2) {
                    d1 += res;
                    x += d1;
                } else {
                    d2 += res;
                    d1 += d2;
                    x += d1;
                }
                value = x;
            }
            tile[warp][lane][i] = (float)value * (1.0f / 32768.0f);
        }
        __syncwarp();
        // lane q's block, written by the whole warp: 32 consecutive samples
        for (int q = 0; q < 32; ++q) {
            const int bq = __shfl_sync(0xFFFFFFFFu, b, q);
            const int64_t pos = (int64_t)bq * kBlock + t0 + lane;
            if (bq >= 0 && pos < n_out) out[pos] = tile[warp][q][lane];
        }
        __syncwarp();
    }
}

template <int ORDER, bool LPC>
cudaError_t launch(const uint8_t* wire, int groups_off, int n_groups, int words_off, int idx_off, int heads_off,
                   int coeffs_off, int shifts_off, int nb, int64_t n_out, float* out, cudaStream_t stream) {
    const int threads = kWarps * 32;
    const int grid = (nb + threads - 1) / threads;
    pcm_decode_kernel<ORDER, LPC><<<grid, threads, 0, stream>>>(
        wire, groups_off, n_groups, words_off, idx_off, heads_off, coeffs_off, shifts_off, nb, n_out, out);
    return cudaGetLastError();
}

}  // namespace

// Decode one wire buffer (device pointer, 16-byte aligned; offsets in bytes)
// into out[0:n_out] on `stream`. Returns the launch's cudaError_t (0 = ok);
// an order or group count the kernel does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int pcm_decode_launch(const void* wire, int groups_off, int n_groups, int words_off, int idx_off,
                                 int heads_off, int coeffs_off, int shifts_off, int nb, int order, int lpc,
                                 int64_t n_out, float* out, void* stream) {
    if (n_groups < 1 || n_groups > kMaxGroups || nb < 1) return (int)cudaErrorInvalidValue;
    const uint8_t* w = static_cast<const uint8_t*>(wire);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lpc) {
        if (order != kLpcOrder) return (int)cudaErrorInvalidValue;
        return (int)launch<kLpcOrder, true>(w, groups_off, n_groups, words_off, idx_off, heads_off, coeffs_off,
                                            shifts_off, nb, n_out, out, s);
    }
    switch (order) {
        case 1:
            return (int)launch<1, false>(w, groups_off, n_groups, words_off, idx_off, heads_off, coeffs_off,
                                         shifts_off, nb, n_out, out, s);
        case 2:
            return (int)launch<2, false>(w, groups_off, n_groups, words_off, idx_off, heads_off, coeffs_off,
                                         shifts_off, nb, n_out, out, s);
        case 3:
            return (int)launch<3, false>(w, groups_off, n_groups, words_off, idx_off, heads_off, coeffs_off,
                                         shifts_off, nb, n_out, out, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
