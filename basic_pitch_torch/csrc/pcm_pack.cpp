// Host half of the lossless PCM16 transport codec (ops/pcmcodec.py):
// fixed-predictor and LPC residual packers with a plain C interface, bound
// with ctypes. A copy of the packer part of the JAX package's host library
// (`basic_pitch_tpu/native/bp_native.cpp`), built with the same g++ flags
// (-O3 -shared -fPIC, no -march) so that the LPC analysis rounds the same
// way and the wire is byte-identical; tests/test_torch_params.py pins the
// code equal. The consumer of the wire is the CUDA kernel csrc/pcm_decode.cu
// (and its plain PyTorch version in ops/pcmcodec.py).
//
// Wire format: 256-sample blocks; the first `order` samples of a block go
// to `heads` verbatim (the integration constants); the remaining 256-order
// are order-th finite-difference residuals (FLAC-style fixed predictor,
// order 1..3) or LPC residuals, packed at the smallest per-block bit width
// drawn from `kset`. Blocks are grouped by width and each group's blocks are
// laid out consecutively in `kset` order, every block starting 32-bit
// aligned (((256-order)*k+31)/32 words per block). `idx` records, stream row
// by stream row, which block each row encodes; `counts[j]` is the number of
// blocks in kset[j]'s stream. The packers return the total words written, or
// -1 when n is not a multiple of 256 / order is out of range / kset cannot
// represent a residual / the word buffer is too small.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

static inline int32_t diff_residual(const int16_t* blk, int64_t i, int32_t order) {
    switch (order) {
        case 1: return (int32_t)blk[i] - (int32_t)blk[i - 1];
        case 2: return (int32_t)blk[i] - 2 * (int32_t)blk[i - 1] + (int32_t)blk[i - 2];
        default:
            return (int32_t)blk[i] - 3 * (int32_t)blk[i - 1] +
                   3 * (int32_t)blk[i - 2] - (int32_t)blk[i - 3];
    }
}

// Total payload bits for each candidate order (exact signed widths, no
// ladder rounding) — the packer caller picks the cheapest order globally.
// Single pass: d2/d3 derive incrementally from the running d1/d2.
void residual_order_costs(const int16_t* x, int64_t n, int64_t* bits_out) {
    const int64_t kBlock = 256;
    const int64_t nb = n / kBlock;
    for (int32_t o = 1; o <= 3; ++o) bits_out[o - 1] = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const int16_t* blk = x + b * kBlock;
        int32_t m1 = 0, m2 = 0, m3 = 0;
        int32_t d1p = (int32_t)blk[1] - (int32_t)blk[0];
        int32_t a0 = d1p < 0 ? -d1p : d1p;
        if (a0 > m1) m1 = a0;
        int32_t d2p = 0;
        for (int64_t i = 2; i < kBlock; ++i) {
            const int32_t d1 = (int32_t)blk[i] - (int32_t)blk[i - 1];
            const int32_t d2 = d1 - d1p;
            const int32_t a1 = d1 < 0 ? -d1 : d1;
            const int32_t a2 = d2 < 0 ? -d2 : d2;
            if (a1 > m1) m1 = a1;
            if (a2 > m2) m2 = a2;
            if (i >= 3) {
                const int32_t d3 = d2 - d2p;
                const int32_t a3 = d3 < 0 ? -d3 : d3;
                if (a3 > m3) m3 = a3;
            }
            d1p = d1;
            d2p = d2;
        }
        const int32_t m[3] = {m1, m2, m3};
        for (int32_t o = 1; o <= 3; ++o) {
            int32_t need = 2;
            while (need < 32 && m[o - 1] > (1 << (need - 1)) - 1) ++need;
            bits_out[o - 1] += (int64_t)need * (kBlock - o) + 16 * o;
        }
    }
}

}  // extern "C" — the pack core below is a template (C++ linkage)

// Shared two-pass pack core: `residual(blk, i)` produces the i-th residual
// of a block for the caller's predictor (fixed finite difference or LPC).
// Layout/merge semantics are identical for both modes — see the format
// comment above pack_pcm16_residual.
template <class ResidualFn>
static int64_t pack_core(const int16_t* x, int64_t n, int32_t order,
                         const int32_t* kset, int32_t n_k, uint32_t* words,
                         int64_t words_cap, int32_t* idx, int16_t* heads,
                         int64_t* counts, ResidualFn residual) {
    const int64_t kBlock = 256;
    if (n % kBlock != 0 || order < 1 || order >= kBlock) return -1;
    if (n_k < 1 || n_k > 64) return -1;  // fixed-size offset arrays below
    const int64_t kPay = kBlock - order;
    const int64_t nb = n / kBlock;

    // pass 1: class per block (index into kset) from the residual range
    unsigned char* cls = (unsigned char*)malloc((size_t)nb);
    if (!cls) return -1;
    for (int32_t j = 0; j < n_k; ++j) counts[j] = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const int16_t* blk = x + b * kBlock;
        int32_t maxabs = 0;
        for (int64_t i = order; i < kBlock; ++i) {
            int32_t r = residual(b, blk, i);
            int32_t a = r < 0 ? -r : r;
            if (a > maxabs) maxabs = a;
        }
        int32_t need = 2;  // signed width covering maxabs: maxabs <= 2^(k-1)-1
        while (need < 32 && maxabs > (1 << (need - 1)) - 1) ++need;
        int32_t pick = -1;
        for (int32_t j = 0; j < n_k; ++j)
            if (kset[j] >= need && (pick < 0 || kset[j] < kset[pick])) pick = j;
        if (pick < 0) { free(cls); return -1; }
        cls[b] = (unsigned char)pick;
        counts[pick]++;
        for (int32_t h = 0; h < order; ++h) heads[order * b + h] = blk[h];
    }

    // merge sparse groups into the nearest wider POPULATED width (the wire
    // format's rule: on the TPU every (width, row-bucket) pair was a
    // distinct executable, so tiny groups bought compiles for ~zero byte
    // savings). kset is
    // descending, so smaller j = wider. Merging only into widths real
    // content already uses bounds the byte cost: a short piece whose groups
    // are ALL sparse keeps its widest populated group rather than
    // cascading to kset[0] (which would EXPAND 4-bit content to 19 bits).
    const int64_t kMergeMin = 64;
    for (int32_t j = n_k - 1; j > 0; --j) {
        if (counts[j] > 0 && counts[j] < kMergeMin) {
            int32_t dst = -1;
            for (int32_t p = j - 1; p >= 0; --p)
                if (counts[p] > 0) { dst = p; break; }
            if (dst < 0) continue;  // widest populated group: keep as-is
            for (int64_t b = 0; b < nb; ++b)
                if (cls[b] == (unsigned char)j) cls[b] = (unsigned char)dst;
            counts[dst] += counts[j];
            counts[j] = 0;
        }
    }

    // stream layout: kset order, 32-bit-aligned rows
    int64_t word_off[64], row_off[64], total = 0, rows = 0;
    for (int32_t j = 0; j < n_k; ++j) {
        word_off[j] = total;
        row_off[j] = rows;
        const int64_t wpb = (kPay * kset[j] + 31) / 32;
        total += counts[j] * wpb;
        rows += counts[j];
    }
    if (total > words_cap) { free(cls); return -1; }
    memset(words, 0, (size_t)total * 4);

    // pass 2: pack each block into its stream slot
    int64_t cursor[64];
    for (int32_t j = 0; j < n_k; ++j) cursor[j] = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const int32_t j = cls[b];
        const int32_t k = kset[j];
        const int64_t wpb = (kPay * k + 31) / 32;
        uint32_t* dst = words + word_off[j] + cursor[j] * wpb;
        idx[row_off[j] + cursor[j]] = (int32_t)b;
        cursor[j]++;
        const int16_t* blk = x + b * kBlock;
        const uint32_t mask = (k == 32) ? 0xFFFFFFFFu : ((1u << k) - 1);
        int64_t pos = 0;
        for (int64_t i = order; i < kBlock; ++i, pos += k) {
            int32_t r = residual(b, blk, i);
            uint32_t v = (uint32_t)r & mask;
            const int64_t w = pos >> 5;
            const int32_t sh = (int32_t)(pos & 31);
            dst[w] |= v << sh;
            if (sh + k > 32) dst[w + 1] |= v >> (32 - sh);
        }
    }
    free(cls);
    return total;
}

// ---------------------------------------------------------------------------
// LPC transport mode (FLAC-style per-block adaptive prediction)
//
// Encoder-side analysis for ops/pcmcodec.py's "lpc" piece mode: per
// 256-sample block, autocorrelation + Levinson-Durbin give float LPC
// coefficients of order p; they are quantized to int16 at a per-block shift
// constrained so sum|c| <= 32767 — which bounds the integer prediction
// accumulator |sum c_j*x[n-j]| < 2^30, so the device can reconstruct in
// plain int32 (csrc/pcm_decode.cu, one thread per block). The wire is
// self-describing: reconstruction uses the shipped coefficients, so ANY
// analysis outcome round-trips bit-exactly; float analysis quality only
// affects compression ratio, never correctness. Blocks whose residual would
// not fit the 19-bit ladder cap fall back to an order-1 predictor
// (c=[1,0,...], shift 0: residual = delta-x, always <= 17 bits).
// ---------------------------------------------------------------------------

static const int32_t kLpcMaxShift = 14;

static void levinson(const double* ac, int32_t p, double* a_out) {
    for (int32_t j = 0; j < p; ++j) a_out[j] = 0.0;
    double err = ac[0];
    if (err <= 0.0) return;  // silent block: zero predictor
    double a[32] = {0}, tmp[32];
    for (int32_t m = 1; m <= p; ++m) {
        double acc = ac[m];
        for (int32_t j = 1; j < m; ++j) acc -= a[j - 1] * ac[m - j];
        const double k = acc / err;
        if (!(k == k) || k >= 1.0 || k <= -1.0) break;  // NaN / unstable: stop
        for (int32_t j = 0; j < m - 1; ++j) tmp[j] = a[j] - k * a[m - 2 - j];
        tmp[m - 1] = k;
        for (int32_t j = 0; j < m; ++j) a[j] = tmp[j];
        err *= (1.0 - k * k);
        if (err <= 0.0) break;
    }
    for (int32_t j = 0; j < p; ++j) a_out[j] = a[j];
}

// Quantize float coeffs to int16 at the largest shift <= kLpcMaxShift with
// sum|c| <= 32767 (the int32-safety contract). Returns the shift; falls back
// to the order-1 predictor when even shift 0 cannot satisfy the bound.
static int32_t quantize_lpc(const double* a, int32_t p, int16_t* c_out) {
    int32_t s = kLpcMaxShift;
    double asum = 0.0;
    for (int32_t j = 0; j < p; ++j) asum += a[j] < 0 ? -a[j] : a[j];
    if (asum > 0.0)
        while (s > 0 && asum * (double)(1 << s) > 32767.0) --s;
    for (;;) {
        int64_t csum = 0;
        for (int32_t j = 0; j < p; ++j) {
            double v = a[j] * (double)(1 << s);
            long cv = lround(v);
            if (cv > 32767) cv = 32767;
            if (cv < -32768) cv = -32768;
            c_out[j] = (int16_t)cv;
            csum += cv < 0 ? -cv : cv;
        }
        if (csum <= 32767) return s;
        if (s == 0) break;
        --s;
    }
    for (int32_t j = 0; j < p; ++j) c_out[j] = 0;  // degenerate: order-1
    c_out[0] = 1;
    return 0;
}

// Arithmetic (floor) right shift with defined semantics on every pre-C++20
// toolchain: >> on a negative signed value is implementation-defined there,
// and the device decoder shifts arithmetically — encoder and decoder must
// agree exactly. ~((~v) >> s) == floor(v / 2^s) for v < 0,
// using >> only on non-negative operands (always well-defined).
static inline int64_t ashr64(int64_t v, int32_t s) {
    return v < 0 ? ~((~v) >> s) : v >> s;
}

static inline int32_t lpc_residual(const int16_t* blk, int64_t i,
                                   const int16_t* c, int32_t p, int32_t s) {
    int64_t acc = 0;
    for (int32_t j = 1; j <= p; ++j) acc += (int64_t)c[j - 1] * blk[i - j];
    return (int32_t)blk[i] - (int32_t)ashr64(acc, s);
}

static int32_t lpc_block_width(const int16_t* blk, const int16_t* c, int32_t p,
                               int32_t s) {
    int32_t maxabs = 0;
    for (int64_t i = p; i < 256; ++i) {
        int32_t r = lpc_residual(blk, i, c, p, s);
        int32_t a = r < 0 ? -r : r;
        if (a > maxabs) maxabs = a;
    }
    int32_t need = 2;
    while (need < 32 && maxabs > (1 << (need - 1)) - 1) ++need;
    return need;
}

extern "C" {

int64_t pack_pcm16_residual(const int16_t* x, int64_t n, int32_t order,
                            const int32_t* kset, int32_t n_k, uint32_t* words,
                            int64_t words_cap, int32_t* idx, int16_t* heads,
                            int64_t* counts) {
    if (order < 1 || order > 3) return -1;
    return pack_core(x, n, order, kset, n_k, words, words_cap, idx, heads,
                     counts, [order](int64_t, const int16_t* blk, int64_t i) {
                         return diff_residual(blk, i, order);
                     });
}

// Per-block LPC analysis: writes quantized coefficients (nb, p) and shifts
// (nb,), returns the exact total cost in BITS (payload at exact signed
// widths + per-block header: 16p head samples + 16p coeffs + 8 shift) for
// mode selection against the fixed-predictor costs, or -1 on bad input.
int64_t lpc_analyze_pcm16(const int16_t* x, int64_t n, int32_t p,
                          int16_t* coeffs, int8_t* shifts) {
    const int64_t kBlock = 256;
    if (n % kBlock != 0 || p < 1 || p > 16) return -1;
    const int64_t nb = n / kBlock;
    const int32_t kCap = 19;  // widest ladder width in pcmcodec.KSET
    int64_t bits = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const int16_t* blk = x + b * kBlock;
        double ac[17];
        for (int32_t lag = 0; lag <= p; ++lag) {
            double acc = 0.0;
            for (int64_t i = lag; i < kBlock; ++i)
                acc += (double)blk[i] * (double)blk[i - lag];
            ac[lag] = acc;
        }
        ac[0] = ac[0] * (1.0 + 1e-10) + 1e-10;  // ridge: never singular
        double a[16];
        levinson(ac, p, a);
        int16_t* c = coeffs + b * p;
        int32_t s = quantize_lpc(a, p, c);
        int32_t need = lpc_block_width(blk, c, p, s);
        if (need > kCap) {  // exceeds the ladder: order-1 inside the LPC frame
            for (int32_t j = 0; j < p; ++j) c[j] = 0;
            c[0] = 1;
            s = 0;
            need = lpc_block_width(blk, c, p, 0);  // delta-x: <= 17 always
        }
        shifts[b] = (int8_t)s;
        bits += (int64_t)need * (kBlock - p) + 16 * p + 16 * p + 8;
    }
    return bits;
}

// Pack with caller-provided per-block LPC coefficients/shifts (from
// lpc_analyze_pcm16). Wire layout identical to pack_pcm16_residual with
// order = p; the consumer is pcmcodec.decode_to_device's "lpc" branch.
int64_t pack_pcm16_lpc(const int16_t* x, int64_t n, int32_t p,
                       const int16_t* coeffs, const int8_t* shifts,
                       const int32_t* kset, int32_t n_k, uint32_t* words,
                       int64_t words_cap, int32_t* idx, int16_t* heads,
                       int64_t* counts) {
    if (p < 1 || p > 16) return -1;
    return pack_core(x, n, p, kset, n_k, words, words_cap, idx, heads, counts,
                     [coeffs, shifts, p](int64_t b, const int16_t* blk, int64_t i) {
                         return lpc_residual(blk, i, coeffs + b * p, p,
                                             (int32_t)shifts[b]);
                     });
}

}  // extern "C"
