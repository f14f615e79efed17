/* Host tower scalar algebra for Fan-Paar binary tower fields.
 *
 * The card carries the prover's bulk work; this file carries the host's
 * scalar algebra: transcript math, Lagrange interpolation, the ring
 * switch's B128 products, the verifiers' composition evaluations, which the
 * reference implements in native Rust (`crates/field/src/
 * binary_field_arithmetic.rs`) and which Python ints do at ~25-35 us/mul.
 *
 * Semantics mirror binius_tpu_torch/fields/scalar.py (the plain version):
 *
 *   T_0 = F2,  T_k = T_{k-1}[X_k] / (X_k^2 + X_{k-1}*X_k + 1),  X_0 = 1,
 *   encoding a = a0 | (a1 << 2^(k-1)).
 *
 * 128-bit elements pass as (lo, hi) uint64 pairs. Levels 0..6 fit one
 * uint64. An operand must lie in the level it is given at (the callers in
 * scalar.py pass the smallest level that holds it): the byte tables are
 * indexed by the operand. Built by binius_tpu_torch/native/__init__.py.
 */

#include <stddef.h>
#include <stdint.h>

static uint8_t MUL8[1u << 16];
static uint8_t ALPHA8[256];
static uint8_t INV8[256];
static int INITED = 0;

/* --- reference recursion at byte scale (init only) --- */

static unsigned mul_alpha_rec(int level, unsigned a) {
    if (level == 0) return a;
    unsigned h = 1u << (level - 1), m = (1u << h) - 1u;
    unsigned a0 = a & m, a1 = a >> h;
    return a1 | ((a0 ^ mul_alpha_rec(level - 1, a1)) << h);
}

static unsigned mul_rec(int level, unsigned a, unsigned b) {
    if (level == 0) return a & b;
    unsigned h = 1u << (level - 1), m = (1u << h) - 1u;
    unsigned a0 = a & m, a1 = a >> h, b0 = b & m, b1 = b >> h;
    unsigned z0 = mul_rec(level - 1, a0, b0);
    unsigned z2 = mul_rec(level - 1, a1, b1);
    unsigned z1 = mul_rec(level - 1, a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
    return (z0 ^ z2) | ((z1 ^ mul_alpha_rec(level - 1, z2)) << h);
}

static void init_tables(void) {
    if (INITED) return;
    for (unsigned a = 0; a < 256; a++) {
        for (unsigned b = 0; b < 256; b++)
            MUL8[(a << 8) | b] = (uint8_t)mul_rec(3, a, b);
        ALPHA8[a] = (uint8_t)mul_alpha_rec(3, a);
    }
    /* inverse by exhaustive search at byte scale (255 units) */
    INV8[0] = 0;
    for (unsigned a = 1; a < 256; a++)
        for (unsigned b = 1; b < 256; b++)
            if (MUL8[(a << 8) | b] == 1) { INV8[a] = (uint8_t)b; break; }
    INITED = 1;
}

/* --- unrolled Karatsuba on uint64 words (levels 3..6) --- */

static inline uint64_t a8(uint64_t v)  { return ALPHA8[v]; }
static inline uint64_t a16(uint64_t v) {
    uint64_t lo = v >> 8;
    return lo | (((v & 0xFFu) ^ ALPHA8[lo]) << 8);
}
static inline uint64_t a32(uint64_t v) {
    uint64_t lo = v >> 16;
    return lo | (((v & 0xFFFFu) ^ a16(lo)) << 16);
}
static inline uint64_t a64(uint64_t v) {
    uint64_t lo = v >> 32;
    return lo | (((v & 0xFFFFFFFFu) ^ a32(lo)) << 32);
}

static inline uint64_t m8(uint64_t a, uint64_t b) { return MUL8[(a << 8) | b]; }

static inline uint64_t m16(uint64_t a, uint64_t b) {
    uint64_t a0 = a & 0xFF, a1 = a >> 8, b0 = b & 0xFF, b1 = b >> 8;
    uint64_t z0 = m8(a0, b0), z2 = m8(a1, b1);
    uint64_t z1 = m8(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
    return (z0 ^ z2) | ((z1 ^ a8(z2)) << 8);
}

static inline uint64_t m32(uint64_t a, uint64_t b) {
    uint64_t a0 = a & 0xFFFF, a1 = a >> 16, b0 = b & 0xFFFF, b1 = b >> 16;
    uint64_t z0 = m16(a0, b0), z2 = m16(a1, b1);
    uint64_t z1 = m16(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
    return (z0 ^ z2) | ((z1 ^ a16(z2)) << 16);
}

static inline uint64_t m64(uint64_t a, uint64_t b) {
    uint64_t a0 = a & 0xFFFFFFFFu, a1 = a >> 32, b0 = b & 0xFFFFFFFFu, b1 = b >> 32;
    uint64_t z0 = m32(a0, b0), z2 = m32(a1, b1);
    uint64_t z1 = m32(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
    return (z0 ^ z2) | ((z1 ^ a32(z2)) << 32);
}

static inline void m128(uint64_t alo, uint64_t ahi, uint64_t blo, uint64_t bhi,
                        uint64_t *out) {
    uint64_t z0 = m64(alo, blo), z2 = m64(ahi, bhi);
    uint64_t z1 = m64(alo ^ ahi, blo ^ bhi) ^ z0 ^ z2;
    out[0] = z0 ^ z2;
    out[1] = z1 ^ a64(z2);
}

/* sub-64 dispatch (levels 0..3 all live inside the B8 table: subfields
 * embed as identity and are multiplicatively closed) */
static inline uint64_t mul_w(int level, uint64_t a, uint64_t b) {
    switch (level) {
        case 0: case 1: case 2: case 3: return m8(a, b);
        case 4: return m16(a, b);
        case 5: return m32(a, b);
        default: return m64(a, b);
    }
}

/* square/invert need per-level alpha: compute via recursion on words */
static uint64_t alpha_word(int level, uint64_t a) {
    if (level == 0) return a;
    if (level == 3) return a8(a);
    if (level == 4) return a16(a);
    if (level == 5) return a32(a);
    if (level == 6) return a64(a);
    unsigned h = 1u << (level - 1);
    uint64_t m = (1ull << h) - 1ull;
    uint64_t a0 = a & m, a1 = a >> h;
    return a1 | ((a0 ^ alpha_word(level - 1, a1)) << h);
}

static uint64_t square_w(int level, uint64_t a) {
    if (level == 0) return a;
    unsigned h = 1u << (level - 1);
    uint64_t m = (h >= 64) ? ~0ull : ((1ull << h) - 1ull);
    uint64_t a0 = a & m, a1 = a >> h;
    uint64_t s0 = square_w(level - 1, a0), s1 = square_w(level - 1, a1);
    return (s0 ^ s1) | (alpha_word(level - 1, s1) << h);
}

static uint64_t invert_w(int level, uint64_t a) {
    if (a == 0) return 0;
    if (level <= 3) return INV8[a];
    unsigned h = 1u << (level - 1);
    uint64_t m = (1ull << h) - 1ull;
    uint64_t a0 = a & m, a1 = a >> h;
    if (a1 == 0) return invert_w(level - 1, a0);
    uint64_t d = square_w(level - 1, a0)
               ^ alpha_word(level - 1, mul_w(level - 1, a0, a1))
               ^ square_w(level - 1, a1);
    uint64_t dinv = invert_w(level - 1, d);
    uint64_t b0 = mul_w(level - 1, a0 ^ alpha_word(level - 1, a1), dinv);
    uint64_t b1 = mul_w(level - 1, a1, dinv);
    return b0 | (b1 << h);
}

/* --- exported API: all elements as (lo, hi) pairs --- */

void tower_init(void) { init_tables(); }

void tower_mul(int level, uint64_t alo, uint64_t ahi, uint64_t blo,
               uint64_t bhi, uint64_t *out) {
    if (level <= 6) { out[0] = mul_w(level, alo, blo); out[1] = 0; return; }
    m128(alo, ahi, blo, bhi, out);
}

void tower_square(int level, uint64_t alo, uint64_t ahi, uint64_t *out) {
    if (level <= 6) { out[0] = square_w(level, alo); out[1] = 0; return; }
    uint64_t s0 = square_w(6, alo), s1 = square_w(6, ahi);
    out[0] = s0 ^ s1;
    out[1] = a64(s1);
}

void tower_invert(int level, uint64_t alo, uint64_t ahi, uint64_t *out) {
    if (level <= 6) { out[0] = invert_w(level, alo); out[1] = 0; return; }
    if (ahi == 0) { out[0] = invert_w(6, alo); out[1] = 0; return; }
    /* a = a0 + a1*X_7; d = a0^2 + alpha_6*a0*a1 + a1^2 in T_6 */
    uint64_t d = square_w(6, alo) ^ a64(m64(alo, ahi)) ^ square_w(6, ahi);
    uint64_t dinv = invert_w(6, d);
    out[0] = m64(alo ^ a64(ahi), dinv);
    out[1] = m64(ahi, dinv);
}

void tower_pow(int level, uint64_t alo, uint64_t ahi, uint64_t e,
               uint64_t *out) {
    uint64_t r[2] = {1, 0}, base[2] = {alo, ahi}, t[2];
    while (e) {
        if (e & 1) {
            tower_mul(level, r[0], r[1], base[0], base[1], t);
            r[0] = t[0]; r[1] = t[1];
        }
        tower_square(level, base[0], base[1], t);
        base[0] = t[0]; base[1] = t[1];
        e >>= 1;
    }
    out[0] = r[0];
    out[1] = r[1];
}

/* Batched variants over contiguous (lo, hi) pair arrays. */

void tower_mul_batch(int level, const uint64_t *a, const uint64_t *b,
                     uint64_t *out, size_t n) {
    if (level <= 6) {
        switch (level) {
            case 4:
                for (size_t i = 0; i < n; i++) {
                    out[2 * i] = m16(a[2 * i], b[2 * i]); out[2 * i + 1] = 0;
                }
                return;
            case 5:
                for (size_t i = 0; i < n; i++) {
                    out[2 * i] = m32(a[2 * i], b[2 * i]); out[2 * i + 1] = 0;
                }
                return;
            case 6:
                for (size_t i = 0; i < n; i++) {
                    out[2 * i] = m64(a[2 * i], b[2 * i]); out[2 * i + 1] = 0;
                }
                return;
            default:
                for (size_t i = 0; i < n; i++) {
                    out[2 * i] = m8(a[2 * i], b[2 * i]); out[2 * i + 1] = 0;
                }
                return;
        }
    }
    for (size_t i = 0; i < n; i++)
        m128(a[2 * i], a[2 * i + 1], b[2 * i], b[2 * i + 1], out + 2 * i);
}

/* Barycentric weights w_i = 1 / prod_{j != i} (x_i ^ x_j) over B128 points
 * given as (lo, hi) pairs. O(n^2) multiplies + n inverts; host-side domain
 * setup for univariate-skip Lagrange interpolation. */
void tower_barycentric_weights(const uint64_t *pts, size_t n, uint64_t *out) {
    uint64_t t[2];
    for (size_t i = 0; i < n; i++) {
        uint64_t p0 = 1, p1 = 0;
        for (size_t j = 0; j < n; j++) {
            if (j == i)
                continue;
            m128(p0, p1, pts[2 * i] ^ pts[2 * j], pts[2 * i + 1] ^ pts[2 * j + 1], t);
            p0 = t[0];
            p1 = t[1];
        }
        tower_invert(7, p0, p1, out + 2 * i);
    }
}

/* L_i(z) for all i via exclusive prefix/suffix products of (z ^ x_j):
 * handles z landing on a domain point without division. scratch must hold
 * 4*n uint64 (caller-provided to keep this allocation-free). */
void tower_lagrange_evals(const uint64_t *pts, const uint64_t *w, size_t n,
                          uint64_t zlo, uint64_t zhi, uint64_t *scratch,
                          uint64_t *out) {
    uint64_t *pre = scratch, *suf = scratch + 2 * n;
    uint64_t t[2];
    uint64_t p0 = 1, p1 = 0;
    for (size_t i = 0; i < n; i++) {
        pre[2 * i] = p0;
        pre[2 * i + 1] = p1;
        m128(p0, p1, zlo ^ pts[2 * i], zhi ^ pts[2 * i + 1], t);
        p0 = t[0];
        p1 = t[1];
    }
    p0 = 1;
    p1 = 0;
    for (size_t i = n; i-- > 0;) {
        suf[2 * i] = p0;
        suf[2 * i + 1] = p1;
        m128(p0, p1, zlo ^ pts[2 * i], zhi ^ pts[2 * i + 1], t);
        p0 = t[0];
        p1 = t[1];
    }
    for (size_t i = 0; i < n; i++) {
        m128(pre[2 * i], pre[2 * i + 1], suf[2 * i], suf[2 * i + 1], t);
        m128(t[0], t[1], w[2 * i], w[2 * i + 1], out + 2 * i);
    }
}
