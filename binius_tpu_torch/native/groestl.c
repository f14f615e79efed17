/* Grøstl-256 host core: T-table P/Q permutations on 8 little-endian column
 * words (the layout of binius_tpu_torch/hash/groestl.py's _py_permute_cols).
 * All tables are handed in from Python at init (derived there from first
 * principles); this file holds no hash constant.
 *
 * Counterpart of the reference's native Grøstl (crates/hash/src/groestl/),
 * used for the transcript's challenger and host-side Merkle hashing; the
 * trees of a commit are built on the card (K5, K6).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define G_ROUNDS 10

static uint64_t G_T[8][256];
static uint64_t G_PC[G_ROUNDS][8];
static uint64_t G_QC[G_ROUNDS][8];
static int32_t G_SP[8];
static int32_t G_SQ[8];

void groestl_init(const uint64_t *t, const uint64_t *pc, const uint64_t *qc,
                  const int32_t *sp, const int32_t *sq) {
    memcpy(G_T, t, sizeof(G_T));
    memcpy(G_PC, pc, sizeof(G_PC));
    memcpy(G_QC, qc, sizeof(G_QC));
    memcpy(G_SP, sp, sizeof(G_SP));
    memcpy(G_SQ, sq, sizeof(G_SQ));
}

static void permute(uint64_t c[8], int is_q) {
    const uint64_t(*consts)[8] = is_q ? G_QC : G_PC;
    const int32_t *sh = is_q ? G_SQ : G_SP;
    uint64_t t[8], n[8];
    for (int r = 0; r < G_ROUNDS; r++) {
        for (int i = 0; i < 8; i++)
            t[i] = c[i] ^ consts[r][i];
        for (int col = 0; col < 8; col++) {
            uint64_t acc = 0;
            for (int j = 0; j < 8; j++)
                acc ^= G_T[j][(t[(col + sh[j]) & 7] >> (8 * j)) & 0xFF];
            n[col] = acc;
        }
        memcpy(c, n, sizeof(n));
    }
}

void groestl_permute(uint64_t *cols, int is_q) { permute(cols, is_q); }

/* f(h, m) = P(h ^ m) ^ Q(m) ^ h, updating h in place. */
static void compress(uint64_t h[8], const uint64_t m[8]) {
    uint64_t hp[8], qm[8];
    for (int i = 0; i < 8; i++) {
        hp[i] = h[i] ^ m[i];
        qm[i] = m[i];
    }
    permute(hp, 0);
    permute(qm, 1);
    for (int i = 0; i < 8; i++)
        h[i] ^= hp[i] ^ qm[i];
}

void groestl_compress(uint64_t *h, const uint64_t *m) { compress(h, m); }

/* Absorb n_blocks consecutive 64-byte blocks into h. */
void groestl_compress_seq(uint64_t *h, const uint8_t *blocks, size_t n_blocks) {
    uint64_t m[8];
    for (size_t b = 0; b < n_blocks; b++) {
        memcpy(m, blocks + 64 * b, 64);
        compress(h, m);
    }
}

/* Omega(h): trunc_256(P(h) ^ h) -> out32. */
static void output_transform(const uint64_t h[8], uint8_t *out32) {
    uint64_t x[8];
    memcpy(x, h, sizeof(x));
    permute(x, 0);
    for (int i = 4; i < 8; i++) {
        uint64_t v = x[i] ^ h[i];
        memcpy(out32 + 8 * (i - 4), &v, 8);
    }
}

void groestl_output_transform(const uint64_t *h, uint8_t *out32) {
    output_transform(h, out32);
}

/* One-shot Grøstl-256 digest with spec padding. iv: 8 column words. */
void groestl_digest(const uint64_t *iv, const uint8_t *data, size_t len,
                    uint8_t *out32) {
    uint64_t h[8];
    memcpy(h, iv, sizeof(h));
    size_t full = len / 64;
    groestl_compress_seq(h, data, full);
    /* padding: 0x80, zeros, 64-bit BE total block count */
    uint8_t tail[128];
    size_t rem = len - full * 64;
    memcpy(tail, data + full * 64, rem);
    size_t n_blocks = (len + 8) / 64 + 1;
    size_t pad_len = n_blocks * 64 - len;
    memset(tail + rem, 0, pad_len);
    tail[rem] = 0x80;
    uint8_t *end = tail + rem + pad_len;
    for (int i = 0; i < 8; i++)
        end[-1 - i] = (uint8_t)(n_blocks >> (8 * i));
    groestl_compress_seq(h, tail, n_blocks - full);
    output_transform(h, out32);
}

/* Batch digest of n equal-length rows. */
void groestl_digest_batch(const uint64_t *iv, const uint8_t *blobs, size_t n,
                          size_t len, uint8_t *out) {
    for (size_t i = 0; i < n; i++)
        groestl_digest(iv, blobs + i * len, len, out + i * 32);
}

/* Merkle 2-to-1: out = trunc_256(P(pair) ^ pair) for each 64-byte row. */
void groestl_compress_pairs(const uint8_t *pairs, size_t n, uint8_t *out) {
    uint64_t c[8], x[8];
    for (size_t i = 0; i < n; i++) {
        memcpy(c, pairs + 64 * i, 64);
        memcpy(x, c, sizeof(c));
        permute(x, 0);
        for (int j = 4; j < 8; j++) {
            uint64_t v = x[j] ^ c[j];
            memcpy(out + 32 * i + 8 * (j - 4), &v, 8);
        }
    }
}
