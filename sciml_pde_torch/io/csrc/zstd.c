/* zstd (RFC 8878) frames: a decoder of the whole format but dictionaries,
 * and CRC-32C (Castagnoli, reflected, as iSCSI and OCDBT use it).  Written
 * from the RFC.  Host code, built with the system's C compiler by
 * ops/_build.py::load_host and bound with ctypes by io/zstd.py; it replaces
 * no TPU kernel: the JAX package's counterpart is tensorstore's zstd, which
 * runs on the host too.  The frame writer is io/zstd.py's (raw blocks).
 *
 * A frame: magic 0xFD2FB528, a header (window, content size, dictionary,
 * checksum flag), blocks (raw, RLE or compressed; at most 128 KiB each) and
 * an optional XXH64 checksum of the content (its low 4 bytes).  A
 * compressed block is a literals section (raw, RLE or Huffman-coded in 1 or
 * 4 streams, the Huffman table given by direct or FSE-coded weights, or the
 * previous one repeated) and a sequences section: (literal length, match
 * length, offset) codes, each through an FSE table that is predefined, RLE,
 * given or repeated, read from one backward bitstream; offsets 1 to 3 name
 * the three repeat offsets.  Tables and repeat offsets live for a frame.
 *
 * zstd_decompress decodes every frame of src (skippable frames skipped) into
 * dst and returns the bytes written, or a negative ZE_* code: a corrupt or
 * truncated input never reads or writes outside its buffers.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    ZE_TRUNCATED = -1,    /* the input ends inside a frame */
    ZE_MAGIC = -2,        /* not a zstd frame */
    ZE_HEADER = -3,       /* reserved bit set or bad frame header */
    ZE_DICTIONARY = -4,   /* the frame names a dictionary */
    ZE_BLOCK = -5,        /* reserved block type or a block over its maximum */
    ZE_LITERALS = -6,     /* corrupt literals section */
    ZE_HUFFMAN = -7,      /* corrupt Huffman table or stream */
    ZE_FSE = -8,          /* corrupt FSE table */
    ZE_SEQUENCES = -9,    /* corrupt sequences section */
    ZE_OFFSET = -10,      /* a match before the start of the output */
    ZE_CAPACITY = -11,    /* the output does not fit in dst */
    ZE_SIZE = -12,        /* the content is not the frame's content size */
    ZE_CHECKSUM = -13,    /* the content checksum disagrees */
    ZE_NOMEM = -14,
};

#define MAX_BLOCK (128 * 1024)

/* ---------------------------------------------------------------- bits */

static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

/* n <= 56 bits of the little-endian bit string s[0..len) from bit pos;
 * bits before 0 (pos < 0) and past the end read as zero. */
static inline uint64_t bits_at(const uint8_t *s, size_t len, int64_t pos, int n)
{
    if (n == 0)
        return 0;
    if (pos < 0) {
        if (n + pos <= 0)
            return 0;
        return bits_at(s, len, 0, (int)(n + pos)) << (-pos);
    }
    size_t b = (size_t)(pos >> 3);
    uint64_t w = 0;
    if (b + 8 <= len) {
        memcpy(&w, s + b, 8);
    } else if (b < len) {
        memcpy(&w, s + b, len - b);
    }
    return (w >> (pos & 7)) & ((n == 64) ? ~0ull : ((1ull << n) - 1));
}

/* A backward bitstream: the last byte's highest set bit marks its end. */
typedef struct {
    const uint8_t *s;
    size_t len;
    int64_t pos; /* bits left; below 0 once read past the start */
} bwd_t;

static int bwd_init(bwd_t *b, const uint8_t *s, size_t len)
{
    if (len == 0 || s[len - 1] == 0)
        return -1;
    b->s = s;
    b->len = len;
    b->pos = (int64_t)(len - 1) * 8 + highbit(s[len - 1]);
    return 0;
}

static inline uint64_t bwd_read(bwd_t *b, int n)
{
    b->pos -= n;
    return bits_at(b->s, b->len, b->pos, n);
}

/* ---------------------------------------------------------------- FSE */

#define FSE_MAX_LOG 9
#define FSE_MAX_SYMS 256

typedef struct {
    uint8_t sym[1 << FSE_MAX_LOG];
    uint8_t nbits[1 << FSE_MAX_LOG];
    uint16_t base[1 << FSE_MAX_LOG];
    int log;
} fse_t;

static int fse_build(fse_t *t, const int16_t *norm, int nsym, int log)
{
    int size = 1 << log, high = size - 1, pos = 0;
    uint16_t next[FSE_MAX_SYMS];
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            if (high < 0)
                return -1;
            t->sym[high--] = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)(norm[s] > 0 ? norm[s] : 0);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t->sym[pos] = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0)
        return -1;
    for (int i = 0; i < size; i++) {
        int s = t->sym[i];
        uint32_t ns = next[s]++;
        if (ns == 0)
            return -1;
        int nb = log - highbit(ns);
        t->nbits[i] = (uint8_t)nb;
        t->base[i] = (uint16_t)((ns << nb) - size);
    }
    t->log = log;
    return 0;
}

static void fse_rle(fse_t *t, uint8_t sym)
{
    t->sym[0] = sym;
    t->nbits[0] = 0;
    t->base[0] = 0;
    t->log = 0;
}

/* An FSE table description at src: returns the bytes it takes, or < 0. */
static int64_t fse_read(fse_t *t, const uint8_t *src, size_t len, int max_log, int max_sym)
{
    if (len < 1)
        return -1;
    int16_t norm[FSE_MAX_SYMS];
    int64_t pos = 0, end = (int64_t)len * 8;
    int log = (int)bits_at(src, len, 0, 4) + 5;
    pos = 4;
    if (log > max_log)
        return -1;
    int remaining = 1 << log, sym = 0;
    while (remaining > 0 && sym <= max_sym) {
        int nb = highbit((uint32_t)remaining + 1) + 1;
        if (pos + nb - 1 > end)
            return -1;
        uint32_t val = (uint32_t)bits_at(src, len, pos, nb);
        uint32_t lower = (1u << (nb - 1)) - 1;
        uint32_t thr = (1u << nb) - 1 - ((uint32_t)remaining + 1);
        if ((val & lower) < thr) {
            val &= lower;
            pos += nb - 1;
        } else {
            if (val > lower)
                val -= thr;
            pos += nb;
        }
        if (pos > end)
            return -1;
        int p = (int)val - 1;
        remaining -= p < 0 ? -p : p;
        norm[sym++] = (int16_t)p;
        if (p == 0) {
            for (;;) {
                if (pos + 2 > end)
                    return -1;
                int rep = (int)bits_at(src, len, pos, 2);
                pos += 2;
                for (int i = 0; i < rep; i++) {
                    if (sym > max_sym)
                        return -1;
                    norm[sym++] = 0;
                }
                if (rep != 3)
                    break;
            }
        }
    }
    if (remaining != 0 || sym > max_sym + 1)
        return -1;
    if (fse_build(t, norm, sym, log))
        return -1;
    return (pos + 7) >> 3;
}

/* ------------------------------------------------------------- Huffman */

#define HUF_MAX_BITS 11

typedef struct {
    uint8_t sym[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
    int max_bits; /* 0: no table yet */
} huf_t;

static int huf_from_weights(huf_t *h, const uint8_t *w, int nw)
{
    uint32_t total = 0;
    for (int i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS)
            return -1;
        if (w[i])
            total += 1u << (w[i] - 1);
    }
    if (total == 0)
        return -1;
    int max_bits = highbit(total) + 1;
    if (max_bits > HUF_MAX_BITS)
        return -1;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1))
        return -1; /* not a power of two */
    uint8_t weights[256];
    if (nw >= 256)
        return -1;
    memcpy(weights, w, (size_t)nw);
    weights[nw] = (uint8_t)(highbit(rest) + 1);
    int nsym = nw + 1;
    /* codes in order of weight, lowest first, then of symbol */
    uint32_t rank_count[HUF_MAX_BITS + 2] = {0};
    uint8_t bits[256];
    for (int s = 0; s < nsym; s++) {
        bits[s] = weights[s] ? (uint8_t)(max_bits + 1 - weights[s]) : 0;
        rank_count[bits[s]]++;
    }
    uint32_t rank_idx[HUF_MAX_BITS + 2];
    rank_idx[max_bits] = 0;
    for (int b = max_bits; b >= 1; b--) {
        rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
        if (rank_idx[b - 1] > (1u << max_bits))
            return -1;
        memset(h->nbits + rank_idx[b], b, rank_idx[b - 1] - rank_idx[b]);
    }
    if (rank_idx[0] != (1u << max_bits))
        return -1;
    for (int s = 0; s < nsym; s++) {
        if (bits[s]) {
            uint32_t n = 1u << (max_bits - bits[s]);
            memset(h->sym + rank_idx[bits[s]], s, n);
            rank_idx[bits[s]] += n;
        }
    }
    h->max_bits = max_bits;
    return 0;
}

/* The Huffman tree description at src: returns its bytes, or < 0. */
static int64_t huf_read(huf_t *h, const uint8_t *src, size_t len)
{
    if (len < 1)
        return -1;
    uint8_t w[256];
    int nw = 0, hb = src[0];
    if (hb >= 128) {
        nw = hb - 127;
        size_t nbytes = (size_t)(nw + 1) / 2;
        if (1 + nbytes > len)
            return -1;
        for (int i = 0; i < nw; i++) {
            uint8_t b = src[1 + i / 2];
            w[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
        if (huf_from_weights(h, w, nw))
            return -1;
        return 1 + (int64_t)nbytes;
    }
    if ((size_t)hb + 1 > len || hb == 0)
        return -1;
    const uint8_t *s = src + 1;
    fse_t t;
    int64_t hl = fse_read(&t, s, (size_t)hb, 6, 255);
    if (hl < 0 || hl >= hb)
        return -1;
    bwd_t b;
    if (bwd_init(&b, s + hl, (size_t)(hb - hl)))
        return -1;
    uint32_t s1 = (uint32_t)bwd_read(&b, t.log), s2 = (uint32_t)bwd_read(&b, t.log);
    for (;;) {
        if (nw >= 255)
            return -1;
        w[nw++] = t.sym[s1];
        s1 = t.base[s1] + (uint32_t)bwd_read(&b, t.nbits[s1]);
        if (b.pos < 0) {
            w[nw++] = t.sym[s2];
            break;
        }
        if (nw >= 255)
            return -1;
        w[nw++] = t.sym[s2];
        s2 = t.base[s2] + (uint32_t)bwd_read(&b, t.nbits[s2]);
        if (b.pos < 0) {
            if (nw >= 255)
                return -1;
            w[nw++] = t.sym[s1];
            break;
        }
    }
    if (huf_from_weights(h, w, nw))
        return -1;
    return 1 + hb;
}

static int huf_stream(const huf_t *h, const uint8_t *src, size_t len, uint8_t *out, size_t n)
{
    bwd_t b;
    if (bwd_init(&b, src, len))
        return -1;
    int mb = h->max_bits;
    uint32_t mask = (1u << mb) - 1;
    uint32_t st = (uint32_t)bwd_read(&b, mb);
    for (size_t i = 0; i < n; i++) {
        out[i] = h->sym[st];
        int nb = h->nbits[st];
        st = ((st << nb) | (uint32_t)bwd_read(&b, nb)) & mask;
    }
    return b.pos == -mb ? 0 : -1;
}

/* ----------------------------------------------------------- sequences */

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,   8,   9,    10,   11,
                                     12, 13, 14, 15, 16, 18, 20, 22,  24,  28,   32,   40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                                     32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                                     17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                                     31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                                     65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

typedef struct {
    huf_t huf;
    fse_t ll, of, ml;
    int have_ll, have_of, have_ml;
    uint32_t rep[3];
    uint8_t *lit; /* a block's literals */
} frame_state_t;

/* One table of a sequences section by its mode; returns bytes read or < 0. */
static int64_t seq_table(fse_t *t, int *have, int mode, const uint8_t *src, size_t len,
                         const int16_t *dflt, int ndflt, int dflt_log, int max_log, int max_sym)
{
    switch (mode) {
    case 0:
        if (fse_build(t, dflt, ndflt, dflt_log))
            return -1;
        *have = 1;
        return 0;
    case 1:
        if (len < 1 || src[0] > max_sym)
            return -1;
        fse_rle(t, src[0]);
        *have = 1;
        return 1;
    case 2: {
        int64_t n = fse_read(t, src, len, max_log, max_sym);
        if (n < 0)
            return -1;
        *have = 1;
        return n;
    }
    default:
        return *have ? 0 : -1;
    }
}

static int64_t decode_block(frame_state_t *fs, const uint8_t *src, size_t len, uint8_t *dst,
                            size_t cap, size_t out0, size_t block_max)
{
    /* literals section */
    if (len < 1)
        return ZE_LITERALS;
    int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t regen = 0, csize = 0, hdr = 0;
    int nstreams = 1;
    if (ltype < 2) {
        if (sf == 0 || sf == 2) {
            regen = src[0] >> 3;
            hdr = 1;
        } else if (sf == 1) {
            if (len < 2)
                return ZE_LITERALS;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
            hdr = 2;
        } else {
            if (len < 3)
                return ZE_LITERALS;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
            hdr = 3;
        }
    } else {
        if (sf < 2) {
            if (len < 3)
                return ZE_LITERALS;
            uint32_t v = src[0] | (src[1] << 8) | ((uint32_t)src[2] << 16);
            regen = (v >> 4) & 0x3FF;
            csize = (v >> 14) & 0x3FF;
            hdr = 3;
            nstreams = sf == 0 ? 1 : 4;
        } else if (sf == 2) {
            if (len < 4)
                return ZE_LITERALS;
            uint32_t v = src[0] | (src[1] << 8) | ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
            regen = (v >> 4) & 0x3FFF;
            csize = (v >> 18) & 0x3FFF;
            hdr = 4;
            nstreams = 4;
        } else {
            if (len < 5)
                return ZE_LITERALS;
            uint32_t v = src[0] | (src[1] << 8) | ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
            regen = (v >> 4) & 0x3FFFF;
            csize = (v >> 22) | ((size_t)src[4] << 10);
            hdr = 5;
            nstreams = 4;
        }
    }
    if (regen > block_max)
        return ZE_LITERALS;
    uint8_t *lit = fs->lit;
    size_t pos = hdr;
    if (ltype == 0) {
        if (pos + regen > len)
            return ZE_LITERALS;
        memcpy(lit, src + pos, regen);
        pos += regen;
    } else if (ltype == 1) {
        if (pos + 1 > len)
            return ZE_LITERALS;
        memset(lit, src[pos], regen);
        pos += 1;
    } else {
        if (pos + csize > len)
            return ZE_LITERALS;
        const uint8_t *c = src + pos;
        size_t cl = csize;
        if (ltype == 2) {
            int64_t tl = huf_read(&fs->huf, c, cl);
            if (tl < 0)
                return ZE_HUFFMAN;
            c += tl;
            cl -= (size_t)tl;
        } else if (fs->huf.max_bits == 0) {
            return ZE_HUFFMAN;
        }
        if (nstreams == 1) {
            if (huf_stream(&fs->huf, c, cl, lit, regen))
                return ZE_HUFFMAN;
        } else {
            if (cl < 6 || 3 * ((regen + 3) / 4) > regen)
                return ZE_LITERALS;
            size_t l1 = c[0] | (c[1] << 8), l2 = c[2] | (c[3] << 8), l3 = c[4] | (c[5] << 8);
            if (6 + l1 + l2 + l3 > cl)
                return ZE_LITERALS;
            size_t l4 = cl - 6 - l1 - l2 - l3, seg = (regen + 3) / 4;
            const uint8_t *p = c + 6;
            if (huf_stream(&fs->huf, p, l1, lit, seg) ||
                huf_stream(&fs->huf, p + l1, l2, lit + seg, seg) ||
                huf_stream(&fs->huf, p + l1 + l2, l3, lit + 2 * seg, seg) ||
                huf_stream(&fs->huf, p + l1 + l2 + l3, l4, lit + 3 * seg, regen - 3 * seg))
                return ZE_HUFFMAN;
        }
        pos += csize;
    }

    /* sequences section */
    if (pos >= len)
        return ZE_SEQUENCES;
    size_t nseq = src[pos];
    if (nseq < 128) {
        pos += 1;
    } else if (nseq < 255) {
        if (pos + 2 > len)
            return ZE_SEQUENCES;
        nseq = ((nseq - 128) << 8) + src[pos + 1];
        pos += 2;
    } else {
        if (pos + 3 > len)
            return ZE_SEQUENCES;
        nseq = src[pos + 1] + ((size_t)src[pos + 2] << 8) + 0x7F00;
        pos += 3;
    }
    size_t out = out0, li = 0;
    if (nseq > 0) {
        if (pos >= len)
            return ZE_SEQUENCES;
        int modes = src[pos++];
        if (modes & 3)
            return ZE_SEQUENCES;
        int64_t n;
        n = seq_table(&fs->ll, &fs->have_ll, (modes >> 6) & 3, src + pos, len - pos,
                      LL_DEFAULT, 36, 6, 9, 35);
        if (n < 0)
            return ZE_FSE;
        pos += (size_t)n;
        n = seq_table(&fs->of, &fs->have_of, (modes >> 4) & 3, src + pos, len - pos,
                      OF_DEFAULT, 29, 5, 8, 31);
        if (n < 0)
            return ZE_FSE;
        pos += (size_t)n;
        n = seq_table(&fs->ml, &fs->have_ml, (modes >> 2) & 3, src + pos, len - pos,
                      ML_DEFAULT, 53, 6, 9, 52);
        if (n < 0)
            return ZE_FSE;
        pos += (size_t)n;
        bwd_t b;
        if (pos >= len || bwd_init(&b, src + pos, len - pos))
            return ZE_SEQUENCES;
        uint32_t sll = (uint32_t)bwd_read(&b, fs->ll.log);
        uint32_t sof = (uint32_t)bwd_read(&b, fs->of.log);
        uint32_t sml = (uint32_t)bwd_read(&b, fs->ml.log);
        for (size_t i = 0; i < nseq; i++) {
            int ofc = fs->of.sym[sof], mlc = fs->ml.sym[sml], llc = fs->ll.sym[sll];
            if (ofc > 31 || mlc > 52 || llc > 35)
                return ZE_SEQUENCES;
            uint64_t ofv = (1ull << ofc) + bwd_read(&b, ofc);
            size_t ml = ML_BASE[mlc] + (size_t)bwd_read(&b, ML_BITS[mlc]);
            size_t ll = LL_BASE[llc] + (size_t)bwd_read(&b, LL_BITS[llc]);
            uint64_t off;
            if (ofv > 3) {
                off = ofv - 3;
                fs->rep[2] = fs->rep[1];
                fs->rep[1] = fs->rep[0];
                fs->rep[0] = (uint32_t)off;
            } else {
                int idx = (int)ofv - 1 + (ll == 0);
                if (idx == 0) {
                    off = fs->rep[0];
                } else {
                    off = idx == 3 ? (uint64_t)fs->rep[0] - 1 : fs->rep[idx];
                    if (idx == 2 || idx == 3)
                        fs->rep[2] = fs->rep[1];
                    fs->rep[1] = fs->rep[0];
                    fs->rep[0] = (uint32_t)off;
                }
            }
            if (i + 1 < nseq) {
                sll = fs->ll.base[sll] + (uint32_t)bwd_read(&b, fs->ll.nbits[sll]);
                sml = fs->ml.base[sml] + (uint32_t)bwd_read(&b, fs->ml.nbits[sml]);
                sof = fs->of.base[sof] + (uint32_t)bwd_read(&b, fs->of.nbits[sof]);
            }
            if (b.pos < 0)
                return ZE_SEQUENCES;
            if (li + ll > regen)
                return ZE_SEQUENCES;
            if (out + ll + ml > cap)
                return ZE_CAPACITY;
            memcpy(dst + out, lit + li, ll);
            out += ll;
            li += ll;
            if (off == 0 || off > out)
                return ZE_OFFSET;
            uint8_t *d = dst + out;
            const uint8_t *m = d - off;
            if (off >= ml) {
                memcpy(d, m, ml);
            } else {
                for (size_t k = 0; k < ml; k++)
                    d[k] = m[k];
            }
            out += ml;
        }
        if (b.pos != 0)
            return ZE_SEQUENCES;
    } else if (pos != len) {
        return ZE_SEQUENCES;
    }
    if (out + (regen - li) > cap)
        return ZE_CAPACITY;
    memcpy(dst + out, lit + li, regen - li);
    out += regen - li;
    if (out - out0 > block_max)
        return ZE_BLOCK;
    return (int64_t)(out - out0);
}

/* ----------------------------------------------------------- checksums */

#define P1 11400714785074694791ull
#define P2 14029467366897019727ull
#define P3 1609587929392839161ull
#define P4 9650029242287828579ull
#define P5 2870177450012600261ull

static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t rd64(const uint8_t *p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline uint32_t rd32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t xround(uint64_t acc, uint64_t v) { return rotl(acc + v * P2, 31) * P1; }
static inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t zstd_xxh64(const uint8_t *p, int64_t n, uint64_t seed)
{
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(h, v1);
        h = xmerge(h, v2);
        h = xmerge(h, v3);
        h = xmerge(h, v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    for (; p + 8 <= end; p += 8)
        h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ ((uint64_t)rd32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; p++)
        h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

static uint32_t crc_table[256];
static int crc_ready;

uint32_t zstd_crc32c(const uint8_t *p, int64_t n)
{
    if (!crc_ready) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            crc_table[i] = c;
        }
        crc_ready = 1;
    }
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++)
        c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

/* --------------------------------------------------------------- frames */

/* The content size the first frame at src declares, -1 where it declares
 * none, or a negative ZE_* code below -1. */
int64_t zstd_content_size(const uint8_t *src, int64_t len)
{
    if (len < 5)
        return ZE_TRUNCATED;
    if (rd32(src) != 0xFD2FB528u)
        return ZE_MAGIC;
    int fhd = src[4], fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did = fhd & 3;
    int64_t pos = 5 + !single + (did ? (1 << (did - 1)) : 0);
    int fcs_size = fcs_flag ? (1 << fcs_flag) : single;
    if (fcs_size == 0)
        return -1;
    if (pos + fcs_size > len)
        return ZE_TRUNCATED;
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; i++)
        v |= (uint64_t)src[pos + i] << (8 * i);
    if (fcs_size == 2)
        v += 256;
    return (int64_t)v;
}

static int64_t decode_frame(const uint8_t *src, size_t len, size_t *used, uint8_t *dst, size_t cap,
                            frame_state_t *fs)
{
    size_t pos = 5;
    if (len < 6)
        return ZE_TRUNCATED;
    int fhd = src[4], fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    int did = fhd & 3;
    if (fhd & 8)
        return ZE_HEADER;
    uint64_t window = 0;
    if (!single) {
        int wd = src[pos++], e = wd >> 3, m = wd & 7;
        uint64_t base = 1ull << (10 + e);
        window = base + (base / 8) * (uint64_t)m;
    }
    size_t dsize = did ? ((size_t)1 << (did - 1)) : 0;
    if (pos + dsize > len)
        return ZE_TRUNCATED;
    uint32_t dict = 0;
    for (size_t i = 0; i < dsize; i++)
        dict |= (uint32_t)src[pos + i] << (8 * i);
    pos += dsize;
    if (dict != 0)
        return ZE_DICTIONARY;
    int fcs_size = fcs_flag ? (1 << fcs_flag) : single;
    int64_t fcs = -1;
    if (fcs_size) {
        if (pos + (size_t)fcs_size > len)
            return ZE_TRUNCATED;
        uint64_t v = 0;
        for (int i = 0; i < fcs_size; i++)
            v |= (uint64_t)src[pos + i] << (8 * i);
        if (fcs_size == 2)
            v += 256;
        fcs = (int64_t)v;
        pos += (size_t)fcs_size;
    }
    if (single)
        window = (uint64_t)fcs;
    size_t block_max = window < MAX_BLOCK ? (size_t)window : MAX_BLOCK;
    fs->huf.max_bits = 0;
    fs->have_ll = fs->have_of = fs->have_ml = 0;
    fs->rep[0] = 1;
    fs->rep[1] = 4;
    fs->rep[2] = 8;
    size_t out = 0;
    for (;;) {
        if (pos + 3 > len)
            return ZE_TRUNCATED;
        uint32_t bh = src[pos] | (src[pos + 1] << 8) | ((uint32_t)src[pos + 2] << 16);
        pos += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t bsize = bh >> 3;
        if (type == 3)
            return ZE_BLOCK;
        if (type == 1) {
            if (bsize > block_max)
                return ZE_BLOCK;
            if (pos + 1 > len)
                return ZE_TRUNCATED;
            if (out + bsize > cap)
                return ZE_CAPACITY;
            memset(dst + out, src[pos], bsize);
            out += bsize;
            pos += 1;
        } else {
            if (bsize > block_max)
                return ZE_BLOCK;
            if (pos + bsize > len)
                return ZE_TRUNCATED;
            if (type == 0) {
                if (out + bsize > cap)
                    return ZE_CAPACITY;
                memcpy(dst + out, src + pos, bsize);
                out += bsize;
            } else {
                int64_t n = decode_block(fs, src + pos, bsize, dst, cap, out, block_max);
                if (n < 0)
                    return n;
                out += (size_t)n;
            }
            pos += bsize;
        }
        if (last)
            break;
    }
    if (fcs >= 0 && (uint64_t)fcs != out)
        return ZE_SIZE;
    if (checksum) {
        if (pos + 4 > len)
            return ZE_TRUNCATED;
        uint32_t want = rd32(src + pos);
        if ((uint32_t)zstd_xxh64(dst, (int64_t)out, 0) != want)
            return ZE_CHECKSUM;
        pos += 4;
    }
    *used = pos;
    return (int64_t)out;
}

int64_t zstd_decompress(uint8_t *dst, int64_t cap, const uint8_t *src, int64_t len)
{
    frame_state_t *fs = malloc(sizeof(frame_state_t));
    if (!fs)
        return ZE_NOMEM;
    fs->lit = malloc(MAX_BLOCK);
    if (!fs->lit) {
        free(fs);
        return ZE_NOMEM;
    }
    int64_t out = 0, pos = 0, ret = 0;
    if (len < 4)
        ret = ZE_TRUNCATED;
    while (ret == 0 && pos < len) {
        if (len - pos < 4) {
            ret = ZE_TRUNCATED;
            break;
        }
        uint32_t magic = rd32(src + pos);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            if (len - pos < 8) {
                ret = ZE_TRUNCATED;
                break;
            }
            int64_t skip = 8 + (int64_t)rd32(src + pos + 4);
            if (skip > len - pos) {
                ret = ZE_TRUNCATED;
                break;
            }
            pos += skip;
            continue;
        }
        if (magic != 0xFD2FB528u) {
            ret = ZE_MAGIC;
            break;
        }
        size_t used = 0;
        int64_t n = decode_frame(src + pos, (size_t)(len - pos), &used, dst + out,
                                 (size_t)(cap - out), fs);
        if (n < 0) {
            ret = n;
            break;
        }
        out += n;
        pos += (int64_t)used;
    }
    free(fs->lit);
    free(fs);
    return ret < 0 ? ret : out;
}
