/* LZF, the stream format of HDF5's filter 32000 (h5py's "lzf"), written from
 * the format's public description (Marc Lehmann's liblzf, which h5py's filter
 * wraps).  Host code, built with the system's C compiler by
 * ops/_build.py::load_host and bound with ctypes by io/lzf.py; it replaces no
 * TPU kernel: the JAX package's counterpart is h5py's own C filter, which runs
 * on the host too.
 *
 * A stream is a run of tokens, each starting with a control byte c:
 *   c < 32   a literal run: the next c + 1 bytes are copied out;
 *   c >= 32  a back-reference: length (c >> 5), plus the next byte when that
 *            is 7, plus 2; offset ((c & 31) << 8) + the following byte + 1
 *            back from the end of the output.  The copy may overlap the
 *            bytes it writes (a run).
 * So a literal run holds at most 32 bytes, a back-reference copies 3 to 264
 * bytes from at most 8192 bytes back.
 *
 * The encoder finds repeats through a table of the last position of each
 * hashed 3-byte sequence, extends a match as far as it goes (up to 264
 * bytes), and files the positions inside a match in the table too.  It is
 * greedy and deterministic: io/lzf.py::lzf_compress_plain repeats it step
 * for step, so the two give the same bytes.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define HASH_LOG 14
#define MAX_LIT 32
#define MAX_OFF 8192
#define MAX_REF 264

static inline uint32_t seq3(const uint8_t *p)
{
    return ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
}

static inline uint32_t hash3(uint32_t v)
{
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

/* Copy in[start, end) out as literal runs of at most MAX_LIT bytes.
 * Returns the new output position, or -1 where out_len is exceeded. */
static int64_t put_literals(const uint8_t *in, int64_t start, int64_t end, uint8_t *out,
                            int64_t op, int64_t out_len)
{
    while (start < end) {
        int64_t n = end - start < MAX_LIT ? end - start : MAX_LIT;
        if (op + 1 + n > out_len)
            return -1;
        out[op++] = (uint8_t)(n - 1);
        memcpy(out + op, in + start, (size_t)n);
        op += n;
        start += n;
    }
    return op;
}

/* Compress in[0, in_len) into out[0, out_len).  Returns the stream's length,
 * or 0 where it would not fit in out_len bytes (or in_len is 0). */
int64_t lzf_encode(const uint8_t *in, int64_t in_len, uint8_t *out, int64_t out_len)
{
    uint32_t *table;  /* position + 1 of the last sequence of each hash; 0: none */
    int64_t ip = 0, lit = 0, op = 0;

    if (in_len <= 0)
        return 0;
    table = (uint32_t *)calloc((size_t)1 << HASH_LOG, sizeof(uint32_t));
    if (!table)
        return 0;
    while (ip + 2 < in_len) {
        uint32_t cur = seq3(in + ip), h = hash3(cur);
        int64_t ref = (int64_t)table[h] - 1;
        table[h] = (uint32_t)(ip + 1);
        /* one test, mostly false on data that does not repeat: read the
         * candidate's bytes (at ip itself where there is none) without a
         * branch on whether it exists */
        if ((ref >= 0) & (ip - ref <= MAX_OFF) & (seq3(in + (ref >= 0 ? ref : ip)) == cur)) {
            int64_t max_len = in_len - ip < MAX_REF ? in_len - ip : MAX_REF;
            int64_t len = 3, off = ip - ref - 1, code;
            while (len < max_len && in[ref + len] == in[ip + len])
                len++;
            op = put_literals(in, lit, ip, out, op, out_len);
            code = len - 2;
            if (op < 0 || op + (code >= 7 ? 3 : 2) > out_len) {
                free(table);
                return 0;
            }
            if (code < 7) {
                out[op++] = (uint8_t)((code << 5) | (off >> 8));
            } else {
                out[op++] = (uint8_t)((7 << 5) | (off >> 8));
                out[op++] = (uint8_t)(code - 7);
            }
            out[op++] = (uint8_t)(off & 0xff);
            for (int64_t k = ip + 1; k < ip + len && k + 2 < in_len; k++)
                table[hash3(seq3(in + k))] = (uint32_t)(k + 1);
            ip += len;
            lit = ip;
        } else {
            ip++;
        }
    }
    free(table);
    op = put_literals(in, lit, in_len, out, op, out_len);
    return op < 0 ? 0 : op;
}

/* Decompress in[0, in_len) into out[0, out_len).  Returns the bytes
 * written, -1 where the output would exceed out_len, -2 where the stream
 * is not valid LZF (a token cut short, a reference before the start). */
int64_t lzf_decode(const uint8_t *in, int64_t in_len, uint8_t *out, int64_t out_len)
{
    int64_t ip = 0, op = 0;

    while (ip < in_len) {
        int64_t c = in[ip++];
        if (c < 32) {
            int64_t n = c + 1;
            if (ip + n > in_len)
                return -2;
            if (op + n > out_len)
                return -1;
            memcpy(out + op, in + ip, (size_t)n);
            ip += n;
            op += n;
        } else {
            int64_t len = c >> 5, ref;
            if (len == 7) {
                if (ip >= in_len)
                    return -2;
                len += in[ip++];
            }
            if (ip >= in_len)
                return -2;
            ref = op - ((c & 31) << 8) - 1 - in[ip++];
            len += 2;
            if (ref < 0)
                return -2;
            if (op + len > out_len)
                return -1;
            for (int64_t k = 0; k < len; k++)
                out[op + k] = out[ref + k];
            op += len;
        }
    }
    return op;
}
