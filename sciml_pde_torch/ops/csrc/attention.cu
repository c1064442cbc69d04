// Flash attention on Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of sciml_pde_tpu/ops/attention.py:
//   attention_fwd  <- _fwd_kernel (_attention_fwd_flat)      B3
//   attention_dq   <- _dq_kernel  (_attention_bwd_flat)      B4
//   attention_dkv  <- _dkv_kernel (_attention_bwd_flat)      B5
// on (BH, N, D) panels, q/k/v/do in f32 or bf16, l and delta (BH, N, 1) f32.
//
// The TPU kernels hold a whole K/V (or Q/dO) panel in VMEM.  At the NS
// transformer's shape (N = 1280, D = 64, bf16) K plus V alone are 320 KB,
// above the 227 KB of shared memory a block may use.  So each block owns a
// tile of rows and loops over the other panel in 64-row tiles:
//   forward  one block per (bh, 64 or 128 queries); an online max and sum over the
//            K/V tiles (rescaling the running output), then o = acc / sum and
//            l = m + log(sum), as _fwd_kernel's m + log(denom);
//   dQ       one block per (bh, 64 or 128 queries), loops over K/V tiles;
//   dK/dV    one block per (bh, 64 keys), loops over Q/dO tiles.
// No block writes what another reads, and there are no atomics, so the
// results are the same bits from run to run.  The blocks of all (bh, tile)
// pairs lie on grid.x, bh-major, so batch*heads has no 65535 limit.
//
// Head dims: any d % 8 == 0, as the Pallas kernels take.  A kernel is built
// for the padded dims 16, 32, 64, 96, 128, 160, 192 and 256; a panel's head
// dim is padded in shared memory to the next of them with zero columns,
// which change no score and no product and are never stored.  Above 128 the
// f32 forward, dQ and dK/dV run as one block of two warpgroups that share
// each score through shared memory (fwd_tf32w_kernel, dq_tf32w_kernel,
// dkv_tf32w_kernel), and each bf16 tensor-core body splits its output
// columns over two blocks, which both compute the scores (see below).
// Above 256, in both input types (the
// wide bodies; no configuration reaches these dims), the output columns are
// split over P = ceil(d / 128) groups of 128, the last one padded with zero
// columns:
//
//   The forward, dQ and dK/dV up to d = 1024 (fwd_wide_kernel,
//   dq_wide_kernel, dkv_wide_kernel) run as one thread-block cluster of P
//   blocks (at most the portable 8) per (bh, 64 rows), the cluster size a
//   launch attribute (cudaLaunchKernelEx).
//   Rank r stages only columns [128 r, 128 r + 128) of each panel by
//   cp.async (its own rows' for the block's life, the other panel's tiles
//   double-buffered) and takes its partial scores over them on the tensor
//   cores as the narrower bodies do: bf16 raw mma.sync m16n8k16, f32 split
//   TF32 with each k8 step's three MMAs into fresh accumulators.  The
//   cluster adds the P partials through distributed shared memory
//   (cluster_exchange): rank r adds rows [r R, r R + R) of every rank's
//   partials in rank order 0..P-1 and writes the sums back into every
//   rank's tile in place (a reduce-scatter, then a broadcast), so each sum
//   is formed once, in one order, and every rank holds the same bits, launch
//   after launch.  The forward's ranks then run the same online softmax and
//   p.v over their own 128 output columns (rank 0 writes l); in dK/dV the
//   rank that adds a score also forms p^T and ds^T from it, and every rank
//   takes p^T.do and ds^T.q over its columns (8 warps, 16 keys x 64 columns
//   each); dQ is dK/dV with the panels' roles swapped: the adding rank forms
//   ds and broadcasts only ds (half of dK/dV's stores back), and every rank
//   takes ds.k over its columns with the same k slice it took q.k^T from
//   (8 warps, 16 queries x 64 columns each).  One cluster barrier a tile
//   (barrier.cluster, its arrive and wait apart): tile j's exchange, tile
//   j + 1's partials while the exchange's stores land, the arrive,
//   (forward) tile j - 1's p.v while the other ranks arrive, the wait.
//   Bound by operations: bf16 3, 4 and 6 products at 989 TFLOP/s, f32 6, 9
//   and 12 TF32 passes at 495.  On the card the exchange moves 4 (P - 1)
//   bytes through distributed shared memory for each partial it reads and
//   each sum it stores (a score: the forward 8 (P - 1), dQ 12 (P - 1),
//   dK/dV 16 (P - 1)), near that network's rate, and the barriers cost
//   beside it (PERF.md).
//
//   Above 1024, with no upper limit on d, the forward, dQ and dK/dV run on
//   the tensor cores as one block per (bh, 64 rows, 256 output columns)
//   that loops over all of d itself (fwd_wide_tc_kernel, dq_wide_tc_kernel,
//   dkv_wide_tc_kernel): per tile of the other panel the block walks the
//   slices of d in order (256 bytes of a row: 64 f32 or 128 bf16 columns),
//   each slice of both panels staged by cp.async, double-buffered, and
//   accumulates the scores in registers over every slice, with the cluster
//   bodies' arithmetic (bf16 raw, f32 split TF32 with each k8 step's score
//   MMAs into fresh accumulators); then the forward's online softmax and
//   p.v, dQ's ds and ds.k, or dK/dV's p^T, ds^T, p^T.do and ds^T.q, over
//   the block's 256 columns.  Every one of the ceil(d / 256) blocks of a
//   row tile forms the tile's scores over all of d, the price of no
//   exchange and no limit; the bounds count the function's own products.

// Numerics follow the Pallas bodies: every input is widened to f32, p and ds
// stay f32 into their products, dq = (ds.k) * scale and dk = (ds^T.q) * scale
// with the unscaled q, and the outputs are rounded to the input type once,
// at the store.
//
// bf16 (the NS trainer's launches): three tensor-core bodies, bound by
// operations at the bf16 rate (989 TFLOP/s dense), 4 warps a block, tiles of
// the other panel double-buffered in shared memory by cp.async so the next
// tile's loads overlap this tile's products, fragments read by ldmatrix from
// rows padded by 8 elements (conflict-free).  Scores run raw as mma.sync
// m16n8k16 bf16 with f32 accumulation (q, k, v and do are exactly bf16),
// then take the scale in f32.  The f32 operands p and ds run split-bf16:
// x_hi = bf16(x), x_lo = bf16(x - x_hi), two MMAs into the same f32
// accumulator (x is carried to 2^-17 of itself; the f32 bound of the checks
// is 1e-5), the accumulator fragment of the scores reused as the A operand
// fragment without shared memory.  Each body counts the products its design
// needs to be exact as its bound, all at the bf16 rate.  Beside the MMAs each
// score costs an exp, its share of the split, of ldmatrix and of the
// cp.async addressing, and at 170-255 registers a thread (chip_smoke.py
// prints them) only 8-12 warps share an SM, few to hide the MMA -> exp ->
// split -> MMA chain: that, and mma.sync's rate below wgmma's, keeps the
// bodies at several times their bounds.  Above head dim 128 a block's f32 accumulators over all columns
// would not fit the registers beside the scores; two blocks each take half
// of the output columns (the forward's part 0 writes l).
//
//   forward (fwd_tc_kernel): q.k^T, then p.v as p_hi.v + p_lo.v: three
//   products of 2*BH*N^2*D.  s * scale in f32 is bit for bit the Pallas
//   body's (q * scale).k for a power-of-two scale (d = 16, 64, 256), one f32
//   rounding of each score away otherwise.  Four warps own a 128-row query
//   tile, 32 rows (two m16 tiles) each, so every K and V fragment read from
//   shared memory feeds two rows' products (for d > 64, where the registers
//   would not hold two tiles' output, 64 rows and 16 each).  The online max
//   and sum stay in f32 registers (quad shuffles); the output accumulates in
//   f32 registers and is normalised and rounded to bf16 once, at the store;
//   l = m + log(sum) is written in f32.
//
//   dQ (dq_tc_kernel): q.k^T, do.v^T, then ds.k as ds_hi.k + ds_lo.k: four
//   products.  Each warp owns 32 queries (two m16 tiles, d <= 64; else 16),
//   so every K and V fragment feeds two tiles' products; their q and do A
//   fragments stay in registers for the block's life (d <= 128).  Per 16
//   keys (32 for one m16 tile) of a K/V tile: s and dp in f32 registers, p =
//   2^(s * scale * log2(e) - l * log2(e)) (one FMA and one ex2.approx; p
//   moves by about 2^-22 of itself, far below the f32 bound) and ds = p *
//   (dp - delta) in place, then the ds fragments against K through
//   ldmatrix.trans.
//
//   dK/dV (dkv_tc_kernel): k.q^T and v.do^T with keys as rows, so that p^T
//   and ds^T come out as A fragments at once, then p^T.do and ds^T.q, each
//   as two terms: six products.  Each warp owns 16 keys; their k and v A
//   fragments stay in registers (d <= 64).  Q, dO and the tile's l and delta
//   are double-buffered; do and q enter the gradient products through
//   ldmatrix.trans.  p^T as in dQ, per 32 queries.
//
// f32 (the NS trainer's launches under bf16=False, and the checks of
// chip_smoke.py):
//
//   The forward, dQ and dK/dV up to head dim 128 (fwd_tf32_kernel,
//   dq_tf32_kernel, dkv_tf32_kernel) run on the tensor cores in split TF32,
//   bound by operations at the TF32 rate (495 TFLOP/s dense).  Every f32
//   operand x enters as hi = tf32(x) and lo = tf32(x - hi), both rounded to
//   nearest (split_tf32), and every product a.b as a_lo.b_hi + a_hi.b_lo +
//   a_hi.b_hi, three mma.sync m16n8k8 a k8 step with f32 accumulation
//   (a_lo.b_lo, about 2^-22 of the product, is dropped): the forward's
//   q.k^T and p.v are 6 TF32 passes, dQ's q.k^T, do.v^T and ds.k 9, dK/dV's
//   k.q^T, v.do^T, p^T.do and ds^T.q 12, and each body counts those as its
//   bound.  One pass of TF32 (10 mantissa bits) would leave the outputs near
//   1e-3 of the largest magnitude from the plain versions, far above the f32
//   bound of 1e-5; three keep them near 1e-6 (tests/test_torch_attention.py
//   rehearses both on the CPU).  The layout is the bf16 bodies': 4 warps, 16
//   rows of the block's own 64-row tile a warp, the other panel's tiles
//   (64 rows; the forward's FWD32_TK = 32 keys) double-buffered by cp.async
//   so the next tile's loads overlap this tile's products, rows padded by
//   4 floats.  Fragments are read by
//   ldmatrix .b16 on the f32 tiles (lane (g, t) receives f32 element [g][t]
//   of each 8 x 4 block, the TF32 A and B layout) and split as they are
//   read, each split fragment feeding every product of its step; q * scale
//   is formed in f32 before its split, as the Pallas body's q * scale.  p =
//   2^((s - l) * log2(e)) in the backward, 2^((s - m) * log2(e)) with the
//   running max m in the forward, s - l (s - m) in f32 first as in the plain
//   versions' exp(s - l) and exp(s - m) (l * log2(e) alone would round by
//   2^-24 of |l|).  Scores run in steps of SC keys (the forward: 32, its
//   whole K tile; dQ: 64, 32 above head dim 64) or queries (dK/dV: 32, 16
//   above 64), s and dp of 16 x SC a warp in registers.
//     The accumulator fragment (columns 2t and 2t + 1 of row g) is not the
//   TF32 A fragment (columns t and t + 4), so p and ds enter their products
//   with the contraction index permuted: k-slot t takes key (or query) 2t
//   and k-slot t + 4 takes 2t + 1, which makes {c0, c2, c1, c3} the A
//   fragment, and the B operand is read in the same order (rows 2t and
//   2t + 1 of each k8 step, plain 32-bit loads: banks 8t + g, conflict-free).
//   The sum is the same; only the order of the MMA's own adds changes.  So
//   p and ds never pass through shared memory.
//     An MMA rounds its result once, and not to nearest (a first design's
//   errors grew with the size of the scores and with the MMAs a score
//   took): a truncating adder biases every sum towards zero by up to a unit
//   in the last place of the accumulator, once an MMA.  So no sum runs long
//   in one accumulator.  The
//   long sums (p.v and ds.k over the keys, p^T.do and ds^T.q over the
//   queries) are taken per step into fresh accumulators, which an f32 add (to
//   nearest) then adds to the running sums (the forward's after its online
//   rescale by alpha, a K/V tile a step): 480 MMAs into one accumulator
//   over 1280 keys would carry the bias to the bound, per step it stays
//   within 24 MMAs (the CPU rehearsal models both).  The scores take each k8
//   step's three MMAs into fresh accumulators and add them in f32, since an
//   error in s moves p through the exponential by as much relative to p,
//   and s reaches tens where p is largest (dp's error stays relative to
//   dp, which keeps one accumulator).  dK/dV takes p^T.do over all columns
//   before ds^T.q, so that one set of split A fragments is live at a time.
//     The forward keeps its online max and sum in f32 registers (the max
//   over the quad by shuffles each K tile; the sum per thread, over the quad
//   at the end), normalises o by 1/sum once at the store and writes l = m +
//   log(sum) in f32.  Its K/V tiles hold 32 keys and each k8 step reads and
//   splits q again: 52 KB of shared memory and 160 registers a thread at
//   head dim 64, so three blocks (12 warps) share an SM.  A first design
//   (64-key tiles, q's split fragments held in registers, 255 registers,
//   two blocks an SM) and one that split K and V once a tile into hi and
//   lo planes in shared memory (40% fewer instructions) were slower on
//   the card: the body waits on latency more than it issues.
//     Far from the tensor cores' rate: each operand is split by every warp
//   that reads it, four integer or f32 instructions a value, beside each
//   three MMAs, and with 8-12 warps an SM the chains of ldmatrix, split,
//   MMA and add wait on latency.  Above head dim 64 dQ's and dK/dV's
//   shared memory (six f32 tiles) leaves one block an SM, and at 96 and 128 dK/dV's
//   two f32 accumulators over all columns overflow the registers into
//   spills; no configuration uses those head dims.
//
//   Above 128 one warp's f32 accumulators over all columns and its split
//   fragments would not fit the registers, so from 160 to 256 the forward, dQ
//   and dK/dV give the output columns to two warpgroups of one block
//   (fwd_tf32w_kernel, dq_tf32w_kernel, dkv_tf32w_kernel: a warp pair per 16
//   rows, the in-block form of the cluster bodies below, with no partial
//   sums).  The pair forms the scores of its rows against the other panel's
//   tile over all columns, once and in the order above: in the forward and
//   dK/dV each warp the 16 x 16 block against half of the tile; in dQ one
//   warp s and the other dp over the whole 16-key tile, so that each operand
//   of the scores is split by one warp.  It writes p (the forward: the two
//   warps of a pair first exchange their row maxima and both form the same
//   running max and alpha), p^T and ds^T (dK/dV) or p and dp - delta (dQ,
//   whose two warps then form the same ds) in f32 to staging tiles, and after
//   a barrier each warp takes the long products of its 16 rows over its
//   warpgroup's half of the columns from them, read back in the accumulator
//   layout (split_acc_as_a) with each tile's sums begun at 0.  The forward
//   owns 96-row tiles (12 warps, one block an SM: (8, 1280, d) is 112 blocks,
//   one wave; 64-row tiles left a second wave, or SMs with two blocks, and
//   took over a third longer on the card) and holds one K and one V tile of
//   32 keys (each tile's copies fly while the other tile is in use); dQ owns
//   80-row tiles (10 warps, one block an SM: 128 blocks, one wave; 64-row
//   blocks over 32-key tiles left a second wave and took 14-26% longer on
//   the card), holds q and do for the block's life and two K tiles and one V
//   tile of 16 keys (the next K tile flies during a whole tile, the next V
//   tile during ds.k);
//   dK/dV owns 64-key tiles, holds k and v for the block's life and Q/dO
//   tiles of 32 queries, two of each at 160 and 192, one at 256 (the next dO
//   tile flies during ds^T.q), one block an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define ATT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int TILE = 64;       // rows of the looped-over panel per tile
constexpr int NT_TC = 128;     // threads per block of the tensor-core bodies: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// The (bh, tile) pair of this block: grid.x = bh * ntiles + tile.
__device__ __forceinline__ void block_pair(int ntiles, size_t& bh, int& tile) {
  bh = blockIdx.x / (unsigned)ntiles;
  tile = (int)(blockIdx.x - bh * (unsigned)ntiles);
}

// ---------------------------------------------------------------------------
// tensor-core building blocks (bf16 inputs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + DP) of a (n, d) panel of T
// (bf16 or f32) into a [ROWS][DP + E] tile by cp.async, 16 bytes (E = 16 /
// sizeof(T) columns) per copy, ceil(ROWS * DP / (E * NTH)) copies a thread;
// rows at or past n and columns at or past d (d % 8 == 0) are zero-filled.
template <int DP, int ROWS = TILE, int NTH = NT_TC, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int r0, int n, int d,
                                                int c0 = 0) {
  constexpr int E = 16 / sizeof(T), CPR = DP / E;  // columns per copy, copies per row
  constexpr int COPIES = ROWS * CPR;
  const T* tile = src + (size_t)r0 * d + c0;
#pragma unroll
  for (int it = 0; it < (COPIES + NTH - 1) / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    if (COPIES % NTH != 0 && i >= COPIES) break;
    const int r = i / CPR, c = (i - r * CPR) * E;
    const bool ok = r0 + r < n && c0 + c < d;
    const T* g = ok ? tile + r * d + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (DP + E) + c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// Rows [r0, r0 + ROWS) of an f32 (n) row vector by cp.async, 4 bytes per
// copy (a row's offset need not be 16-byte aligned); rows at or past n are 0.
template <int ROWS = TILE>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    const bool ok = r0 + i < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + i)),
                 "l"(ok ? src + r0 + i : src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout (PTX m16n8k16; lane = 4 g + t): the accumulator holds rows
// g (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t + 1.  Two adjacent n8
// accumulator tiles c0 (columns 0-7) and c1 (8-15) are one k16 A fragment
// {c0[0]c0[1], c0[2]c0[3], c1[0]c1[1], c1[2]c1[3]}; split_frag gives it as
// hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_frag(const float c0[4], const float c1[4], uint32_t hi[4],
                                           uint32_t lo[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x[2 * r] - __low2float(h), x[2 * r + 1] - __high2float(h));
  }
}

// ldmatrix x4 row and column offsets of this lane (matrix lane >> 3, row
// lane & 7): an A fragment (16 rows x k16) or a B fragment read transposed
// (k16 rows x 16 columns) at (lm_row, lm_col); a B fragment pair read as
// rows (16 n rows x k16) at (lk_row, lk_col).
struct Lanes {
  int warp, g, t, lm_row, lm_col, lk_row, lk_col;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    g = lane >> 2;
    t = lane & 3;
    lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    lm_col = (lane >> 4) * 8;
    lk_row = (lane >> 4) * 8 + (lane & 7);
    lk_col = ((lane >> 3) & 1) * 8;
  }
};

// ---------------------------------------------------------------------------
// tensor-core bodies (bf16 inputs)
// ---------------------------------------------------------------------------

// Output columns of a tensor-core block: all of them up to head dim 128;
// above, two blocks each take half of the columns (and both compute the
// scores), so that a thread's f32 accumulators stay within 64 registers a
// term.
template <int DP>
constexpr int TC_CW = DP <= 128 ? DP : DP / 2;

// 2^x, flushing results below 2^-126 to 0 (one MUFU instruction)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Stores rows row0 and row0 + 8 of a 16 x 8 NC f32 accumulator tile, times
// mul0 and mul1, in T at columns c0 + 8 i + 2t; rows at or past n and column
// tiles at or past d are not stored.
template <int NC, typename T>
__device__ __forceinline__ void store_acc(T* out, const float acc[NC][4], int row0, int c0,
                                          int t, int n, int d, float mul0, float mul1) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = c0 + i * 8 + 2 * t;
    if (c0 + i * 8 >= d) continue;
    if (row0 < n) store2(out + (size_t)row0 * d + col, acc[i][0] * mul0, acc[i][1] * mul0);
    if (row0 + 8 < n)
      store2(out + (size_t)(row0 + 8) * d + col, acc[i][2] * mul1, acc[i][3] * mul1);
  }
}

// ---------------------------------------------------------------------------
// forward, tensor cores: one block per (bh, 64 MT queries, column part)
// ---------------------------------------------------------------------------

// Each warp owns MT m16 row tiles, so every K and V fragment read from shared
// memory feeds MT (K) or 2 MT (V) products.
template <int DP>
constexpr int TC_MT = DP <= 64 ? 2 : 1;

template <int DP>
__global__ void __launch_bounds__(NT_TC, 2)
fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int n, int d, int ntiles, float scale) {
  constexpr int MT = TC_MT<DP>;  // m16 row tiles per warp
  constexpr int TQ = 4 * 16 * MT;      // query rows per block
  constexpr int LD = DP + 8;   // row stride in shared memory (conflict-free ldmatrix)
  constexpr int KS = DP / 16;  // k16 steps of q.k^T
  constexpr int CW = TC_CW<DP>, NO = CW / 8, PARTS = DP / CW;  // n8 tiles of the output
  constexpr int TS = TILE * LD;
  constexpr bool QREG = DP <= 128;  // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* ks = qs + TQ * LD;  // 2 x [TILE][LD]
  __nv_bfloat16* vs = ks + 2 * TS;   // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / PARTS * TQ, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t;
  const int nkt = (n + TILE - 1) / TILE;

  for (int r = 0; r < TQ; r += TILE) load_tile_async<DP>(qs + r * LD, q + base, q0 + r, n, d);
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  uint32_t qf[MT][QREG ? KS : 1][4];
  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // rows g, g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {  // the next tile's copies fly while this one is used
      load_tile_async<DP>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TILE, n, d);
      load_tile_async<DP>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KS : 1); ++kk)
          ldsm_x4(qf[mt][kk], qs + ((warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
    }
    const __nv_bfloat16* kb = ks + buf * TS;
    const __nv_bfloat16* vb = vs + buf * TS;

    // s = q . k^T over this tile's 64 keys: 8 n8 tiles per m16 tile
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) qa[mt][r] = qf[mt][kk][r];
        } else {
          ldsm_x4(qa[mt], qs + ((warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + (np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
        }
      }
    }

    // scale, mask, online max and sum (f32)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = j * TILE + i * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][i][e] = (col + (e & 1) < n) ? s[mt][i][e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[mt][i][0], s[mt][i][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][i][2], s[mt][i][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // finite: the tile holds a key
      const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
      const float a0 = exp2f((m[mt][0] - mn0) * LOG2E), a1 = exp2f((m[mt][1] - mn1) * LOG2E);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[mt][i][0] = exp2f((s[mt][i][0] - mn0) * LOG2E);
        s[mt][i][1] = exp2f((s[mt][i][1] - mn0) * LOG2E);
        s[mt][i][2] = exp2f((s[mt][i][2] - mn1) * LOG2E);
        s[mt][i][3] = exp2f((s[mt][i][3] - mn1) * LOG2E);
        rs0 += s[mt][i][0] + s[mt][i][1];
        rs1 += s[mt][i][2] + s[mt][i][3];
      }
      l[mt][0] = l[mt][0] * a0 + rs0;  // this thread's columns; summed over the quad at the end
      l[mt][1] = l[mt][1] * a1 + rs1;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[mt][i][0] *= a0; acc[mt][i][1] *= a0;
        acc[mt][i][2] *= a1; acc[mt][i][3] *= a1;
      }
    }

    // acc += p . v, p split into bf16 hi + lo terms
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) split_frag(s[mt][2 * kk], s[mt][2 * kk + 1], hi[mt], lo[mt]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (kk * 16 + ln.lm_row) * LD + c0 + dp * 16 + ln.lm_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], hi[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp], lo[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], hi[mt], b[2], b[3]);
          mma_bf16(acc[mt][2 * dp + 1], lo[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int row0 = q0 + (warp * MT + mt) * 16 + g, row1 = row0 + 8;
    store_acc<NO>(o + base, acc[mt], row0, c0, t, n, d, 1.f / l0, 1.f / l1);
    if (t == 0 && c0 == 0) {
      if (row0 < n) lse[bh * n + row0] = m[mt][0] + logf(l0);
      if (row1 < n) lse[bh * n + row1] = m[mt][1] + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, tensor cores: one block per (bh, 64 MT queries, column part), 16 MT a
// warp
// ---------------------------------------------------------------------------

template <int DP>
constexpr int DQ_MT = DP <= 64 ? 2 : 1;

template <int DP>
__global__ void __launch_bounds__(NT_TC)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int n, int d, int ntiles, float scale) {
  constexpr int MT = DQ_MT<DP>, TQ = 64 * MT;
  constexpr int SC = 32 / MT;  // keys per score step: 16 x SC scores of s and dp per m16 tile
  constexpr int LD = DP + 8, KS = DP / 16, TS = TILE * LD;
  constexpr int CW = TC_CW<DP>, NC = CW / 8, PARTS = DP / CW;
  constexpr bool QREG = MT * DP <= 128;  // q and do fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* dos = qs + TQ * LD;  // [TQ][LD]
  __nv_bfloat16* ks = dos + TQ * LD;  // 2 x [TILE][LD]
  __nv_bfloat16* vs = ks + 2 * TS;    // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / PARTS * TQ, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nkt = (n + TILE - 1) / TILE;
  const float sl = scale * LOG2E;

  for (int r = 0; r < TQ; r += TILE) {
    load_tile_async<DP>(qs + r * LD, q + base, q0 + r, n, d);
    load_tile_async<DP>(dos + r * LD, dout + base, q0 + r, n, d);
  }
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  // rows g and g + 8 of each m16 tile: l * log2(e) and delta; rows past n
  // read row n - 1 and are never stored
  int row0[MT];
  float ll[MT][2], dl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    row0[mt] = q0 + (ln.warp * MT + mt) * 16 + ln.g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = bh * n + min(row0[mt] + 8 * h, n - 1);
      ll[mt][h] = lse[r] * LOG2E;
      dl[mt][h] = delta[r];
    }
  }
  uint32_t qf[MT][QREG ? KS : 1][4], df[MT][QREG ? KS : 1][4];
  float acc[MT][NC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {
      load_tile_async<DP>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TILE, n, d);
      load_tile_async<DP>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KS : 1); ++kk) {
          const int off = ((ln.warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col;
          ldsm_x4(qf[mt][kk], qs + off);
          ldsm_x4(df[mt][kk], dos + off);
        }
    }
    const __nv_bfloat16* kb = ks + buf * TS;
    const __nv_bfloat16* vb = vs + buf * TS;

#pragma unroll
    for (int kc = 0; kc < TILE; kc += SC) {
      // s = q . k^T and dp = do . v^T over SC keys: SC / 8 n8 tiles each
      float s[MT][SC / 8][4], dp[MT][SC / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] = dp[mt][i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[MT][4], da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (QREG) {
#pragma unroll
            for (int r = 0; r < 4; ++r) qa[mt][r] = qf[mt][kk][r], da[mt][r] = df[mt][kk][r];
          } else {
            const int off = ((ln.warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col;
            ldsm_x4(qa[mt], qs + off);
            ldsm_x4(da[mt], dos + off);
          }
        }
#pragma unroll
        for (int np = 0; np < SC / 16; ++np) {
          const int off = (kc + np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col;
          uint32_t b[4];
          ldsm_x4(b, kb + off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
          }
          ldsm_x4(b, vb + off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(dp[mt][2 * np], da[mt], b[0], b[1]);
            mma_bf16(dp[mt][2 * np + 1], da[mt], b[2], b[3]);
          }
        }
      }
      if (j * TILE + kc + SC > n) {  // keys at or past n: p = 0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < SC / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * TILE + kc + i * 8 + 2 * ln.t + (e & 1) >= n) s[mt][i][e] = -INFINITY;
      }
      // p = 2^(s * scale * log2(e) - l * log2(e)), ds = p * (dp - delta) in
      // place of s
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][i][e], sl, -ll[mt][e >> 1]));
            s[mt][i][e] = p * (dp[mt][i][e] - dl[mt][e >> 1]);
          }
      // acc += ds . k, ds split into bf16 hi + lo terms, k read transposed
#pragma unroll
      for (int kq = 0; kq < SC / 16; ++kq) {
        uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) split_frag(s[mt][2 * kq], s[mt][2 * kq + 1], hi[mt], lo[mt]);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          uint32_t b[4];
          ldsm_x4_trans(b, kb + (kc + kq * 16 + ln.lm_row) * LD + c0 + dc * 16 + ln.lm_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dc], hi[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * dc], lo[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * dc + 1], hi[mt], b[2], b[3]);
            mma_bf16(acc[mt][2 * dc + 1], lo[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_acc<NC>(dq + base, acc[mt], row0[mt], c0, ln.t, n, d, scale, scale);
}

// ---------------------------------------------------------------------------
// dK/dV, tensor cores: one block per (bh, 64 keys, column part), 16 a warp
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT_TC)
dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int d,
              int ntiles, float scale) {
  constexpr int SC = 32;  // queries per score step: 16 x SC scores of s^T and dp^T
  constexpr int LD = DP + 8, KS = DP / 16, TS = TILE * LD;
  constexpr int CW = TC_CW<DP>, NC = CW / 8, PARTS = DP / CW;
  constexpr bool KREG = DP <= 64;  // k and v fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TILE][LD]
  __nv_bfloat16* vs = ks + TS;       // [TILE][LD]
  __nv_bfloat16* qs = vs + TS;       // 2 x [TILE][LD]
  __nv_bfloat16* dos = qs + 2 * TS;  // 2 x [TILE][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * TS);  // 2 x [TILE] logsumexp of the query tile
  float* dls = ls + 2 * TILE;                          // 2 x [TILE] delta of the query tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile / PARTS * TILE, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nqt = (n + TILE - 1) / TILE;
  const int row0 = k0 + ln.warp * 16 + ln.g;  // this lane's keys row0 and row0 + 8
  const __nv_bfloat16* kw = ks + (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col;
  const __nv_bfloat16* vw = vs + (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col;
  const float sl = scale * LOG2E;

  load_tile_async<DP>(ks, k + base, k0, n, d);
  load_tile_async<DP>(vs, v + base, k0, n, d);
  load_tile_async<DP>(qs, q + base, 0, n, d);
  load_tile_async<DP>(dos, dout + base, 0, n, d);
  load_rows_async(ls, lse + bh * n, 0, n);
  load_rows_async(dls, delta + bh * n, 0, n);
  cp_async_commit();

  uint32_t kf[KREG ? KS : 1][4], vf[KREG ? KS : 1][4];
  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[i][e] = gv[i][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nqt) {
      const int r1 = (j + 1) * TILE;
      load_tile_async<DP>(qs + (buf ^ 1) * TS, q + base, r1, n, d);
      load_tile_async<DP>(dos + (buf ^ 1) * TS, dout + base, r1, n, d);
      load_rows_async(ls + (buf ^ 1) * TILE, lse + bh * n, r1, n);
      load_rows_async(dls + (buf ^ 1) * TILE, delta + bh * n, r1, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (KREG && j == 0) {
#pragma unroll
      for (int kk = 0; kk < (KREG ? KS : 1); ++kk) {
        ldsm_x4(kf[kk], kw + kk * 16);
        ldsm_x4(vf[kk], vw + kk * 16);
      }
    }
    const __nv_bfloat16* qb = qs + buf * TS;
    const __nv_bfloat16* db = dos + buf * TS;
    const float* lb = ls + buf * TILE;
    const float* dlb = dls + buf * TILE;

#pragma unroll
    for (int qc = 0; qc < TILE; qc += SC) {
      // s^T = k . q^T and dp^T = v . do^T over SC queries: SC / 8 n8 tiles each
      float s[SC / 8][4], dp[SC / 8][4];
#pragma unroll
      for (int i = 0; i < SC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) ka[r] = kf[kk][r], va[r] = vf[kk][r];
        } else {
          ldsm_x4(ka, kw + kk * 16);
          ldsm_x4(va, vw + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < SC / 16; ++np) {
          const int off = (qc + np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col;
          uint32_t b[4];
          ldsm_x4(b, qb + off);
          mma_bf16(s[2 * np], ka, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
          ldsm_x4(b, db + off);
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      if (k0 + TILE > n || j * TILE + qc + SC > n) {  // keys or queries at or past n: p = 0
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * TILE + qc + i * 8 + 2 * ln.t + (e & 1) >= n || row0 + (e >> 1) * 8 >= n)
              s[i][e] = -INFINITY;
      }
      // p^T = 2^(s^T * scale * log2(e) - l * log2(e)) in s, ds^T = p^T *
      // (dp^T - delta) in dp
#pragma unroll
      for (int i = 0; i < SC / 8; ++i) {
        const int col = qc + i * 8 + 2 * ln.t;  // query in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lb + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlb + col);
        const float ll0 = l2.x * LOG2E, ll1 = l2.y * LOG2E;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[i][e], sl, -(e & 1 ? ll1 : ll0)));
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dv += p^T . do and dk += ds^T . q, each split into bf16 hi + lo terms,
      // do and q read transposed
#pragma unroll
      for (int kq = 0; kq < SC / 16; ++kq) {
        uint32_t phi[4], plo[4], dhi[4], dlo[4];
        split_frag(s[2 * kq], s[2 * kq + 1], phi, plo);
        split_frag(dp[2 * kq], dp[2 * kq + 1], dhi, dlo);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          const int off = (qc + kq * 16 + ln.lm_row) * LD + c0 + dc * 16 + ln.lm_col;
          uint32_t b[4];
          ldsm_x4_trans(b, db + off);
          mma_bf16(gv[2 * dc], phi, b[0], b[1]);
          mma_bf16(gv[2 * dc], plo, b[0], b[1]);
          mma_bf16(gv[2 * dc + 1], phi, b[2], b[3]);
          mma_bf16(gv[2 * dc + 1], plo, b[2], b[3]);
          ldsm_x4_trans(b, qb + off);
          mma_bf16(gk[2 * dc], dhi, b[0], b[1]);
          mma_bf16(gk[2 * dc], dlo, b[0], b[1]);
          mma_bf16(gk[2 * dc + 1], dhi, b[2], b[3]);
          mma_bf16(gk[2 * dc + 1], dlo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
  store_acc<NC>(dk + base, gk, row0, c0, ln.t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, c0, ln.t, n, d, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// split-TF32 tensor-core building blocks (f32 inputs)
// ---------------------------------------------------------------------------

// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi), both
// rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, by
// adding half a TF32 unit to the bits (finite x; cvt.rna.tf32.f32 gives the
// same values but compiles to five instructions with its NaN and infinity
// cases).  An MMA reads the upper 19 bits of a .tf32 operand, so lo is left
// unmasked; hi is masked, for x - hi.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a (16x8 tf32, row) . b (8x8 tf32, col), f32 accumulation.  Fragment
// layout (PTX m16n8k8 .tf32; lane = 4 g + t): a0, a2 row g and a1, a3 row
// g + 8, at columns t (a0, a1) and t + 4 (a2, a3); b0 row t and b1 row t + 4
// of column g; the accumulator as in m16n8k16.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a . b, the same MMA from a zero accumulator
__device__ __forceinline__ void mma_tf32_from0(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Four 8x4 f32 blocks of a tile by one ldmatrix x4 (p: this lane's row, as
// Lanes' lm_* for an A fragment or lk_* for the B fragments of two n8
// tiles), each value times `scale` in f32 when SCALED, split into hi and lo
template <bool SCALED>
__device__ __forceinline__ void ld_split(uint32_t hi[4], uint32_t lo[4], const float* p,
                                         float scale) {
  uint32_t r[4];
  ldsm_x4(r, p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = __uint_as_float(r[e]);
    split_tf32(SCALED ? x * scale : x, hi[e], lo[e]);
  }
}

// The A fragment of an accumulator tile c (rows g, g + 8; columns 2t,
// 2t + 1) with k-slot t taking column 2t and k-slot t + 4 column 2t + 1:
// {c0, c2, c1, c3}, split.  Its B operand is read in the same order.
__device__ __forceinline__ void split_acc_as_a(const float c[4], uint32_t hi[4], uint32_t lo[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// part[c] += a . b_c in split TF32 over one k8 step, for CG n8 column tiles
// c whose B operands are rows 2t and 2t + 1 of an f32 tile (p: row 2t,
// column g of the first tile; ld: row stride), pass by pass over the CG
// accumulators so that an MMA does not wait on the one before it
template <int CG>
__device__ __forceinline__ void mma_split_rows(float part[CG][4], const uint32_t ah[4],
                                               const uint32_t al[4], const float* p, int ld) {
  uint32_t bh[CG][2], bl[CG][2];
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    split_tf32(p[8 * c], bh[c][0], bl[c][0]);
    split_tf32(p[8 * c + ld], bh[c][1], bl[c][1]);
  }
#pragma unroll
  for (int c = 0; c < CG; ++c) mma_tf32(part[c], al, bh[c][0], bh[c][1]);
#pragma unroll
  for (int c = 0; c < CG; ++c) mma_tf32(part[c], ah, bl[c][0], bl[c][1]);
#pragma unroll
  for (int c = 0; c < CG; ++c) mma_tf32(part[c], ah, bh[c][0], bh[c][1]);
}

// acc[0..CG) += a . b over NS k8 steps for CG n8 column tiles (see
// grad_step), their sums begun at 0 and added to acc in f32
template <int CG, int NS>
__device__ __forceinline__ void grad_group(float (*acc)[4], const uint32_t ah[NS][4],
                                           const uint32_t al[NS][4], const float* p, int ld) {
  float part[CG][4];
#pragma unroll
  for (int c = 0; c < CG; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) mma_split_rows<CG>(part, ah[i], al[i], p + 8 * i * ld, ld);
#pragma unroll
  for (int c = 0; c < CG; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
}

// acc += a . b over NS k8 steps (a: split A fragments; b: rows of an f32
// tile, p at row 2t and column g of the first step's first n8 tile), for
// NC n8 column tiles, four at a time (the last NC % 4 together); each
// tile's sum is begun at 0 and added to acc in f32
template <int NC, int NS>
__device__ __forceinline__ void grad_step(float acc[NC][4], const uint32_t ah[NS][4],
                                          const uint32_t al[NS][4], const float* p, int ld) {
  constexpr int NC4 = NC / 4 * 4;
#pragma unroll
  for (int c0 = 0; c0 < NC4; c0 += 4) grad_group<4, NS>(acc + c0, ah, al, p + 8 * c0, ld);
  if constexpr (NC % 4 != 0)
    grad_group<NC % 4, NS>(acc + NC4, ah, al, p + 8 * NC4, ld);
}

// s0, s1 += a . b (two n8 tiles: b[0..1], b[2..3]) and d0, d1 += a2 . b2 in
// split TF32 over one k8 step, pass by pass over the four products.  The
// scores' three MMAs go into fresh accumulators, which f32 adds (to
// nearest) then add to s0 and s1: a truncating MMA so biases a score by a
// share of its step's partial sum, not of the whole score three times a
// step (an error in s scales p through the exponential; one in dp stays
// relative to it).
__device__ __forceinline__ void mma_split_2x2(float s0[4], float s1[4], float d0[4], float d1[4],
                                              const uint32_t ah[4], const uint32_t al[4],
                                              const uint32_t bh[4], const uint32_t bl[4],
                                              const uint32_t a2h[4], const uint32_t a2l[4],
                                              const uint32_t b2h[4], const uint32_t b2l[4]) {
  float t0[4], t1[4];
  mma_tf32_from0(t0, al, bh[0], bh[1]);
  mma_tf32_from0(t1, al, bh[2], bh[3]);
  mma_tf32(d0, a2l, b2h[0], b2h[1]);
  mma_tf32(d1, a2l, b2h[2], b2h[3]);
  mma_tf32(t0, ah, bl[0], bl[1]);
  mma_tf32(t1, ah, bl[2], bl[3]);
  mma_tf32(d0, a2h, b2l[0], b2l[1]);
  mma_tf32(d1, a2h, b2l[2], b2l[3]);
  mma_tf32(t0, ah, bh[0], bh[1]);
  mma_tf32(t1, ah, bh[2], bh[3]);
  mma_tf32(d0, a2h, b2h[0], b2h[1]);
  mma_tf32(d1, a2h, b2h[2], b2h[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s0[e] += t0[e];
    s1[e] += t1[e];
  }
}

// ---------------------------------------------------------------------------
// dQ, tensor cores in split TF32 (f32 inputs): one block per (bh, 64
// queries), 16 a warp
// ---------------------------------------------------------------------------

// keys per score step (s and dp of 16 x SC a warp in registers)
template <int DP>
constexpr int DQ32_SC = DP <= 64 ? 64 : 32;

template <int DP>
__global__ void __launch_bounds__(NT_TC, 2)
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int n, int d, int ntiles, float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, NC = DP / 8, TS = TILE * LD;
  constexpr int SC = DQ32_SC<DP>, NS = SC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [TILE][LD], q unscaled
  float* dos = qs + TS;                            // [TILE][LD]
  float* ks = dos + TS;                            // 2 x [TILE][LD]
  float* vs = ks + 2 * TS;                         // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TILE;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nkt = (n + TILE - 1) / TILE;
  // this lane's ldmatrix rows (f32 columns: half the bf16 offsets)
  const int a_off = (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = ln.lk_row * LD + ln.lk_col / 2;

  load_tile_async<DP>(qs, q + base, q0, n, d);
  load_tile_async<DP>(dos, dout + base, q0, n, d);
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  // rows g and g + 8 of the warp's tile: l and delta; rows past n read row
  // n - 1 and are never stored
  const int row0 = q0 + ln.warp * 16 + ln.g;
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = bh * n + min(row0 + 8 * h, n - 1);
    lr[h] = lse[r];
    dl[h] = delta[r];
  }
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {
      load_tile_async<DP>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TILE, n, d);
      load_tile_async<DP>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kb = ks + buf * TS;
    const float* vb = vs + buf * TS;

#pragma unroll
    for (int kc = 0; kc < TILE; kc += SC) {
      // s = (q * scale) . k^T and dp = do . v^T over SC keys: NS n8 tiles each
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll 2  // fully unrolled, the hoisted loads outgrow the registers
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qh[4], ql[4], dh[4], dlo[4];
        ld_split<true>(qh, ql, qs + a_off + kk * 8, scale);
        ld_split<false>(dh, dlo, dos + a_off + kk * 8, 1.f);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int off = (kc + np * 16) * LD + b_off + kk * 8;
          uint32_t kh[4], kl[4], vh[4], vl[4];
          ld_split<false>(kh, kl, kb + off, 1.f);
          ld_split<false>(vh, vl, vb + off, 1.f);
          mma_split_2x2(s[2 * np], s[2 * np + 1], dp[2 * np], dp[2 * np + 1], qh, ql, kh, kl,
                        dh, dlo, vh, vl);
        }
      }
      if (j * TILE + kc + SC > n) {  // keys at or past n: p = 0
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * TILE + kc + i * 8 + 2 * ln.t + (e & 1) >= n) s[i][e] = -INFINITY;
      }
      // p = 2^((s - l) * log2(e)), ds = p * (dp - delta), as split A
      // fragments over the keys
      uint32_t ah[NS][4], al[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[i][e] = ex2((s[i][e] - lr[e >> 1]) * LOG2E) * (dp[i][e] - dl[e >> 1]);
        split_acc_as_a(s[i], ah[i], al[i]);
      }
      // acc += ds . k over these SC keys
      grad_step<NC, NS>(acc, ah, al, kb + (kc + 2 * ln.t) * LD + ln.g, LD);
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
  store_acc<NC>(dq + base, acc, row0, 0, ln.t, n, d, scale, scale);
}

// ---------------------------------------------------------------------------
// dK/dV, tensor cores in split TF32 (f32 inputs): one block per (bh, 64
// keys), 16 a warp
// ---------------------------------------------------------------------------

// queries per score step (s^T and dp^T of 16 x SC a warp in registers)
template <int DP>
constexpr int DKV32_SC = DP <= 64 ? 32 : 16;

template <int DP>
__global__ void __launch_bounds__(NT_TC, 2)
dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int n, int d, int ntiles,
                float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, NC = DP / 8, TS = TILE * LD;
  constexpr int SC = DKV32_SC<DP>, NS = SC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [TILE][LD]
  float* vs = ks + TS;                             // [TILE][LD]
  float* qs = vs + TS;                             // 2 x [TILE][LD], q unscaled
  float* dos = qs + 2 * TS;                        // 2 x [TILE][LD]
  float* ls = dos + 2 * TS;                        // 2 x [TILE] logsumexp of the query tile
  float* dls = ls + 2 * TILE;                      // 2 x [TILE] delta of the query tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile * TILE;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nqt = (n + TILE - 1) / TILE;
  const int row0 = k0 + ln.warp * 16 + ln.g;  // this lane's keys row0 and row0 + 8
  const int a_off = (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = ln.lk_row * LD + ln.lk_col / 2;

  load_tile_async<DP>(ks, k + base, k0, n, d);
  load_tile_async<DP>(vs, v + base, k0, n, d);
  load_tile_async<DP>(qs, q + base, 0, n, d);
  load_tile_async<DP>(dos, dout + base, 0, n, d);
  load_rows_async(ls, lse + bh * n, 0, n);
  load_rows_async(dls, delta + bh * n, 0, n);
  cp_async_commit();

  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nqt) {
      const int r1 = (j + 1) * TILE;
      load_tile_async<DP>(qs + (buf ^ 1) * TS, q + base, r1, n, d);
      load_tile_async<DP>(dos + (buf ^ 1) * TS, dout + base, r1, n, d);
      load_rows_async(ls + (buf ^ 1) * TILE, lse + bh * n, r1, n);
      load_rows_async(dls + (buf ^ 1) * TILE, delta + bh * n, r1, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qb = qs + buf * TS;
    const float* db = dos + buf * TS;
    const float* lb = ls + buf * TILE;
    const float* dlb = dls + buf * TILE;

#pragma unroll
    for (int qc = 0; qc < TILE; qc += SC) {
      // s^T = k . (q * scale)^T and dp^T = v . do^T over SC queries
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll 2  // fully unrolled, the hoisted loads outgrow the registers
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        ld_split<false>(kh, kl, ks + a_off + kk * 8, 1.f);
        ld_split<false>(vh, vl, vs + a_off + kk * 8, 1.f);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int off = (qc + np * 16) * LD + b_off + kk * 8;
          uint32_t qh[4], ql[4], doh[4], dol[4];
          ld_split<true>(qh, ql, qb + off, scale);
          ld_split<false>(doh, dol, db + off, 1.f);
          mma_split_2x2(s[2 * np], s[2 * np + 1], dp[2 * np], dp[2 * np + 1], kh, kl, qh, ql,
                        vh, vl, doh, dol);
        }
      }
      if (k0 + TILE > n || j * TILE + qc + SC > n) {  // keys or queries at or past n: p = 0
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * TILE + qc + i * 8 + 2 * ln.t + (e & 1) >= n || row0 + (e >> 1) * 8 >= n)
              s[i][e] = -INFINITY;
      }
      // p^T = 2^((s^T - l) * log2(e)) and ds^T = p^T * (dp^T -
      // delta); then dv += p^T . do over these SC queries, and after it dk +=
      // ds^T . q, each from split A fragments over the queries (one set
      // live at a time)
      uint32_t ah[NS][4], al[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = qc + i * 8 + 2 * ln.t;  // query in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lb + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlb + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((s[i][e] - (e & 1 ? l2.y : l2.x)) * LOG2E);
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - (e & 1 ? d2.y : d2.x));
        }
        split_acc_as_a(s[i], ah[i], al[i]);
      }
      grad_step<NC, NS>(gv, ah, al, db + (qc + 2 * ln.t) * LD + ln.g, LD);
#pragma unroll
      for (int i = 0; i < NS; ++i) split_acc_as_a(dp[i], ah[i], al[i]);
      grad_step<NC, NS>(gk, ah, al, qb + (qc + 2 * ln.t) * LD + ln.g, LD);
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
  store_acc<NC>(dk + base, gk, row0, 0, ln.t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, 0, ln.t, n, d, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// forward, tensor cores in split TF32 (f32 inputs): one block per (bh, 64
// queries), 16 a warp, over K/V tiles of FWD32_TK keys
// ---------------------------------------------------------------------------

// keys a K/V tile, and a p.v step (its sums begin at 0): with 32 the block
// holds 52 KB of shared memory at head dim 64 and 160 registers a thread,
// so three blocks share an SM
constexpr int FWD32_TK = 32;

// s (NK keys) += a . k^T over one k8 step in split TF32 (kp: this lane's
// ldmatrix row of the step in the K tile), each n8 tile's three MMAs into a
// fresh accumulator that an f32 add then adds to s
template <int LD, int NK = FWD32_TK>
__device__ __forceinline__ void score_step(float s[NK / 8][4], const uint32_t ah[4],
                                           const uint32_t al[4], const float* kp) {
#pragma unroll
  for (int np = 0; np < NK / 16; ++np) {
    uint32_t kh[4], kl[4];
    ld_split<false>(kh, kl, kp + np * 16 * LD, 1.f);
    float t0[4], t1[4];
    mma_tf32_from0(t0, al, kh[0], kh[1]);
    mma_tf32_from0(t1, al, kh[2], kh[3]);
    mma_tf32(t0, ah, kl[0], kl[1]);
    mma_tf32(t1, ah, kl[2], kl[3]);
    mma_tf32(t0, ah, kh[0], kh[1]);
    mma_tf32(t1, ah, kh[2], kh[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[2 * np][e] += t0[e];
      s[2 * np + 1][e] += t1[e];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT_TC, 3)
fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                int n, int d, int ntiles, float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, NC = DP / 8, TK = FWD32_TK, TS = TK * LD;
  constexpr int NT8 = TK / 8;  // n8 tiles of the scores, k8 steps of p.v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [TILE][LD], q unscaled
  float* ks = qs + TILE * LD;                      // 2 x [TK][LD]
  float* vs = ks + 2 * TS;                         // 2 x [TK][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TILE;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nkt = (n + TK - 1) / TK;
  const int a_off = (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = ln.lk_row * LD + ln.lk_col / 2;

  load_tile_async<DP>(qs, q + base, q0, n, d);
  load_tile_async<DP, TK>(ks, k + base, 0, n, d);
  load_tile_async<DP, TK>(vs, v + base, 0, n, d);
  cp_async_commit();

  float acc[NC][4];
  // rows g and g + 8 of the warp's tile: running max, and the running sum
  // over this thread's columns (summed over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {  // the next tile's copies fly while this one is used
      load_tile_async<DP, TK>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TK, n, d);
      load_tile_async<DP, TK>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TK, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kb = ks + buf * TS;
    const float* vb = vs + buf * TS;

    // s = (q * scale) . k^T over this tile's keys
    float s[NT8][4];
#pragma unroll
    for (int i = 0; i < NT8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      ld_split<true>(ah, al, qs + a_off + kk * 8, scale);
      score_step<LD>(s, ah, al, kb + b_off + kk * 8);
    }
    if (j * TK + TK > n) {  // keys at or past n: p = 0
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * TK + i * 8 + 2 * ln.t + (e & 1) >= n) s[i][e] = -INFINITY;
    }

    // online max and sum (f32): p = 2^((s - m_new) * log2(e)), s - m_new in
    // f32 first; the running output is rescaled by alpha
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // finite: the tile holds a key
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = ex2((m[0] - mn0) * LOG2E), a1 = ex2((m[1] - mn1) * LOG2E);
    m[0] = mn0;
    m[1] = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      s[i][0] = ex2((s[i][0] - mn0) * LOG2E);
      s[i][1] = ex2((s[i][1] - mn0) * LOG2E);
      s[i][2] = ex2((s[i][2] - mn1) * LOG2E);
      s[i][3] = ex2((s[i][3] - mn1) * LOG2E);
      rs0 += s[i][0] + s[i][1];
      rs1 += s[i][2] + s[i][3];
    }
    l[0] = l[0] * a0 + rs0;
    l[1] = l[1] * a1 + rs1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] *= a0;
      acc[c][1] *= a0;
      acc[c][2] *= a1;
      acc[c][3] *= a1;
    }

    // acc += p . v from split A fragments of p (the accumulator fragment,
    // contraction index permuted), the tile's sums begun at 0 and added to
    // acc in f32
    uint32_t ph[NT8][4], pl[NT8][4];
#pragma unroll
    for (int i = 0; i < NT8; ++i) split_acc_as_a(s[i], ph[i], pl[i]);
    grad_step<NC, NT8>(acc, ph, pl, vb + 2 * ln.t * LD + ln.g, LD);
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + ln.warp * 16 + ln.g;
  store_acc<NC>(o + base, acc, row0, 0, ln.t, n, d, 1.f / l0, 1.f / l1);
  if (ln.t == 0) {
    if (row0 < n) lse[bh * n + row0] = m[0] + logf(l0);
    if (row0 + 8 < n) lse[bh * n + row0 + 8] = m[1] + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// head dims 264-1024, forward, dK/dV and dQ: thread-block clusters that share
// the scores (f32 in split TF32, bf16 raw; see the note at the top)
// ---------------------------------------------------------------------------

constexpr int WO = 128;                 // output columns of a cluster rank or a column group
constexpr int CL_MAX = 8;               // ranks of a cluster at most (the portable size)
constexpr int CL_MAX_D = CL_MAX * WO;   // the largest head dim of the cluster bodies
constexpr int CL_ROWS = 64;             // own rows (queries or keys) of a cluster
constexpr int XP = 8;                   // padding of an exchange row: conflict-free float2 stores
constexpr int NT_WKV = 256;             // threads of a dK/dV block: 8 warps
constexpr int WKV_TQ = 32;              // queries of a dK/dV Q/dO tile

// row stride of a staged column slice: 16 bytes of padding (conflict-free ldmatrix)
template <typename T>
constexpr int CL_LD = WO + 16 / (int)sizeof(T);
// keys of a forward K/V tile: 64 bf16 (as fwd_tc_kernel), 32 f32 (as fwd_tf32_kernel)
template <typename T>
constexpr int WF_TK = sizeof(T) == 2 ? 32 : FWD32_TK;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The exchange of a cluster of P ranks, between two cluster barriers: rank r
// takes rows [r R, r R + R) (R = ceil(CL_ROWS / P)) of the NA [CL_ROWS][LX]
// tiles xs, adds the P ranks' partials of each value in rank order 0..P-1
// (NL ranks' loads in flight at a time, all of them with NL = CL_MAX; every
// rank's, its own too, through its cluster address: a local path for its
// own was slower on the card), hands the sums to f(sum, row, col) (col: the
// first of four columns; f may replace them by what it computes from them)
// and stores the first NO results into the same place of the first NO tiles
// ys of every rank (ys may be xs: only rank r touches these rows of any
// rank).  Each value is added once a cluster, in one fixed order, so every
// rank holds the same bits and a second launch gives them again.
template <int NA, int LX, int NTH, int NL, int NO = NA, typename F>
__device__ __forceinline__ void cluster_exchange(int P, int rank, float* xs, float* ys, F f) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C4 = (LX - XP) / 4, XS = CL_ROWS * LX;
  const int R = (CL_ROWS + P - 1) / P, r0 = rank * R, rows = min(CL_ROWS - r0, R);
  auto at = [&](float* base, int q) { return cluster.map_shared_rank(base, q); };
  for (int i = threadIdx.x; i < rows * C4; i += NTH) {
    const int row = r0 + i / C4, col = (i % C4) * 4, off = row * LX + col;
    float4 sum[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int q0 = 0; q0 < CL_MAX; q0 += NL) {
        if (q0 >= P) break;
        float4 x[NL];
#pragma unroll
        for (int u = 0; u < NL; ++u)
          if (q0 + u < P) x[u] = *reinterpret_cast<const float4*>(at(xs + a * XS + off, q0 + u));
#pragma unroll
        for (int u = 0; u < NL; ++u) {
          if (q0 + u >= P) break;
          if (q0 + u == 0)
            sum[a] = x[u];
          else
            add4(sum[a], x[u]);
        }
      }
    }
    f(sum, row, col);
#pragma unroll
    for (int q = 0; q < CL_MAX; ++q)
      if (q < P)
#pragma unroll
        for (int a = 0; a < NO; ++a)
          *reinterpret_cast<float4*>(at(ys + a * XS + off, q)) = sum[a];
  }
}

// The bf16 A fragment (16 rows x k16) of an f32 [rows][LX] tile at p (this
// lane's row g, column 2t), split into hi + lo (split_frag)
template <int LX>
__device__ __forceinline__ void p_frag(const float* p, uint32_t hi[4], uint32_t lo[4]) {
  const float2 a0 = *reinterpret_cast<const float2*>(p);
  const float2 a1 = *reinterpret_cast<const float2*>(p + 8 * LX);
  const float2 b0 = *reinterpret_cast<const float2*>(p + 8);
  const float2 b1 = *reinterpret_cast<const float2*>(p + 8 * LX + 8);
  const float c0[4] = {a0.x, a0.y, a1.x, a1.y}, c1[4] = {b0.x, b0.y, b1.x, b1.y};
  split_frag(c0, c1, hi, lo);
}

// The two halves of a cluster barrier (barrier.cluster): the arrive
// releases this thread's writes, the wait acquires every rank's, so work
// between the two overlaps the other ranks' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// forward: a cluster of P = ceil(d / 128) blocks per (bh, 64 queries); rank
// r stages columns [128 r, 128 r + 128) of q, k and v, takes its partial
// scores over them, the cluster adds the P partials (cluster_exchange, in
// place: the sums overwrite the partials), and each rank runs the same
// online softmax on the same scores and p.v over its own 128 output
// columns.  4 warps, 16 queries each; K/V tiles of WF_TK keys; bf16 three
// blocks an SM (168 registers), so that every cluster of (4, 1280, 512) is
// resident at once, f32 two.  One cluster barrier a tile, with work on both
// sides of it: tile j's exchange, tile j + 1's partials (into the other
// partial buffer) while the exchange's stores land, the arrive, tile j - 1's
// p.v (p held in registers) while the other ranks arrive, the wait (tile j's
// scores and tile j + 1's partials are everywhere), tile j's softmax.
template <typename T>
__global__ void __launch_bounds__(NT_TC, sizeof(T) == 2 ? 3 : 2)
fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int n, int d, int ntiles,
                float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = CL_LD<T>, TK = WF_TK<T>, NT8 = TK / 8, LX = TK + XP, NO = WO / 8;
  constexpr int TS = TK * LD, XS = CL_ROWS * LX;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [CL_ROWS][LD]: the rank's columns of q, unscaled
  T* ks = qs + CL_ROWS * LD;               // 2 x [TK][LD]: of k
  T* vs = ks + 2 * TS;                     // [TK][LD]: of v
  float* xs = reinterpret_cast<float*>(vs + TS);  // 2 x [CL_ROWS][LX]: partial, then summed scores
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / P * CL_ROWS, c0 = rank * WO;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t;
  const int nkt = (n + TK - 1) / TK;

  // copy groups in order: q and K_0, K_1; then in tile j's step K_{j+2}
  // (after tile j + 1's partials wait for K_{j+1}) and V_j (after tile
  // j - 1's p.v), so that K_{j+1} and V_{j-1} are the oldest two pending
  load_tile_async<WO, CL_ROWS, NT_TC>(qs, q + base, q0, n, d, c0);
  load_tile_async<WO, TK, NT_TC>(ks, k + base, 0, n, d, c0);
  cp_async_commit();
  if (nkt > 1) {
    load_tile_async<WO, TK, NT_TC>(ks + TS, k + base, TK, n, d, c0);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // this rank's partial scores of K tile jt over its 128 columns into
  // partial buffer jt % 2: bf16 q.k^T raw, f32 (q * scale).k^T in split TF32
  // (each k8 step's passes into fresh accumulators added in f32)
  auto partial = [&](int jt) {
    const T* kb = ks + (jt & 1) * TS;
    float s[NT8][4];
#pragma unroll
    for (int i = 0; i < NT8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < WO / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kb + (np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    } else {
      const int a_off = (warp * 16 + ln.lm_row) * LD + ln.lm_col / 2;
      const int b_off = ln.lk_row * LD + ln.lk_col / 2;
#pragma unroll 2
      for (int kk = 0; kk < WO / 8; ++kk) {
        uint32_t ah[4], al[4];
        ld_split<true>(ah, al, qs + a_off + kk * 8, scale);
        score_step<LD>(s, ah, al, kb + b_off + kk * 8);
      }
    }
    float* xr = xs + (jt & 1) * XS + (warp * 16 + g) * LX + 2 * t;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      store2(xr + 8 * i, s[i][0], s[i][1]);
      store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
    }
  };

  float acc[NO][4];
  float p[NT8][4];  // the last tile's p, until its p.v
  // rows g and g + 8 of the warp's tile: running max, and the running sum
  // over this thread's columns (summed over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // acc += p . v over the rank's columns: bf16 p split into hi + lo, v read
  // transposed; f32 split TF32, the tile's sums begun at 0 and added to acc
  // in f32
  auto pv = [&]() {
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_frag(p[2 * kk], p[2 * kk + 1], hi, lo);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, reinterpret_cast<const __nv_bfloat16*>(vs) +
                               (kk * 16 + ln.lm_row) * LD + dp * 16 + ln.lm_col);
          mma_bf16(acc[2 * dp], hi, b[0], b[1]);
          mma_bf16(acc[2 * dp], lo, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    } else {
      uint32_t ph[NT8][4], pl[NT8][4];
#pragma unroll
      for (int i = 0; i < NT8; ++i) split_acc_as_a(p[i], ph[i], pl[i]);
      grad_step<NO, NT8>(acc, ph, pl, reinterpret_cast<const float*>(vs) + 2 * t * LD + g, LD);
    }
  };

  partial(0);
  cluster_arrive();
  cluster_wait();  // every rank's partials of tile 0 are written
  for (int j = 0; j < nkt; ++j) {
    float* xj = xs + (j & 1) * XS;
    cluster_exchange<1, LX, NT_TC, BF ? 4 : CL_MAX>(P, rank, xj, xj, [](float4*, int, int) {});
    bool k_next = false;  // K_{j+2} issued
    if (j + 1 < nkt) {
      if (j == 0)
        cp_async_wait<0>();  // K_1
      else
        cp_async_wait<1>();  // K_{j+1}
      __syncthreads();
      partial(j + 1);
      if (j + 2 < nkt) {  // into the buffer of K_j, which no warp reads any more
        load_tile_async<WO, TK, NT_TC>(ks + (j & 1) * TS, k + base, (j + 2) * TK, n, d, c0);
        cp_async_commit();
        k_next = true;
      }
    }
    cluster_arrive();
    if (j > 0) {  // tile j - 1's p.v while the other ranks arrive
      if (k_next)
        cp_async_wait<1>();  // V_{j-1}
      else
        cp_async_wait<0>();
      __syncthreads();
      pv();
      __syncthreads();  // every warp is done with V_{j-1}
    }
    load_tile_async<WO, TK, NT_TC>(vs, v + base, j * TK, n, d, c0);
    cp_async_commit();
    cluster_wait();  // tile j's scores and tile j + 1's partials are everywhere

    const float* sr = xj + (warp * 16 + g) * LX + 2 * t;
    const float mul = BF ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(sr + 8 * i);
      const float2 b = *reinterpret_cast<const float2*>(sr + 8 * LX + 8 * i);
      p[i][0] = a.x * mul;
      p[i][1] = a.y * mul;
      p[i][2] = b.x * mul;
      p[i][3] = b.y * mul;
    }
    if (j * TK + TK > n) {  // keys at or past n: p = 0
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * TK + i * 8 + 2 * t + (e & 1) >= n) p[i][e] = -INFINITY;
    }

    // online max and sum (f32), as fwd_tf32_kernel: p = 2^((s - m_new) *
    // log2(e)), the running output rescaled by alpha
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(p[i][0], p[i][1]));
      mx1 = fmaxf(mx1, fmaxf(p[i][2], p[i][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // finite: the tile holds a key
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = ex2((m[0] - mn0) * LOG2E), a1 = ex2((m[1] - mn1) * LOG2E);
    m[0] = mn0;
    m[1] = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      p[i][0] = ex2((p[i][0] - mn0) * LOG2E);
      p[i][1] = ex2((p[i][1] - mn0) * LOG2E);
      p[i][2] = ex2((p[i][2] - mn1) * LOG2E);
      p[i][3] = ex2((p[i][3] - mn1) * LOG2E);
      rs0 += p[i][0] + p[i][1];
      rs1 += p[i][2] + p[i][3];
    }
    l[0] = l[0] * a0 + rs0;
    l[1] = l[1] * a1 + rs1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= a0;
      acc[c][1] *= a0;
      acc[c][2] *= a1;
      acc[c][3] *= a1;
    }
  }
  cp_async_wait<0>();  // V of the last tile
  __syncthreads();
  pv();

  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + warp * 16 + g;
  store_acc<NO>(o + base, acc, row0, c0, t, n, d, 1.f / l0, 1.f / l1);
  if (rank == 0 && t == 0) {
    if (row0 < n) lse[bh * n + row0] = m[0] + logf(l0);
    if (row0 + 8 < n) lse[bh * n + row0 + 8] = m[1] + logf(l1);
  }
}

// dK/dV: a cluster of P = ceil(d / 128) blocks per (bh, 64 keys); rank r
// holds columns [128 r, 128 r + 128) of k and v and stages those of q and do
// over Q/dO tiles of WKV_TQ queries, double-buffered.  Per tile: the partial
// s^T and dp^T over the rank's columns (warp w: keys 16 (w % 4), queries 16
// (w / 4)); the cluster adds them, and the rank that adds a value also forms
// p^T and ds^T from it in place of the partials (cluster_exchange), so that
// each exponential is taken once a cluster; then dv += p^T.do and dk +=
// ds^T.q over the rank's columns (warp w: keys 16 (w % 4), columns 64
// (w / 4)).  8 warps.  One cluster barrier a tile, as in the forward: tile
// j + 1's partials are taken while tile j's exchange lands.
template <typename T>
__global__ void __launch_bounds__(NT_WKV, 1)
dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int n,
                int d, int ntiles, float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = CL_LD<T>, TQ = WKV_TQ, LX = TQ + XP, XS = CL_ROWS * LX;
  constexpr int NC = WO / 16;  // n8 tiles of a warp's 64 output columns
  constexpr int TS = TQ * LD;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [CL_ROWS][LD]: the rank's columns of k
  T* vs = ks + CL_ROWS * LD;               // [CL_ROWS][LD]: of v
  T* qs = vs + CL_ROWS * LD;               // 2 x [TQ][LD]: of q, unscaled
  T* dos = qs + 2 * TS;                    // 2 x [TQ][LD]: of do
  // 2 x {s^T, dp^T} partials, then {p^T, ds^T} [CL_ROWS][LX]
  float* xs = reinterpret_cast<float*>(dos + 2 * TS);
  float* ls = xs + 4 * XS;                             // 2 x [TQ] logsumexp of the Q tile
  float* dls = ls + 2 * TQ;                            // 2 x [TQ] delta of the Q tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile / P * CL_ROWS, c0 = rank * WO;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int kg = ln.warp & 3, half = ln.warp >> 2, g = ln.g, t = ln.t;
  const int nqt = (n + TQ - 1) / TQ;
  const float sl = scale * LOG2E;

  // copy groups in order: k, v and Q/dO tile 0, tile 1; then tile j + 2
  // after tile j's gradients
  auto load_q_tile = [&](int jt) {
    const int b = jt & 1, r = jt * TQ;
    load_tile_async<WO, TQ, NT_WKV>(qs + b * TS, q + base, r, n, d, c0);
    load_tile_async<WO, TQ, NT_WKV>(dos + b * TS, dout + base, r, n, d, c0);
    load_rows_async<TQ>(ls + b * TQ, lse + bh * n, r, n);
    load_rows_async<TQ>(dls + b * TQ, delta + bh * n, r, n);
    cp_async_commit();
  };
  load_tile_async<WO, CL_ROWS, NT_WKV>(ks, k + base, k0, n, d, c0);
  load_tile_async<WO, CL_ROWS, NT_WKV>(vs, v + base, k0, n, d, c0);
  load_q_tile(0);
  if (nqt > 1) {
    load_q_tile(1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // 1. this rank's partial s^T (bf16 k.q^T raw, f32 k.(q * scale)^T in
  // split TF32, each k8 step's passes into fresh accumulators) and dp^T =
  // v.do^T of Q tile jt over its 128 columns, 16 keys x 16 queries a warp,
  // into partial buffer jt % 2
  auto partial = [&](int jt) {
    const T* qb = qs + (jt & 1) * TS;
    const T* db = dos + (jt & 1) * TS;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    if constexpr (BF) {
      const T* ka = ks + (kg * 16 + ln.lm_row) * LD + ln.lm_col;
      const T* va = vs + (kg * 16 + ln.lm_row) * LD + ln.lm_col;
      const int b_off = (half * 16 + ln.lk_row) * LD + ln.lk_col;
#pragma unroll
      for (int kk = 0; kk < WO / 16; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4(a, ka + kk * 16);
        ldsm_x4(b, qb + b_off + kk * 16);
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
        ldsm_x4(a, va + kk * 16);
        ldsm_x4(b, db + b_off + kk * 16);
        mma_bf16(dp[0], a, b[0], b[1]);
        mma_bf16(dp[1], a, b[2], b[3]);
      }
    } else {
      const int a_off = (kg * 16 + ln.lm_row) * LD + ln.lm_col / 2;
      const int b_off = (half * 16 + ln.lk_row) * LD + ln.lk_col / 2;
#pragma unroll 2
      for (int kk = 0; kk < WO / 8; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4], qh[4], ql[4], doh[4], dol[4];
        ld_split<false>(kh, kl, ks + a_off + kk * 8, 1.f);
        ld_split<false>(vh, vl, vs + a_off + kk * 8, 1.f);
        ld_split<true>(qh, ql, qb + b_off + kk * 8, scale);
        ld_split<false>(doh, dol, db + b_off + kk * 8, 1.f);
        mma_split_2x2(s[0], s[1], dp[0], dp[1], kh, kl, qh, ql, vh, vl, doh, dol);
      }
    }
    float* xr = xs + (jt & 1) * 2 * XS + (kg * 16 + g) * LX + half * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      store2(xr + 8 * i, s[i][0], s[i][1]);
      store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
      store2(xr + XS + 8 * i, dp[i][0], dp[i][1]);
      store2(xr + XS + 8 * LX + 8 * i, dp[i][2], dp[i][3]);
    }
  };

  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;

  partial(0);
  cluster_arrive();
  cluster_wait();  // every rank's partials of tile 0 are written
  for (int j = 0; j < nqt; ++j) {
    const int buf = j & 1;
    const T* qb = qs + buf * TS;
    const T* db = dos + buf * TS;
    const float* lb = ls + buf * TQ;
    const float* dlb = dls + buf * TQ;
    float* pb = xs + buf * 2 * XS;

    // 2. the cluster's s^T and dp^T, and from them p^T = exp(s^T - l) and
    // ds^T = p^T (dp^T - delta) (0 for keys or queries at or past n), to
    // every rank
    cluster_exchange<2, LX, NT_WKV, CL_MAX>(P, rank, pb, pb, [&](float4* x, int row, int col) {
      const bool key_ok = k0 + row < n;
      float sv[4] = {x[0].x, x[0].y, x[0].z, x[0].w}, dv4[4] = {x[1].x, x[1].y, x[1].z, x[1].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = col + e;
        const bool ok = key_ok && j * TQ + qi < n;
        const float p = !ok ? 0.f
                        : BF ? ex2(fmaf(sv[e], sl, -lb[qi] * LOG2E))
                             : ex2((sv[e] - lb[qi]) * LOG2E);
        sv[e] = p;
        dv4[e] = p * (dv4[e] - dlb[qi]);
      }
      x[0] = make_float4(sv[0], sv[1], sv[2], sv[3]);
      x[1] = make_float4(dv4[0], dv4[1], dv4[2], dv4[3]);
    });
    if (j + 1 < nqt) {  // the next tile's partials while the exchange lands
      cp_async_wait<0>();
      __syncthreads();
      partial(j + 1);
    }
    cluster_arrive();
    cluster_wait();  // tile j's p^T and ds^T and tile j + 1's partials are everywhere

    // 3. dv += p^T . do and dk += ds^T . q over the warp's 64 columns
    const float* pr = pb + (kg * 16 + g) * LX + 2 * t;
    if constexpr (BF) {
#pragma unroll
      for (int kq = 0; kq < TQ / 16; ++kq) {
        uint32_t phi[4], plo[4], dhi[4], dlo[4];
        p_frag<LX>(pr + kq * 16, phi, plo);
        p_frag<LX>(pr + XS + kq * 16, dhi, dlo);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          const int off = (kq * 16 + ln.lm_row) * LD + half * 64 + dc * 16 + ln.lm_col;
          uint32_t b[4];
          ldsm_x4_trans(b, reinterpret_cast<const __nv_bfloat16*>(db) + off);
          mma_bf16(gv[2 * dc], phi, b[0], b[1]);
          mma_bf16(gv[2 * dc], plo, b[0], b[1]);
          mma_bf16(gv[2 * dc + 1], phi, b[2], b[3]);
          mma_bf16(gv[2 * dc + 1], plo, b[2], b[3]);
          ldsm_x4_trans(b, reinterpret_cast<const __nv_bfloat16*>(qb) + off);
          mma_bf16(gk[2 * dc], dhi, b[0], b[1]);
          mma_bf16(gk[2 * dc], dlo, b[0], b[1]);
          mma_bf16(gk[2 * dc + 1], dhi, b[2], b[3]);
          mma_bf16(gk[2 * dc + 1], dlo, b[2], b[3]);
        }
      }
    } else {
      constexpr int NS = TQ / 8;
      uint32_t ah[NS][4], al[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(pr + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
        const float c[4] = {a.x, a.y, b.x, b.y};
        split_acc_as_a(c, ah[i], al[i]);
      }
      const int b_off = 2 * t * LD + half * 64 + g;
      grad_step<NC, NS>(gv, ah, al, reinterpret_cast<const float*>(db) + b_off, LD);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(pr + XS + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(pr + XS + 8 * LX + 8 * i);
        const float c[4] = {a.x, a.y, b.x, b.y};
        split_acc_as_a(c, ah[i], al[i]);
      }
      grad_step<NC, NS>(gk, ah, al, reinterpret_cast<const float*>(qb) + b_off, LD);
    }
    __syncthreads();  // tile j's buffers are free
    if (j + 2 < nqt) load_q_tile(j + 2);
  }
  const int row0 = k0 + kg * 16 + g;  // this lane's keys row0 and row0 + 8
  store_acc<NC>(dk + base, gk, row0, c0 + half * 64, t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, c0 + half * 64, t, n, d, 1.f, 1.f);
}

// dQ: a cluster of P = ceil(d / 128) blocks per (bh, 64 queries), dK/dV's
// design with the panels' roles swapped; rank r holds columns [128 r,
// 128 r + 128) of q and do and stages those of k and v over K/V tiles of
// WDQ_TK keys, double-buffered.  Per tile: the partial s and dp over the
// rank's columns (warp w: queries 16 (w % 4), keys 16 (w / 4)); the cluster
// adds them, and the rank that adds a value also forms ds from it and writes
// only ds back (cluster_exchange with one output: dQ has no use for p), so
// that each exponential is taken once a cluster; then dq += ds.k over the
// rank's columns, its k slice serving both products (warp w: queries 16
// (w % 4), columns 64 (w / 4)).  8 warps, one accumulator set (32 f32 a
// thread), so bf16 fits two blocks an SM.  One cluster barrier a tile, as in
// dK/dV: tile j + 1's partials are taken while tile j's exchange lands.
constexpr int WDQ_TK = 32;  // keys of a dQ K/V tile

template <typename T>
__global__ void __launch_bounds__(NT_WKV, sizeof(T) == 2 ? 2 : 1)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int n, int d, int ntiles,
               float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = CL_LD<T>, TK = WDQ_TK, LX = TK + XP, XS = CL_ROWS * LX;
  constexpr int NC = WO / 16;  // n8 tiles of a warp's 64 output columns
  constexpr int TS = TK * LD;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [CL_ROWS][LD]: the rank's columns of q, unscaled
  T* dos = qs + CL_ROWS * LD;              // [CL_ROWS][LD]: of do
  T* ks = dos + CL_ROWS * LD;              // 2 x [TK][LD]: of k
  T* vs = ks + 2 * TS;                     // 2 x [TK][LD]: of v
  // 2 x {s, dp} partials [CL_ROWS][LX], then ds in place of s
  float* xs = reinterpret_cast<float*>(vs + 2 * TS);
  float* ls = xs + 4 * XS;    // [CL_ROWS] logsumexp of the block's queries
  float* dls = ls + CL_ROWS;  // [CL_ROWS] delta of the block's queries
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / P * CL_ROWS, c0 = rank * WO;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int qg = ln.warp & 3, half = ln.warp >> 2, g = ln.g, t = ln.t;
  const int nkt = (n + TK - 1) / TK;
  const float sl = scale * LOG2E;

  // copy groups in order: q, do, l, delta and K/V tile 0, tile 1; then tile
  // j + 2 after tile j's ds.k
  auto load_kv_tile = [&](int jt) {
    const int b = jt & 1, r = jt * TK;
    load_tile_async<WO, TK, NT_WKV>(ks + b * TS, k + base, r, n, d, c0);
    load_tile_async<WO, TK, NT_WKV>(vs + b * TS, v + base, r, n, d, c0);
    cp_async_commit();
  };
  load_tile_async<WO, CL_ROWS, NT_WKV>(qs, q + base, q0, n, d, c0);
  load_tile_async<WO, CL_ROWS, NT_WKV>(dos, dout + base, q0, n, d, c0);
  load_rows_async<CL_ROWS>(ls, lse + bh * n, q0, n);
  load_rows_async<CL_ROWS>(dls, delta + bh * n, q0, n);
  load_kv_tile(0);
  if (nkt > 1) {
    load_kv_tile(1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // 1. this rank's partial s (bf16 q.k^T raw, f32 (q * scale).k^T in split
  // TF32, each k8 step's passes into fresh accumulators) and dp = do.v^T of
  // K/V tile jt over its 128 columns, 16 queries x 16 keys a warp, into
  // partial buffer jt % 2
  auto partial = [&](int jt) {
    const T* kb = ks + (jt & 1) * TS;
    const T* vb = vs + (jt & 1) * TS;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    if constexpr (BF) {
      const T* qa = qs + (qg * 16 + ln.lm_row) * LD + ln.lm_col;
      const T* da = dos + (qg * 16 + ln.lm_row) * LD + ln.lm_col;
      const int b_off = (half * 16 + ln.lk_row) * LD + ln.lk_col;
#pragma unroll
      for (int kk = 0; kk < WO / 16; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4(a, qa + kk * 16);
        ldsm_x4(b, kb + b_off + kk * 16);
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
        ldsm_x4(a, da + kk * 16);
        ldsm_x4(b, vb + b_off + kk * 16);
        mma_bf16(dp[0], a, b[0], b[1]);
        mma_bf16(dp[1], a, b[2], b[3]);
      }
    } else {
      const int a_off = (qg * 16 + ln.lm_row) * LD + ln.lm_col / 2;
      const int b_off = (half * 16 + ln.lk_row) * LD + ln.lk_col / 2;
#pragma unroll 2
      for (int kk = 0; kk < WO / 8; ++kk) {
        uint32_t qh[4], ql[4], doh[4], dol[4], kh[4], kl[4], vh[4], vl[4];
        ld_split<true>(qh, ql, qs + a_off + kk * 8, scale);
        ld_split<false>(doh, dol, dos + a_off + kk * 8, 1.f);
        ld_split<false>(kh, kl, kb + b_off + kk * 8, 1.f);
        ld_split<false>(vh, vl, vb + b_off + kk * 8, 1.f);
        mma_split_2x2(s[0], s[1], dp[0], dp[1], qh, ql, kh, kl, doh, dol, vh, vl);
      }
    }
    float* xr = xs + (jt & 1) * 2 * XS + (qg * 16 + g) * LX + half * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      store2(xr + 8 * i, s[i][0], s[i][1]);
      store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
      store2(xr + XS + 8 * i, dp[i][0], dp[i][1]);
      store2(xr + XS + 8 * LX + 8 * i, dp[i][2], dp[i][3]);
    }
  };

  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  partial(0);
  cluster_arrive();
  cluster_wait();  // every rank's partials of tile 0 are written
  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    const T* kb = ks + buf * TS;
    float* pb = xs + buf * 2 * XS;

    // 2. the cluster's s and dp, and from them ds = p (dp - delta) with p =
    // exp(s - l) (0 for queries or keys at or past n), to every rank
    cluster_exchange<2, LX, NT_WKV, CL_MAX, 1>(P, rank, pb, pb, [&](float4* x, int row, int col) {
      const bool q_ok = q0 + row < n;
      const float lr = ls[row], dl = dls[row];
      float sv[4] = {x[0].x, x[0].y, x[0].z, x[0].w}, dv4[4] = {x[1].x, x[1].y, x[1].z, x[1].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = q_ok && j * TK + col + e < n;
        const float p = !ok ? 0.f
                        : BF ? ex2(fmaf(sv[e], sl, -lr * LOG2E))
                             : ex2((sv[e] - lr) * LOG2E);
        sv[e] = p * (dv4[e] - dl);
      }
      x[0] = make_float4(sv[0], sv[1], sv[2], sv[3]);
    });
    if (j + 1 < nkt) {  // the next tile's partials while the exchange lands
      cp_async_wait<0>();
      __syncthreads();
      partial(j + 1);
    }
    cluster_arrive();
    cluster_wait();  // tile j's ds and tile j + 1's partials are everywhere

    // 3. dq += ds . k over the warp's 64 columns: bf16 ds split into hi + lo,
    // k read transposed; f32 split TF32, the tile's sums begun at 0 and added
    // to acc in f32
    const float* pr = pb + (qg * 16 + g) * LX + 2 * t;
    if constexpr (BF) {
#pragma unroll
      for (int kq = 0; kq < TK / 16; ++kq) {
        uint32_t hi[4], lo[4];
        p_frag<LX>(pr + kq * 16, hi, lo);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          uint32_t b[4];
          ldsm_x4_trans(b, reinterpret_cast<const __nv_bfloat16*>(kb) +
                               (kq * 16 + ln.lm_row) * LD + half * 64 + dc * 16 + ln.lm_col);
          mma_bf16(acc[2 * dc], hi, b[0], b[1]);
          mma_bf16(acc[2 * dc], lo, b[0], b[1]);
          mma_bf16(acc[2 * dc + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * dc + 1], lo, b[2], b[3]);
        }
      }
    } else {
      constexpr int NS = TK / 8;
      uint32_t ah[NS][4], al[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(pr + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
        const float c[4] = {a.x, a.y, b.x, b.y};
        split_acc_as_a(c, ah[i], al[i]);
      }
      grad_step<NC, NS>(acc, ah, al,
                        reinterpret_cast<const float*>(kb) + 2 * t * LD + half * 64 + g, LD);
    }
    __syncthreads();  // tile j's buffers are free
    if (j + 2 < nkt) load_kv_tile(j + 2);
  }
  store_acc<NC>(dq + base, acc, q0 + qg * 16 + g, c0 + half * 64, t, n, d, scale, scale);
}

// ---------------------------------------------------------------------------
// head dims above 1024, the forward, dQ and dK/dV: one block's tensor-core
// score loop over all of d (f32 in split TF32, bf16 raw; see the note at the top)
// ---------------------------------------------------------------------------

// groups of WO output columns a block: two (256 columns, 8 warps), so that
// half as many blocks form each score as with one.  One
// group a block (experiments/wide_tc_attention_control.py builds it as a
// copy) was slower on the card at (4, 1280, 1032), which fills it, in the
// f32 forward and in dK/dV in both types, and a little faster in the bf16
// forward and at (2, 256, 1032) (PERF.md).
constexpr int WT_G = 2;
// columns of d a staged slice: 256 bytes of a row in either type (f32 64,
// bf16 128)
template <typename T>
constexpr int WT_S = 256 / (int)sizeof(T);
// row strides of a slice and of the block's column tiles: 16 bytes of
// padding (conflict-free ldmatrix and B-operand loads)
template <typename T>
constexpr int WT_LD = WT_S<T> + 16 / (int)sizeof(T);
template <typename T>
constexpr int WT_CLD = WT_G * WO + 16 / (int)sizeof(T);
constexpr int WT_TK = 64;  // keys of a forward K/V tile
// V's columns (the forward), K's (dQ) and q's, do's, l and delta (dK/dV) of a tile
// are copied with the tile's first slice step and waited for with its
// second, so the bodies need two slices at least
static_assert(CL_MAX_D >= 2 * WT_S<float> && CL_MAX_D >= 2 * WT_S<__nv_bfloat16>,
              "the bodies above CL_MAX_D take two slices at least");

// The bodies' shared memory: the forward's two slice buffers of q and of a
// K tile and the V tile's columns (with WT_G > 1 the tile's scores too);
// dK/dV's two slice buffers of k, v, q and do, the Q and dO tiles' columns,
// p^T and ds^T, l and delta.  With two groups a block: 154,624 bytes f32
// and 121,856 bf16 (the forward), 191,744 and 158,976 (dK/dV), one block
// an SM; a third slice buffer was no faster on the card (PERF.md).
template <typename T>
constexpr size_t fwd_wide_tc_smem() {
  return (size_t)2 * (CL_ROWS + WT_TK) * WT_LD<T> * sizeof(T) +
         (size_t)WT_TK * WT_CLD<T> * sizeof(T) +
         (WT_G > 1 ? (size_t)CL_ROWS * (WT_TK + XP) * sizeof(float) : 0);
}
template <typename T>
constexpr size_t dkv_wide_tc_smem() {
  return (size_t)2 * (2 * CL_ROWS + 2 * WKV_TQ) * WT_LD<T> * sizeof(T) +
         2 * (size_t)WKV_TQ * WT_CLD<T> * sizeof(T) +
         2 * (size_t)CL_ROWS * (WKV_TQ + XP) * sizeof(float) + 2 * WKV_TQ * sizeof(float);
}
// keys of a dQ K/V tile above 1024 (experiments/wide_tc_attention_control.py
// times the other of 32 and 64)
constexpr int WDQ_TC_TK = 64;
// dQ's two slice buffers of q, do, k and v, the K tile's columns, ds, l and
// delta: with two groups a block and 64-key tiles 224,768 bytes f32 and
// 192,000 bf16 (32-key tiles: 148,480 and 132,096), one block an SM
template <typename T>
constexpr size_t dq_wide_tc_smem() {
  return (size_t)2 * (2 * CL_ROWS + 2 * WDQ_TC_TK) * WT_LD<T> * sizeof(T) +
         (size_t)WDQ_TC_TK * WT_CLD<T> * sizeof(T) +
         (size_t)CL_ROWS * (WDQ_TC_TK + XP) * sizeof(float) + 2 * CL_ROWS * sizeof(float);
}
static_assert(fwd_wide_tc_smem<float>() <= 232448 && dkv_wide_tc_smem<float>() <= 232448 &&
                  dq_wide_tc_smem<float>() <= 232448,
              "the tiles of the bodies above 1024 overflow shared memory");
static_assert(WDQ_TC_TK % (16 * WT_G) == 0 && WDQ_TC_TK % 32 == 0,
              "a dQ K/V tile is whole k16 steps a warp and whole 32-key ds.k sums");

// forward above head dim 1024: one block per (bh, 64 queries, WT_G groups
// of 128 output columns), 4 WT_G warps; warp w owns queries 16 (w % 4) and
// output columns 128 (w / 4) of the block's.  Per K/V tile of WT_TK keys
// the block walks the slices of d in order, each slice of q and of the K
// tile staged by cp.async, double-buffered (the next slice's copies fly
// while this slice's MMAs run), and accumulates the scores in registers
// over all of d: bf16 q.k^T raw (one f32 accumulator chain, times scale
// after), f32 (q * scale).k^T in split TF32, each k8 step's three MMAs into
// fresh accumulators added in f32 (score_step).  With two groups a warp
// takes the scores of half of the tile's keys and the block shares them
// through shared memory.  Then the online max and sum in f32 registers, as
// fwd_wide_kernel, and p.v over the warp's 128 columns of the V tile
// (staged with the tile's first slice): bf16 p split into hi + lo, f32
// split TF32 with the sums of each 32 keys begun at 0 and added to acc in
// f32.  The block of column group 0 writes l.  q is streamed again for
// every K tile, in bf16 too: a resident 64 x d slice of q (132 KB at d =
// 1032) would put a limit on d; q's slices come from L2, 64 d elements a
// tile beside K's 64 d.  Each block of a row tile
// forms the tile's scores over all of d: ceil(d / 128 WT_G) times the
// score products of the function, the price of no exchange and no limit.
template <typename T>
__global__ void __launch_bounds__(NT_TC * WT_G, WT_G == 1 ? 2 : 1)
fwd_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int n, int d, int ntiles,
                   int parts, float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NTH = NT_TC * WT_G, WS = WT_S<T>, LD = WT_LD<T>, VLD = WT_CLD<T>;
  constexpr int TK = WT_TK, KW = TK / WT_G, NT8 = TK / 8, LX = TK + XP, NO = WO / 8;
  constexpr int QS = CL_ROWS * LD, KS = TK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // 2 x [CL_ROWS][LD]: a slice of q, unscaled
  T* ks = qs + 2 * QS;                     // 2 x [TK][LD]: the same slice of a K tile
  T* vs = ks + 2 * KS;                     // [TK][VLD]: the block's columns of a V tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / parts * CL_ROWS, c0 = tile % parts * (WT_G * WO);
  const size_t base = bh * n * d;
  const Lanes ln;
  const int rg = ln.warp & 3, kp = ln.warp >> 2, g = ln.g, t = ln.t;
  const int ns = (d + WS - 1) / WS, nkt = (n + TK - 1) / TK, steps = nkt * ns;

  // step st: slice st % ns of q and of K tile st / ns, into buffer st % 2
  auto load_step = [&](int st) {
    const int b = st & 1, c = st % ns * WS;
    load_tile_async<WS, CL_ROWS, NTH>(qs + b * QS, q + base, q0, n, d, c);
    load_tile_async<WS, TK, NTH>(ks + b * KS, k + base, st / ns * TK, n, d, c);
  };
  load_step(0);
  cp_async_commit();

  float acc[NO][4];
  // rows g and g + 8 of the warp's 16: running max, and the running sum
  // over this thread's columns (summed over the quad at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    float s[KW / 8][4];
#pragma unroll
    for (int i = 0; i < KW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int st = j * ns + c;
      cp_async_wait<0>();  // step st's slices (and at c = 1 V_j)
      __syncthreads();     // ... everywhere; every warp is done with step st - 1 (and V_{j-1})
      if (st + 1 < steps) load_step(st + 1);
      if (c == 0) load_tile_async<WT_G * WO, TK, NTH>(vs, v + base, j * TK, n, d, c0);
      cp_async_commit();
      const T* qb = qs + (st & 1) * QS;
      const T* kb = ks + (st & 1) * KS + kp * KW * LD;
      if constexpr (BF) {
#pragma unroll
        for (int kk = 0; kk < WS / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, qb + (rg * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            uint32_t b[4];
            ldsm_x4(b, kb + (np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col);
            mma_bf16(s[2 * np], a, b[0], b[1]);
            mma_bf16(s[2 * np + 1], a, b[2], b[3]);
          }
        }
      } else {
        const float* qf = reinterpret_cast<const float*>(qb) + (rg * 16 + ln.lm_row) * LD +
                          ln.lm_col / 2;
        const float* kf = reinterpret_cast<const float*>(kb) + ln.lk_row * LD + ln.lk_col / 2;
#pragma unroll 1
        for (int kk = 0; kk < WS / 8; ++kk) {
          uint32_t ah[4], al[4];
          ld_split<true>(ah, al, qf + kk * 8, scale);
          score_step<LD, KW>(s, ah, al, kf + kk * 8);
        }
      }
    }

    // the scores of the warp's rows over the whole tile (bf16 times scale)
    const float mul = BF ? scale : 1.f;
    float p[NT8][4];
    if constexpr (WT_G == 1) {
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][e] = s[i][e] * mul;
    } else {
      float* xs = reinterpret_cast<float*>(vs + TK * VLD);  // [CL_ROWS][LX]: the tile's scores
      float* xr = xs + (rg * 16 + g) * LX + kp * KW + 2 * t;
#pragma unroll
      for (int i = 0; i < KW / 8; ++i) {
        store2(xr + 8 * i, s[i][0], s[i][1]);
        store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
      }
      __syncthreads();
      const float* sr = xs + (rg * 16 + g) * LX + 2 * t;
#pragma unroll
      for (int i = 0; i < NT8; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(sr + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(sr + 8 * LX + 8 * i);
        p[i][0] = a.x * mul;
        p[i][1] = a.y * mul;
        p[i][2] = b.x * mul;
        p[i][3] = b.y * mul;
      }
    }
    if (j * TK + TK > n) {  // keys at or past n: p = 0
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * TK + i * 8 + 2 * t + (e & 1) >= n) p[i][e] = -INFINITY;
    }

    // online max and sum (f32), as fwd_wide_kernel
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(p[i][0], p[i][1]));
      mx1 = fmaxf(mx1, fmaxf(p[i][2], p[i][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // finite: the tile holds a key
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = ex2((m[0] - mn0) * LOG2E), a1 = ex2((m[1] - mn1) * LOG2E);
    m[0] = mn0;
    m[1] = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      p[i][0] = ex2((p[i][0] - mn0) * LOG2E);
      p[i][1] = ex2((p[i][1] - mn0) * LOG2E);
      p[i][2] = ex2((p[i][2] - mn1) * LOG2E);
      p[i][3] = ex2((p[i][3] - mn1) * LOG2E);
      rs0 += p[i][0] + p[i][1];
      rs1 += p[i][2] + p[i][3];
    }
    l[0] = l[0] * a0 + rs0;
    l[1] = l[1] * a1 + rs1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= a0;
      acc[c][1] *= a0;
      acc[c][2] *= a1;
      acc[c][3] *= a1;
    }

    // acc += p . v over the warp's 128 columns (V_j landed with step j ns + 1)
    if constexpr (BF) {
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vs) + kp * WO + ln.lm_col;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_frag(p[2 * kk], p[2 * kk + 1], hi, lo);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, vb + (kk * 16 + ln.lm_row) * VLD + dp * 16);
          mma_bf16(acc[2 * dp], hi, b[0], b[1]);
          mma_bf16(acc[2 * dp], lo, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    } else {
      const float* vb = reinterpret_cast<const float*>(vs) + 2 * t * VLD + kp * WO + g;
#pragma unroll
      for (int h = 0; h < TK / 32; ++h) {
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_acc_as_a(p[4 * h + i], ph[i], pl[i]);
        grad_step<NO, 4>(acc, ph, pl, vb + 32 * h * VLD, VLD);
      }
    }
  }

  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + rg * 16 + g;
  store_acc<NO>(o + base, acc, row0, c0 + kp * WO, t, n, d, 1.f / l0, 1.f / l1);
  if (c0 == 0 && kp == 0 && t == 0) {
    if (row0 < n) lse[bh * n + row0] = m[0] + logf(l0);
    if (row0 + 8 < n) lse[bh * n + row0 + 8] = m[1] + logf(l1);
  }
}

// dK/dV above head dim 1024: one block per (bh, 64 keys, WT_G groups of 128
// output columns), 8 warps.  Per Q/dO tile of WKV_TQ queries the block
// walks the slices of d in order, each slice of k, v, q and do staged by
// cp.async, double-buffered, and accumulates s^T = k.(q * scale)^T and dp^T
// = v.do^T in registers over all of d (warp w: keys 16 (w % 4), queries 16
// (w / 4)): bf16 raw (s^T times scale after), f32 in split TF32 with each
// k8 step's score MMAs into fresh accumulators and each slice's dp^T MMAs
// into a fresh accumulator, added in f32 (mma_split_2x2), so no sum runs
// long in one accumulator.  Each warp forms p^T = exp(s^T - l) and ds^T =
// p^T (dp^T - delta) in registers (0 for keys or queries at or past n) and
// stages them in shared memory; then dv += p^T.do and dk += ds^T.q over the
// block's columns of the tile's q and do (staged with its first slice;
// warp w: keys 16 (w % 4), columns 64 WT_G (w / 4)), split as
// dkv_wide_kernel splits them.  dk is multiplied by scale at the store.  k
// and v are streamed again for every Q/dO tile (64 d each beside q's and
// do's 32 d), and every block of a key tile forms the tile's s^T and dp^T
// over all of d: ceil(d / 128 WT_G) times those products of the function.
template <typename T>
__global__ void __launch_bounds__(NT_WKV, 1)
dkv_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int n, int d, int ntiles, int parts, float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int WS = WT_S<T>, LD = WT_LD<T>, CLD = WT_CLD<T>, TQ = WKV_TQ, LX = TQ + XP;
  constexpr int XS = CL_ROWS * LX, CW = WT_G * WO / 2, NC = CW / 8;
  constexpr int KS = CL_ROWS * LD, QS = TQ * LD, CS = TQ * CLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // 2 x [CL_ROWS][LD]: a slice of k
  T* vs = ks + 2 * KS;                     // 2 x [CL_ROWS][LD]: of v
  T* qs = vs + 2 * KS;                     // 2 x [TQ][LD]: of a Q tile, unscaled
  T* dos = qs + 2 * QS;                    // 2 x [TQ][LD]: of a dO tile
  T* qc = dos + 2 * QS;                    // [TQ][CLD]: the block's columns of the Q tile
  T* dc = qc + CS;                         // [TQ][CLD]: of the dO tile
  float* xs = reinterpret_cast<float*>(dc + CS);  // [CL_ROWS][LX] p^T, then ds^T
  float* ls = xs + 2 * XS;                        // [TQ] logsumexp of the Q tile
  float* dls = ls + TQ;                           // [TQ] delta of the Q tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile / parts * CL_ROWS, c0 = tile % parts * (WT_G * WO);
  const size_t base = bh * n * d;
  const Lanes ln;
  const int kg = ln.warp & 3, half = ln.warp >> 2, g = ln.g, t = ln.t;
  const int ns = (d + WS - 1) / WS, nqt = (n + TQ - 1) / TQ, steps = nqt * ns;
  const float sl = scale * LOG2E;

  // step st: slice st % ns of k, v and of Q/dO tile st / ns, into buffer st % 2
  auto load_step = [&](int st) {
    const int b = st & 1, c = st % ns * WS, r = st / ns * TQ;
    load_tile_async<WS, CL_ROWS, NT_WKV>(ks + b * KS, k + base, k0, n, d, c);
    load_tile_async<WS, CL_ROWS, NT_WKV>(vs + b * KS, v + base, k0, n, d, c);
    load_tile_async<WS, TQ, NT_WKV>(qs + b * QS, q + base, r, n, d, c);
    load_tile_async<WS, TQ, NT_WKV>(dos + b * QS, dout + base, r, n, d, c);
  };
  load_step(0);
  cp_async_commit();

  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int st = j * ns + c;
      cp_async_wait<0>();  // step st's slices (and at c = 1 the tile's columns, l, delta)
      __syncthreads();     // ... everywhere; every warp is done with step st - 1 (and tile j - 1)
      if (st + 1 < steps) load_step(st + 1);
      if (c == 0) {
        load_tile_async<WT_G * WO, TQ, NT_WKV>(qc, q + base, j * TQ, n, d, c0);
        load_tile_async<WT_G * WO, TQ, NT_WKV>(dc, dout + base, j * TQ, n, d, c0);
        load_rows_async<TQ>(ls, lse + bh * n, j * TQ, n);
        load_rows_async<TQ>(dls, delta + bh * n, j * TQ, n);
      }
      cp_async_commit();
      const int b = st & 1;
      if constexpr (BF) {
        const T* ka = ks + b * KS + (kg * 16 + ln.lm_row) * LD + ln.lm_col;
        const T* va = vs + b * KS + (kg * 16 + ln.lm_row) * LD + ln.lm_col;
        const int b_off = b * QS + (half * 16 + ln.lk_row) * LD + ln.lk_col;
#pragma unroll
        for (int kk = 0; kk < WS / 16; ++kk) {
          uint32_t a[4], bb[4];
          ldsm_x4(a, ka + kk * 16);
          ldsm_x4(bb, qs + b_off + kk * 16);
          mma_bf16(s[0], a, bb[0], bb[1]);
          mma_bf16(s[1], a, bb[2], bb[3]);
          ldsm_x4(a, va + kk * 16);
          ldsm_x4(bb, dos + b_off + kk * 16);
          mma_bf16(dp[0], a, bb[0], bb[1]);
          mma_bf16(dp[1], a, bb[2], bb[3]);
        }
      } else {
        const float* kf = reinterpret_cast<const float*>(ks + b * KS);
        const float* vf = reinterpret_cast<const float*>(vs + b * KS);
        const float* qf = reinterpret_cast<const float*>(qs + b * QS);
        const float* df = reinterpret_cast<const float*>(dos + b * QS);
        const int a_off = (kg * 16 + ln.lm_row) * LD + ln.lm_col / 2;
        const int b_off = (half * 16 + ln.lk_row) * LD + ln.lk_col / 2;
        float dpp[2][4];  // the slice's dp^T
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpp[i][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < WS / 8; ++kk) {
          uint32_t kh[4], kl[4], vh[4], vl[4], qh[4], ql[4], doh[4], dol[4];
          ld_split<false>(kh, kl, kf + a_off + kk * 8, 1.f);
          ld_split<false>(vh, vl, vf + a_off + kk * 8, 1.f);
          ld_split<true>(qh, ql, qf + b_off + kk * 8, scale);
          ld_split<false>(doh, dol, df + b_off + kk * 8, 1.f);
          mma_split_2x2(s[0], s[1], dpp[0], dpp[1], kh, kl, qh, ql, vh, vl, doh, dol);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[i][e] += dpp[i][e];
      }
    }

    // p^T = exp(s^T - l) and ds^T = p^T (dp^T - delta) of the warp's 16 keys
    // x 16 queries, to the staging tiles
    float* xw = xs + (kg * 16 + g) * LX + half * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pv[4], dv4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = half * 16 + 8 * i + 2 * t + (e & 1);
        const bool ok = k0 + kg * 16 + g + (e >> 1) * 8 < n && j * TQ + qi < n;
        const float p = !ok ? 0.f
                        : BF ? ex2(fmaf(s[i][e], sl, -ls[qi] * LOG2E))
                             : ex2((s[i][e] - ls[qi]) * LOG2E);
        pv[e] = p;
        dv4[e] = p * (dp[i][e] - dls[qi]);
      }
      store2(xw + 8 * i, pv[0], pv[1]);
      store2(xw + 8 * LX + 8 * i, pv[2], pv[3]);
      store2(xw + XS + 8 * i, dv4[0], dv4[1]);
      store2(xw + XS + 8 * LX + 8 * i, dv4[2], dv4[3]);
    }
    __syncthreads();

    // dv += p^T . do and dk += ds^T . q over the warp's CW columns
    const float* pr = xs + (kg * 16 + g) * LX + 2 * t;
    if constexpr (BF) {
#pragma unroll
      for (int kq = 0; kq < TQ / 16; ++kq) {
        uint32_t phi[4], plo[4], dhi[4], dlo[4];
        p_frag<LX>(pr + kq * 16, phi, plo);
        p_frag<LX>(pr + XS + kq * 16, dhi, dlo);
#pragma unroll
        for (int cc = 0; cc < NC / 2; ++cc) {
          const int off = (kq * 16 + ln.lm_row) * CLD + half * CW + cc * 16 + ln.lm_col;
          uint32_t bb[4];
          ldsm_x4_trans(bb, reinterpret_cast<const __nv_bfloat16*>(dc) + off);
          mma_bf16(gv[2 * cc], phi, bb[0], bb[1]);
          mma_bf16(gv[2 * cc], plo, bb[0], bb[1]);
          mma_bf16(gv[2 * cc + 1], phi, bb[2], bb[3]);
          mma_bf16(gv[2 * cc + 1], plo, bb[2], bb[3]);
          ldsm_x4_trans(bb, reinterpret_cast<const __nv_bfloat16*>(qc) + off);
          mma_bf16(gk[2 * cc], dhi, bb[0], bb[1]);
          mma_bf16(gk[2 * cc], dlo, bb[0], bb[1]);
          mma_bf16(gk[2 * cc + 1], dhi, bb[2], bb[3]);
          mma_bf16(gk[2 * cc + 1], dlo, bb[2], bb[3]);
        }
      }
    } else {
      constexpr int NS = TQ / 8;
      uint32_t ah[NS][4], al[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(pr + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
        const float c[4] = {a.x, a.y, b.x, b.y};
        split_acc_as_a(c, ah[i], al[i]);
      }
      const int b_off = 2 * t * CLD + half * CW + g;
      grad_step<NC, NS>(gv, ah, al, reinterpret_cast<const float*>(dc) + b_off, CLD);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(pr + XS + 8 * i);
        const float2 b = *reinterpret_cast<const float2*>(pr + XS + 8 * LX + 8 * i);
        const float c[4] = {a.x, a.y, b.x, b.y};
        split_acc_as_a(c, ah[i], al[i]);
      }
      grad_step<NC, NS>(gk, ah, al, reinterpret_cast<const float*>(qc) + b_off, CLD);
    }
  }
  const int row0 = k0 + kg * 16 + g;  // this lane's keys row0 and row0 + 8
  store_acc<NC>(dk + base, gk, row0, c0 + half * CW, t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, c0 + half * CW, t, n, d, 1.f, 1.f);
}

// dQ above head dim 1024: one block per (bh, 64 queries, WT_G groups of 128
// output columns), 4 WT_G warps; warp w owns queries 16 (w % 4), keys
// WDQ_TC_TK / WT_G (w / 4) of each K/V tile's scores and output columns 128
// (w / 4) of the block's.  Per K/V tile the block walks the slices of d in
// order, each slice of q, do and of the K and V tiles staged by cp.async,
// double-buffered, and accumulates s = q.k^T and dp = do.v^T in registers
// over all of d: bf16 raw (s times scale after), f32 in split TF32 with each
// k8 step's score MMAs into fresh accumulators and each slice's dp MMAs into
// a fresh accumulator, added in f32 (mma_split_2x2), so no sum runs long in
// one accumulator.  Each warp forms ds = p (dp - delta) with p = exp(s - l)
// in registers (0 for keys at or past n) and stages it in shared memory, so
// the block shares the tile's ds; then dq += ds.k over the warp's 128
// columns of the K tile (staged with the tile's first slice), split as
// dq_wide_kernel splits it: bf16 ds as hi + lo, f32 split TF32 with the sums
// of each 32 keys begun at 0 and added to acc in f32.  dq is multiplied by
// scale at the store.  q and do are streamed again for every K/V tile (64 d
// each beside k's and v's WDQ_TC_TK d), and every block of a query tile
// forms the tile's s and dp over all of d: ceil(d / 128 WT_G) times those
// products of the function, the price of no exchange and no limit on d.
template <typename T>
__global__ void __launch_bounds__(NT_TC * WT_G, 1)
dq_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int n, int d, int ntiles,
                  int parts, float scale) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NTH = NT_TC * WT_G, WS = WT_S<T>, LD = WT_LD<T>, CLD = WT_CLD<T>;
  constexpr int TK = WDQ_TC_TK, KW = TK / WT_G, LX = TK + XP, NO = WO / 8;
  constexpr int QS = CL_ROWS * LD, KS = TK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // 2 x [CL_ROWS][LD]: a slice of q, unscaled
  T* dos = qs + 2 * QS;                    // 2 x [CL_ROWS][LD]: of do
  T* ks = dos + 2 * QS;                    // 2 x [TK][LD]: of a K tile
  T* vs = ks + 2 * KS;                     // 2 x [TK][LD]: of a V tile
  T* kc = vs + 2 * KS;                     // [TK][CLD]: the block's columns of the K tile
  float* xs = reinterpret_cast<float*>(kc + TK * CLD);  // [CL_ROWS][LX]: ds
  float* ls = xs + CL_ROWS * LX;  // [CL_ROWS] logsumexp of the block's queries
  float* dls = ls + CL_ROWS;      // [CL_ROWS] delta of the block's queries
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / parts * CL_ROWS, c0 = tile % parts * (WT_G * WO);
  const size_t base = bh * n * d;
  const Lanes ln;
  const int rg = ln.warp & 3, kp = ln.warp >> 2, g = ln.g, t = ln.t;
  const int ns = (d + WS - 1) / WS, nkt = (n + TK - 1) / TK, steps = nkt * ns;
  const float sl = scale * LOG2E;

  // step st: slice st % ns of q, do and of K/V tile st / ns, into buffer st % 2
  auto load_step = [&](int st) {
    const int b = st & 1, c = st % ns * WS, r = st / ns * TK;
    load_tile_async<WS, CL_ROWS, NTH>(qs + b * QS, q + base, q0, n, d, c);
    load_tile_async<WS, CL_ROWS, NTH>(dos + b * QS, dout + base, q0, n, d, c);
    load_tile_async<WS, TK, NTH>(ks + b * KS, k + base, r, n, d, c);
    load_tile_async<WS, TK, NTH>(vs + b * KS, v + base, r, n, d, c);
  };
  load_step(0);
  load_rows_async<CL_ROWS>(ls, lse + bh * n, q0, n);
  load_rows_async<CL_ROWS>(dls, delta + bh * n, q0, n);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    float s[KW / 8][4], dp[KW / 8][4];
#pragma unroll
    for (int i = 0; i < KW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int st = j * ns + c;
      cp_async_wait<0>();  // step st's slices (and at c = 1 the tile's K columns)
      __syncthreads();     // ... everywhere; every warp is done with step st - 1 (and tile j - 1)
      if (st + 1 < steps) load_step(st + 1);
      if (c == 0) load_tile_async<WT_G * WO, TK, NTH>(kc, k + base, j * TK, n, d, c0);
      cp_async_commit();
      const int b = st & 1;
      if constexpr (BF) {
        const int a_off = (rg * 16 + ln.lm_row) * LD + ln.lm_col;
        const int b_off = (kp * KW + ln.lk_row) * LD + ln.lk_col;
        const T* qa = qs + b * QS + a_off;
        const T* da = dos + b * QS + a_off;
        const T* kb = ks + b * KS + b_off;
        const T* vb = vs + b * KS + b_off;
#pragma unroll
        for (int kk = 0; kk < WS / 16; ++kk) {
          uint32_t a[4], a2[4];
          ldsm_x4(a, qa + kk * 16);
          ldsm_x4(a2, da + kk * 16);
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, kb + np * 16 * LD + kk * 16);
            mma_bf16(s[2 * np], a, bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
            ldsm_x4(bb, vb + np * 16 * LD + kk * 16);
            mma_bf16(dp[2 * np], a2, bb[0], bb[1]);
            mma_bf16(dp[2 * np + 1], a2, bb[2], bb[3]);
          }
        }
      } else {
        const int a_off = (rg * 16 + ln.lm_row) * LD + ln.lm_col / 2;
        const int b_off = (kp * KW + ln.lk_row) * LD + ln.lk_col / 2;
        const float* qf = reinterpret_cast<const float*>(qs + b * QS) + a_off;
        const float* df = reinterpret_cast<const float*>(dos + b * QS) + a_off;
        const float* kf = reinterpret_cast<const float*>(ks + b * KS) + b_off;
        const float* vf = reinterpret_cast<const float*>(vs + b * KS) + b_off;
        float dpp[KW / 8][4];  // the slice's dp
#pragma unroll
        for (int i = 0; i < KW / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpp[i][e] = 0.f;
#pragma unroll 1
        for (int kk = 0; kk < WS / 8; ++kk) {
          uint32_t qh[4], ql[4], doh[4], dol[4];
          ld_split<true>(qh, ql, qf + kk * 8, scale);
          ld_split<false>(doh, dol, df + kk * 8, 1.f);
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            uint32_t kh[4], kl[4], vh[4], vl[4];
            ld_split<false>(kh, kl, kf + np * 16 * LD + kk * 8, 1.f);
            ld_split<false>(vh, vl, vf + np * 16 * LD + kk * 8, 1.f);
            mma_split_2x2(s[2 * np], s[2 * np + 1], dpp[2 * np], dpp[2 * np + 1], qh, ql, kh, kl,
                          doh, dol, vh, vl);
          }
        }
#pragma unroll
        for (int i = 0; i < KW / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[i][e] += dpp[i][e];
      }
    }

    // ds = p (dp - delta) with p = exp(s - l) of the warp's 16 queries x KW
    // keys, to the staging tile
    float* xw = xs + (rg * 16 + g) * LX + kp * KW + 2 * t;
#pragma unroll
    for (int i = 0; i < KW / 8; ++i) {
      float dv4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rg * 16 + g + (e >> 1) * 8;
        const bool ok = j * TK + kp * KW + 8 * i + 2 * t + (e & 1) < n;
        const float p = !ok ? 0.f
                        : BF ? ex2(fmaf(s[i][e], sl, -ls[row] * LOG2E))
                             : ex2((s[i][e] - ls[row]) * LOG2E);
        dv4[e] = p * (dp[i][e] - dls[row]);
      }
      store2(xw + 8 * i, dv4[0], dv4[1]);
      store2(xw + 8 * LX + 8 * i, dv4[2], dv4[3]);
    }
    __syncthreads();

    // dq += ds . k over the warp's 128 columns (the K tile's columns landed
    // with step j ns + 1)
    const float* pr = xs + (rg * 16 + g) * LX + 2 * t;
    if constexpr (BF) {
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(kc) + kp * WO + ln.lm_col;
#pragma unroll
      for (int kq = 0; kq < TK / 16; ++kq) {
        uint32_t hi[4], lo[4];
        p_frag<LX>(pr + kq * 16, hi, lo);
#pragma unroll
        for (int dc = 0; dc < NO / 2; ++dc) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, kb + (kq * 16 + ln.lm_row) * CLD + dc * 16);
          mma_bf16(acc[2 * dc], hi, bb[0], bb[1]);
          mma_bf16(acc[2 * dc], lo, bb[0], bb[1]);
          mma_bf16(acc[2 * dc + 1], hi, bb[2], bb[3]);
          mma_bf16(acc[2 * dc + 1], lo, bb[2], bb[3]);
        }
      }
    } else {
      const float* kb = reinterpret_cast<const float*>(kc) + 2 * t * CLD + kp * WO + g;
#pragma unroll
      for (int h = 0; h < TK / 32; ++h) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = *reinterpret_cast<const float2*>(pr + 32 * h + 8 * i);
          const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 32 * h + 8 * i);
          const float c[4] = {a.x, a.y, b.x, b.y};
          split_acc_as_a(c, ah[i], al[i]);
        }
        grad_step<NO, 4>(acc, ah, al, kb + 32 * h * CLD, CLD);
      }
    }
  }
  store_acc<NO>(dq + base, acc, q0 + rg * 16 + g, c0 + kp * WO, t, n, d, scale, scale);
}

// ---------------------------------------------------------------------------
// head dims 160-256, the f32 forward and dK/dV: split TF32 on the tensor
// cores, one block of two warpgroups per (bh, 96 queries or 64 keys) that
// share each score through shared memory (the in-block form of the cluster
// bodies)
// ---------------------------------------------------------------------------

// The two warps of a pair (w and w + 4 of dK/dV's 8) share 16 rows
// (queries, or keys in dK/dV): each forms the scores of those rows against
// half of a tile, and each takes the products of those rows over half of
// the output columns.  Pair i meets at named barrier 1 + i (0 is
// __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// query rows of a forward block, 16 a warp pair (four threads a row): 96,
// so that (8, 1280, d) gives 112 blocks (14 row tiles a panel), one wave of
// one block an SM (168 registers a thread)
constexpr int TW_ROWS = 96;
// dK/dV's Q/dO tile buffers (WKV_TQ queries): two where they fit (160,
// 192); one at 256, where dO's next tile flies during ds^T.q and q's is
// waited for
template <int DP>
constexpr int TW_QB = DP == 256 ? 1 : 2;

// forward, head dims 160-256: one block of 2 TW_ROWS / 16 warps per (bh,
// TW_ROWS queries), over K/V tiles of FWD32_TK keys, one of each in shared
// memory (a K tile's copies fly while the block takes the last tile's p.v,
// a V tile's while it takes the next scores).  Warp pair i (warps i and i +
// TW_ROWS / 16) owns rows 16 i.  Each warp of a pair forms the scores of its
// rows against half of the tile's keys over all DP columns, each k8 step's
// three MMAs into fresh accumulators (score_step), so each score is formed
// once, in fwd_tf32_kernel's order.  The pair exchanges its row maxima
// through shared memory and both warps form the same running max and
// alpha; each writes its p (f32) to the staging tile, and after a barrier
// takes p.v for its 16 rows over its half of the DP columns: p read back in
// the accumulator layout and split (split_acc_as_a), the tile's sums begun
// at 0 and added to the running output after its alpha rescale
// (grad_step), as fwd_tf32_kernel.  The row sums of the two halves are
// added at the end.
template <int DP>
__global__ void __launch_bounds__(4 * TW_ROWS, 1)
fwd_tf32w_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int n, int d, int ntiles, float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, TK = FWD32_TK, TS = TK * LD, LX = TK + XP;
  constexpr int NC = DP / 16;  // n8 tiles of a warp's DP / 2 output columns
  constexpr int RWS = TW_ROWS, NTH = 4 * RWS, NP = RWS / 16;  // rows, threads, warp pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [RWS][LD], q unscaled
  float* ks = qs + RWS * LD;                       // [TK][LD]
  float* vs = ks + TS;                             // [TK][LD]
  float* ps = vs + TS;                             // [RWS][LX]: the tile's p
  float* xm = ps + RWS * LX;                       // 2 x [RWS]: each half's row max, then sum
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * RWS;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t, pair = warp % NP, half = warp / NP;
  const int rw = pair * 16;        // the warp's 16 rows
  const int kw = half * 16;        // its 16 keys of a tile (scores)
  const int cw = half * (DP / 2);  // its output columns (p.v)
  const int nkt = (n + TK - 1) / TK;
  const int a_off = (rw + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = (kw + ln.lk_row) * LD + ln.lk_col / 2;

  // copy groups in order K_0 (with q), V_0, K_1, V_1, ...: K_{j+1} is
  // issued once every warp is done with K_j's scores, V_{j+1} once every
  // warp is done with V_j's p.v
  auto load_k = [&](int jt) {
    load_tile_async<DP, TK, NTH>(ks, k + base, jt * TK, n, d);
    cp_async_commit();
  };
  auto load_v = [&](int jt) {
    load_tile_async<DP, TK, NTH>(vs, v + base, jt * TK, n, d);
    cp_async_commit();
  };
  load_tile_async<DP, RWS, NTH>(qs, q + base, q0, n, d);
  load_k(0);
  load_v(0);

  float acc[NC][4];
  // rows g and g + 8 of the warp's tile: running max, and the running sum
  // over this thread's columns of the warp's keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    // K_j is in (V_0 may still fly; V_j, j > 0, is not issued yet)
    if (j == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // K_j everywhere; every warp is done with V_{j-1} and the last p
    if (j > 0) load_v(j);

    // s = (q * scale) . k^T over the warp's 16 keys
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      ld_split<true>(ah, al, qs + a_off + kk * 8, scale);
      score_step<LD, 16>(s, ah, al, ks + b_off + kk * 8);
    }
    if (j * TK + TK > n) {  // keys at or past n: p = 0
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * TK + kw + i * 8 + 2 * t + (e & 1) >= n) s[i][e] = -INFINITY;
    }

    // the tile's row max over both halves (the two warps form the same
    // bits: fmaxf of the same values), then the online max and sum in f32
    // as fwd_tf32_kernel
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      xm[half * RWS + rw + g] = mx0;
      xm[half * RWS + rw + g + 8] = mx1;
    }
    pair_sync(pair);
    // finite: the tile holds a key
    const float mn0 = fmaxf(m[0], fmaxf(xm[rw + g], xm[RWS + rw + g]));
    const float mn1 = fmaxf(m[1], fmaxf(xm[rw + g + 8], xm[RWS + rw + g + 8]));
    const float a0 = ex2((m[0] - mn0) * LOG2E), a1 = ex2((m[1] - mn1) * LOG2E);
    m[0] = mn0;
    m[1] = mn1;
    float rs0 = 0.f, rs1 = 0.f;
    float* xr = ps + (rw + g) * LX + kw + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i][0] = ex2((s[i][0] - mn0) * LOG2E);
      s[i][1] = ex2((s[i][1] - mn0) * LOG2E);
      s[i][2] = ex2((s[i][2] - mn1) * LOG2E);
      s[i][3] = ex2((s[i][3] - mn1) * LOG2E);
      rs0 += s[i][0] + s[i][1];
      rs1 += s[i][2] + s[i][3];
      store2(xr + 8 * i, s[i][0], s[i][1]);
      store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
    }
    l[0] = l[0] * a0 + rs0;
    l[1] = l[1] * a1 + rs1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] *= a0;
      acc[c][1] *= a0;
      acc[c][2] *= a1;
      acc[c][3] *= a1;
    }

    cp_async_wait<0>();  // V_j
    __syncthreads();     // V_j and the tile's p everywhere; every warp is done with K_j
    if (j + 1 < nkt) load_k(j + 1);

    // acc += p . v over the warp's columns from split A fragments of its
    // rows of p (all FWD32_TK keys), the tile's sums begun at 0
    uint32_t ph[TK / 8][4], pl[TK / 8][4];
    const float* pr = ps + (rw + g) * LX + 2 * t;
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(pr + 8 * i);
      const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
      const float c[4] = {a.x, a.y, b.x, b.y};
      split_acc_as_a(c, ph[i], pl[i]);
    }
    grad_step<NC, TK / 8>(acc, ph, pl, vs + 2 * t * LD + cw + g, LD);
  }

  // each row's sum: over the quad, then the two halves' in order
  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t == 0) {  // every warp read the last maxima before the last __syncthreads
    xm[half * RWS + rw + g] = l0;
    xm[half * RWS + rw + g + 8] = l1;
  }
  pair_sync(pair);
  l0 = xm[rw + g] + xm[RWS + rw + g];
  l1 = xm[rw + g + 8] + xm[RWS + rw + g + 8];
  const int row0 = q0 + rw + g;
  store_acc<NC>(o + base, acc, row0, cw, t, n, d, 1.f / l0, 1.f / l1);
  if (half == 0 && t == 0) {
    if (row0 < n) lse[bh * n + row0] = m[0] + logf(l0);
    if (row0 + 8 < n) lse[bh * n + row0 + 8] = m[1] + logf(l1);
  }
}

// dK/dV, head dims 160-256: one block of 8 warps per (bh, 64 keys), which
// stages k and v for its life and loops over Q/dO tiles of WKV_TQ queries
// (with each tile's l and delta).  Per tile, warp w forms s^T = k.(q *
// scale)^T and dp^T = v.do^T of keys 16 (w % 4) against queries 16 (w / 4)
// over all DP columns (mma_split_2x2: the scores' k8 steps into fresh
// accumulators, dp^T in one), then p^T = exp(s^T - l) and ds^T = p^T (dp^T -
// delta), which it writes (f32) to two 64 x 32 staging tiles; after its
// pair's barrier it takes dv += p^T.do and then dk += ds^T.q for its 16
// keys over its warpgroup's DP / 2 columns, each tile's sums begun at 0
// (grad_step), as dkv_tf32_kernel.
template <int DP>
__global__ void __launch_bounds__(NT_WKV, 1)
dkv_tf32w_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int n, int d, int ntiles,
                 float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, TQ = WKV_TQ, TS = TQ * LD, LX = TQ + XP;
  constexpr int XS = TILE * LX, QB = TW_QB<DP>, NC = DP / 16, NS = TQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [TILE][LD]
  float* vs = ks + TILE * LD;                      // [TILE][LD]
  float* qs = vs + TILE * LD;                      // QB x [TQ][LD], q unscaled
  float* dos = qs + QB * TS;                       // QB x [TQ][LD]
  float* xs = dos + QB * TS;                       // [TILE][LX] p^T, then [TILE][LX] ds^T
  float* ls = xs + 2 * XS;                         // QB x [TQ] logsumexp of the Q tile
  float* dls = ls + QB * TQ;                       // QB x [TQ] delta of the Q tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile * TILE;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t, half = warp >> 2;
  const int kr = (warp & 3) * 16;  // the warp's 16 keys
  const int qw = half * 16;        // its 16 queries of a tile (scores)
  const int cw = half * (DP / 2);  // its output columns (gradients)
  const int nqt = (n + TQ - 1) / TQ;
  const int row0 = k0 + kr + g;  // this lane's keys row0 and row0 + 8
  const int a_off = (kr + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = (qw + ln.lk_row) * LD + ln.lk_col / 2;

  auto load_q = [&](int jt) {  // q, l and delta of Q tile jt
    const int b = jt % QB, r = jt * TQ;
    load_tile_async<DP, TQ, NT_WKV>(qs + b * TS, q + base, r, n, d);
    load_rows_async<TQ>(ls + b * TQ, lse + bh * n, r, n);
    load_rows_async<TQ>(dls + b * TQ, delta + bh * n, r, n);
  };
  auto load_do = [&](int jt) {
    load_tile_async<DP, TQ, NT_WKV>(dos + (jt % QB) * TS, dout + base, jt * TQ, n, d);
  };
  load_tile_async<DP, TILE, NT_WKV>(ks, k + base, k0, n, d);
  load_tile_async<DP, TILE, NT_WKV>(vs, v + base, k0, n, d);
  load_q(0);
  load_do(0);
  cp_async_commit();

  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    const int buf = j % QB;
    cp_async_wait<0>();  // Q/dO tile j, the newest group
    __syncthreads();     // tile j everywhere; every warp is done with tile j - 1
    if (QB == 2 && j + 1 < nqt) {  // into the buffer of tile j - 1
      load_q(j + 1);
      load_do(j + 1);
      cp_async_commit();
    }
    const float* qb = qs + buf * TS;
    const float* db = dos + buf * TS;
    const float* lb = ls + buf * TQ;
    const float* dlb = dls + buf * TQ;

    // s^T = k . (q * scale)^T and dp^T = v . do^T over the warp's 16 queries
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4], qh[4], ql[4], doh[4], dol[4];
      ld_split<false>(kh, kl, ks + a_off + kk * 8, 1.f);
      ld_split<false>(vh, vl, vs + a_off + kk * 8, 1.f);
      ld_split<true>(qh, ql, qb + b_off + kk * 8, scale);
      ld_split<false>(doh, dol, db + b_off + kk * 8, 1.f);
      mma_split_2x2(s[0], s[1], dp[0], dp[1], kh, kl, qh, ql, vh, vl, doh, dol);
    }
    if (k0 + TILE > n || j * TQ + TQ > n) {  // keys or queries at or past n: p = 0
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * TQ + qw + i * 8 + 2 * t + (e & 1) >= n || row0 + (e >> 1) * 8 >= n)
            s[i][e] = -INFINITY;
    }
    // p^T = 2^((s^T - l) * log2(e)) and ds^T = p^T * (dp^T - delta) into the
    // staging tiles
    float* xr = xs + (kr + g) * LX + qw + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = qw + i * 8 + 2 * t;  // query in the tile
      const float2 l2 = *reinterpret_cast<const float2*>(lb + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlb + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((s[i][e] - (e & 1 ? l2.y : l2.x)) * LOG2E);
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - (e & 1 ? d2.y : d2.x));
      }
      store2(xr + 8 * i, s[i][0], s[i][1]);
      store2(xr + 8 * LX + 8 * i, s[i][2], s[i][3]);
      store2(xr + XS + 8 * i, dp[i][0], dp[i][1]);
      store2(xr + XS + 8 * LX + 8 * i, dp[i][2], dp[i][3]);
    }
    pair_sync(warp & 3);  // the pair's keys' p^T and ds^T over all TQ queries are in

    // dv += p^T . do, then dk += ds^T . q, over the warp's columns from
    // split A fragments of its keys' rows (one set live at a time)
    const float* pr = xs + (kr + g) * LX + 2 * t;
    uint32_t ah[NS][4], al[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(pr + 8 * i);
      const float2 b = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
      const float c[4] = {a.x, a.y, b.x, b.y};
      split_acc_as_a(c, ah[i], al[i]);
    }
    grad_step<NC, NS>(gv, ah, al, db + 2 * t * LD + cw + g, LD);
    if (QB == 1) {
      __syncthreads();  // every warp is done with dO tile j
      if (j + 1 < nqt) {
        load_do(j + 1);
        cp_async_commit();
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(pr + XS + 8 * i);
      const float2 b = *reinterpret_cast<const float2*>(pr + XS + 8 * LX + 8 * i);
      const float c[4] = {a.x, a.y, b.x, b.y};
      split_acc_as_a(c, ah[i], al[i]);
    }
    grad_step<NC, NS>(gk, ah, al, qb + 2 * t * LD + cw + g, LD);
    if (QB == 1) {
      __syncthreads();  // every warp is done with Q tile j, its l and delta
      if (j + 1 < nqt) {
        load_q(j + 1);
        cp_async_commit();
      }
    }
  }
  store_acc<NC>(dk + base, gk, row0, cw, t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, cw, t, n, d, 1.f, 1.f);
}

// query rows of a dQ block, 16 a warp pair: 80 (10 warps, at most 200
// registers a thread), so that (8, 1280, d) gives 128 blocks, one wave of
// one block an SM; and keys of its K/V tiles: 16, so that two K tiles (each
// tile's copies fly during the tile before it) fit beside q and do at head
// dim 256
constexpr int DQW_ROWS = 80;
constexpr int DQW_TK = 16;

// dp (NK keys) += a . v^T over one k8 step in split TF32 (vp: this lane's
// ldmatrix row of the step in the V tile), the three passes into dp itself
// in mma_split_2x2's order
template <int LD, int NK>
__device__ __forceinline__ void dp_step(float dp[NK / 8][4], const uint32_t ah[4],
                                        const uint32_t al[4], const float* vp) {
#pragma unroll
  for (int np = 0; np < NK / 16; ++np) {
    uint32_t vh[4], vl[4];
    ld_split<false>(vh, vl, vp + np * 16 * LD, 1.f);
    mma_tf32(dp[2 * np], al, vh[0], vh[1]);
    mma_tf32(dp[2 * np + 1], al, vh[2], vh[3]);
    mma_tf32(dp[2 * np], ah, vl[0], vl[1]);
    mma_tf32(dp[2 * np + 1], ah, vl[2], vl[3]);
    mma_tf32(dp[2 * np], ah, vh[0], vh[1]);
    mma_tf32(dp[2 * np + 1], ah, vh[2], vh[3]);
  }
}

// dQ, head dims 160-256: one block of 2 DQW_ROWS / 16 warps per (bh,
// DQW_ROWS queries), which stages q and do for its life and loops over K/V
// tiles of DQW_TK keys (two K tiles, one V tile).  Warp pair i (warps i
// and i + DQW_ROWS / 16) owns queries 16 i.  Per tile the pair's first warp
// forms s = (q * scale).k^T of its rows against the tile over all DP
// columns, each k8 step's three MMAs into fresh accumulators (score_step),
// and writes p = 2^((s - l) * log2(e)) (f32) to a staging tile; its second
// warp forms dp = do.v^T, three passes into one accumulator (dp_step), and
// writes dp - delta to another.  So each score is formed once, in
// dq_tf32_kernel's order, and each operand of the scores is split by one
// warp.  After a block barrier (the next V tile's copies then fly) both
// warps read the two tiles back in the accumulator layout, form the same
// ds = p (dp - delta), and each takes ds.k for its 16 rows over its
// warpgroup's DP / 2 columns from split A fragments (split_acc_as_a), the
// tile's sums begun at 0 and added to the running sum in f32 (grad_step).
template <int DP>
__global__ void __launch_bounds__(4 * DQW_ROWS, 1)
dq_tf32w_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int n, int d, int ntiles, float scale) {
  constexpr int LD = DP + 4, KS = DP / 8, TK = DQW_TK, TS = TK * LD, LX = TK + XP;
  constexpr int NC = DP / 16, NS = TK / 8;  // NC: n8 tiles of DP / 2 columns
  constexpr int RWS = DQW_ROWS, NTH = 4 * RWS, NP = RWS / 16, XS = RWS * LX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [RWS][LD], q unscaled
  float* dos = qs + RWS * LD;                      // [RWS][LD]
  float* ks = dos + RWS * LD;                      // 2 x [TK][LD]
  float* vs = ks + 2 * TS;                         // [TK][LD]
  float* xs = vs + TS;                             // [RWS][LX] p, then [RWS][LX] dp - delta
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * RWS;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t, pair = warp % NP, half = warp / NP;
  const int rw = pair * 16;        // the pair's 16 queries
  const int cw = half * (DP / 2);  // the warp's output columns (ds.k)
  const int nkt = (n + TK - 1) / TK;
  const int row0 = q0 + rw + g;  // this lane's queries row0 and row0 + 8
  const int a_off = (rw + ln.lm_row) * LD + ln.lm_col / 2;
  const int b_off = ln.lk_row * LD + ln.lk_col / 2;

  // copy groups in order q, do and K_0; V_0; K_1; V_1; ...: K_{j+1} is
  // issued once every warp is done with K_{j-1}, V_{j+1} once every
  // warp is done with V_j's dp
  auto load_k = [&](int jt) {
    load_tile_async<DP, TK, NTH>(ks + (jt % 2) * TS, k + base, jt * TK, n, d);
    cp_async_commit();
  };
  auto load_v = [&](int jt) {
    load_tile_async<DP, TK, NTH>(vs, v + base, jt * TK, n, d);
    cp_async_commit();
  };
  load_tile_async<DP, RWS, NTH>(qs, q + base, q0, n, d);
  load_tile_async<DP, RWS, NTH>(dos, dout + base, q0, n, d);
  load_k(0);
  load_v(0);

  // rows g and g + 8 of the pair: l and delta; rows past n read row n - 1
  // and are never stored
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = bh * n + min(row0 + 8 * h, n - 1);
    lr[h] = lse[r];
    dl[h] = delta[r];
  }
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<0>();  // K_j and V_j
    __syncthreads();     // K_j and V_j everywhere; every warp is done with tile j - 1
    if (j + 1 < nkt) load_k(j + 1);
    const float* kb = ks + (j % 2) * TS;

    // the first warp of a pair p = 2^((s - l) * log2(e)), the second dp -
    // delta, over the tile's TK keys
    float x[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
    if (half == 0) {
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        ld_split<true>(ah, al, qs + a_off + kk * 8, scale);
        score_step<LD, TK>(x, ah, al, kb + b_off + kk * 8);
      }
      if (j * TK + TK > n) {  // keys at or past n: p = 0
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * TK + i * 8 + 2 * t + (e & 1) >= n) x[i][e] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] = ex2((x[i][e] - lr[e >> 1]) * LOG2E);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        ld_split<false>(ah, al, dos + a_off + kk * 8, 1.f);
        dp_step<LD, TK>(x, ah, al, vs + b_off + kk * 8);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] -= dl[e >> 1];
    }
    float* xr = xs + half * XS + (rw + g) * LX + 2 * t;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      store2(xr + 8 * i, x[i][0], x[i][1]);
      store2(xr + 8 * LX + 8 * i, x[i][2], x[i][3]);
    }
    __syncthreads();  // p and dp - delta everywhere; every warp is done with V_j
    if (j + 1 < nkt) load_v(j + 1);

    // acc += ds . k over the warp's columns, ds = p (dp - delta) of the
    // pair's rows as split A fragments over the tile's keys
    const float* pr = xs + (rw + g) * LX + 2 * t;
    uint32_t ah[NS][4], al[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float2 p0 = *reinterpret_cast<const float2*>(pr + 8 * i);
      const float2 p1 = *reinterpret_cast<const float2*>(pr + 8 * LX + 8 * i);
      const float2 x0 = *reinterpret_cast<const float2*>(pr + XS + 8 * i);
      const float2 x1 = *reinterpret_cast<const float2*>(pr + XS + 8 * LX + 8 * i);
      const float c[4] = {p0.x * x0.x, p0.y * x0.y, p1.x * x1.x, p1.y * x1.y};
      split_acc_as_a(c, ah[i], al[i]);
    }
    grad_step<NC, NS>(acc, ah, al, kb + 2 * t * LD + cw + g, LD);
  }
  store_acc<NC>(dq + base, acc, row0, cw, t, n, d, scale, scale);
}

// their shared memory: the forward's q, one K and one V tile, the p staging
// tile and two row vectors (121,088 bytes at head dim 160, 141,568 at 192,
// 182,528 at 256: one block an SM); dK/dV's k and v, QB Q and dO tiles, the
// p^T and ds^T staging tiles, QB l and delta rows (188,928, 221,696 and
// 220,416 bytes: one block an SM); dQ's q and do, two K tiles and one V
// tile, the p and dp - delta staging tiles (151,808, 178,432 and 231,680
// bytes: one block an SM)
template <int DP>
constexpr size_t fwd_tf32w_smem() {
  return (size_t)(TW_ROWS + 2 * FWD32_TK) * (DP + 4) * sizeof(float) +
         (size_t)TW_ROWS * (FWD32_TK + XP) * sizeof(float) + 2 * TW_ROWS * sizeof(float);
}
template <int DP>
constexpr size_t dkv_tf32w_smem() {
  return (size_t)(2 * TILE + 2 * TW_QB<DP> * WKV_TQ) * (DP + 4) * sizeof(float) +
         2 * (size_t)TILE * (WKV_TQ + XP) * sizeof(float) +
         2 * TW_QB<DP> * WKV_TQ * sizeof(float);
}
template <int DP>
constexpr size_t dq_tf32w_smem() {
  return (size_t)(2 * DQW_ROWS + 3 * DQW_TK) * (DP + 4) * sizeof(float) +
         2 * (size_t)DQW_ROWS * (DQW_TK + XP) * sizeof(float);
}
// at most the 227 KB of dynamic shared memory a block may use
static_assert(dq_tf32w_smem<256>() <= 232448, "dQ's tiles overflow shared memory at 256");

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t f32_tile_bytes(int rows, int dp) { return (size_t)rows * (dp + 4) * sizeof(float); }
constexpr size_t bf16_tile_bytes(int dp) { return (size_t)TILE * (dp + 8) * sizeof(__nv_bfloat16); }

// grid = bh * ceil(n / rows) * parts blocks, and the kernel's shared memory
template <typename K>
cudaError_t prepare(K kern, size_t smem, int bh, int n, unsigned& grid, int& ntiles, int rows,
                    int parts = 1) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  ntiles = (n + rows - 1) / rows * parts;
  if ((long long)bh * ntiles > INT_MAX) return cudaErrorInvalidValue;
  grid = (unsigned)(bh * ntiles);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, bool BF>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                    int bh, int n, int d, float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    constexpr int TQ = 64 * TC_MT<DP>;
    const size_t smem = (TQ / TILE + 4) * bf16_tile_bytes(DP);
    auto kern = fwd_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TQ, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, l, n, d,
                                        ntiles, scale);
  } else if constexpr (DP <= 128) {
    const size_t smem = f32_tile_bytes(TILE, DP) + 4 * f32_tile_bytes(FWD32_TK, DP);
    auto kern = fwd_tf32_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT_TC, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                        (float*)o, l, n, d, ntiles, scale);
  } else {
    const size_t smem = fwd_tf32w_smem<DP>();
    auto kern = fwd_tf32w_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TW_ROWS);
    if (e != cudaSuccess) return e;
    kern<<<grid, 4 * TW_ROWS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                              (float*)o, l, n, d, ntiles, scale);
  }
  return cudaGetLastError();
}

template <int DP, bool BF>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* l, const float* delta, void* dq, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    constexpr int TQ = 64 * DQ_MT<DP>;
    const size_t smem = (2 * TQ / TILE + 4) * bf16_tile_bytes(DP);
    auto kern = dq_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TQ, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                        l, delta, (T*)dq, n, d, ntiles, scale);
  } else if constexpr (DP <= 128) {
    const size_t smem = 6 * f32_tile_bytes(TILE, DP);
    auto kern = dq_tf32_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT_TC, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                        (const float*)dout, l, delta, (float*)dq, n, d, ntiles,
                                        scale);
  } else {
    const size_t smem = dq_tf32w_smem<DP>();
    auto kern = dq_tf32w_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, DQW_ROWS);
    if (e != cudaSuccess) return e;
    kern<<<grid, 4 * DQW_ROWS, smem, stream>>>((const float*)q, (const float*)k,
                                               (const float*)v, (const float*)dout, l, delta,
                                               (float*)dq, n, d, ntiles, scale);
  }
  return cudaGetLastError();
}

template <int DP, bool BF>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* l, const float* delta, void* dk, void* dv, int bh, int n,
                    int d, float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    const size_t smem = 6 * bf16_tile_bytes(DP) + 4 * TILE * sizeof(float);
    auto kern = dkv_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                        l, delta, (T*)dk, (T*)dv, n, d, ntiles, scale);
  } else if constexpr (DP <= 128) {
    const size_t smem = 6 * f32_tile_bytes(TILE, DP) + 4 * TILE * sizeof(float);
    auto kern = dkv_tf32_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT_TC, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                        (const float*)dout, l, delta, (float*)dk, (float*)dv, n,
                                        d, ntiles, scale);
  } else {
    const size_t smem = dkv_tf32w_smem<DP>();
    auto kern = dkv_tf32w_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT_WKV, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         (const float*)dout, l, delta, (float*)dk, (float*)dv,
                                         n, d, ntiles, scale);
  }
  return cudaGetLastError();
}

// head dims above 1024: grid = bh * ceil(n / rows) * ceil(d / cols) blocks
// of `threads` (the three tensor-core bodies: 64-row tiles of 128 WT_G
// columns)
template <typename K, typename... A>
cudaError_t run_wide(K kern, size_t smem, int rows, int cols, int threads, int bh, int n, int d,
                     float scale, cudaStream_t stream, A... args) {
  unsigned grid;
  int ntiles;
  const int parts = (d + cols - 1) / cols;
  cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, rows, parts);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(args..., n, d, ntiles, parts, scale);
  return cudaGetLastError();
}

// the cluster bodies' shared memory: the forward's q slice, two K tiles and
// one V tile, two score tiles (106,496 bytes bf16, 104,960 f32: two blocks
// an SM); dK/dV's k and v slices, two Q and dO tiles, two of s^T and dp^T,
// two l and delta rows (111,104 bytes bf16, 176,640 f32)
template <typename T>
constexpr size_t fwd_wide_smem() {
  return (size_t)(CL_ROWS + 3 * WF_TK<T>) * CL_LD<T> * sizeof(T) +
         2 * (size_t)CL_ROWS * (WF_TK<T> + XP) * sizeof(float);
}
template <typename T>
constexpr size_t dkv_wide_smem() {
  return (size_t)(2 * CL_ROWS + 4 * WKV_TQ) * CL_LD<T> * sizeof(T) +
         4 * (size_t)CL_ROWS * (WKV_TQ + XP) * sizeof(float) + 4 * WKV_TQ * sizeof(float);
}
// dQ's q and do slices, two K and V tiles, two of s and dp, its queries' l
// and delta (111,104 bytes bf16: two blocks an SM; 176,640 f32)
template <typename T>
constexpr size_t dq_wide_smem() {
  return (size_t)(2 * CL_ROWS + 4 * WDQ_TK) * CL_LD<T> * sizeof(T) +
         4 * (size_t)CL_ROWS * (WDQ_TK + XP) * sizeof(float) + 2 * CL_ROWS * sizeof(float);
}

// The launch of a cluster body for head dims 264-1024: clusters of P =
// ceil(d / 128) blocks (the cluster's size is a launch attribute, since it
// depends on d), grid = bh * ceil(n / 64) * P blocks with the ranks of a
// cluster adjacent.  A launch the card refuses returns its error.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& attr, unsigned grid, int threads,
                                  size_t smem, int parts, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = parts;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename... K, typename... A>
cudaError_t run_cluster(void (*kern)(K...), size_t smem, int threads, int bh, int n, int d,
                        float scale, cudaStream_t stream, A... args) {
  unsigned grid;
  int ntiles;
  const int parts = (d + WO - 1) / WO;
  cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, CL_ROWS, parts);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(attr, grid, threads, smem, parts, stream);
  e = cudaLaunchKernelEx(&cfg, kern, args..., n, d, ntiles, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Dispatch on the padded head dim (16, 32, 64, 96, 128, 160, 192, 256, and
// any d above 256 through the WIDE bodies; d % 8 == 0) and the input type
// (bf16 or f32).
#define ATT_DISPATCH(d, bf, CALL, WIDE)                                          \
  if ((d) <= 0 || (d) % 8 != 0) return (int)cudaErrorInvalidValue;              \
  if ((d) > 256) return (int)(bf ? WIDE(__nv_bfloat16) : WIDE(float));          \
  if ((d) <= 16) return (int)(bf ? CALL(16, true) : CALL(16, false));           \
  if ((d) <= 32) return (int)(bf ? CALL(32, true) : CALL(32, false));           \
  if ((d) <= 64) return (int)(bf ? CALL(64, true) : CALL(64, false));           \
  if ((d) <= 96) return (int)(bf ? CALL(96, true) : CALL(96, false));           \
  if ((d) <= 128) return (int)(bf ? CALL(128, true) : CALL(128, false));        \
  if ((d) <= 160) return (int)(bf ? CALL(160, true) : CALL(160, false));        \
  if ((d) <= 192) return (int)(bf ? CALL(192, true) : CALL(192, false));        \
  return (int)(bf ? CALL(256, true) : CALL(256, false));

}  // namespace

ATT_EXPORT int attention_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                             int bh, int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) run_fwd<DP, BF>(q, k, v, o, l, bh, n, d, scale, (cudaStream_t)stream)
#define WIDE(T)                                                                          \
  (d <= CL_MAX_D                                                                         \
       ? run_cluster(fwd_wide_kernel<T>, fwd_wide_smem<T>(), NT_TC, bh, n, d, scale,     \
                     (cudaStream_t)stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, l) \
       : run_wide(fwd_wide_tc_kernel<T>, fwd_wide_tc_smem<T>(), CL_ROWS, WT_G * WO,     \
                  NT_TC * WT_G, bh, n, d, scale, (cudaStream_t)stream, (const T*)q,      \
                  (const T*)k, (const T*)v, (T*)o, l))
  ATT_DISPATCH(d, bf, CALL, WIDE)
#undef WIDE
#undef CALL
}

ATT_EXPORT int attention_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* l, const float* delta, void* dq, int bh, int n,
                            int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) \
  run_dq<DP, BF>(q, k, v, dout, l, delta, dq, bh, n, d, scale, (cudaStream_t)stream)
#define WIDE(T)                                                                            \
  (d <= CL_MAX_D                                                                           \
       ? run_cluster(dq_wide_kernel<T>, dq_wide_smem<T>(), NT_WKV, bh, n, d, scale,        \
                     (cudaStream_t)stream, (const T*)q, (const T*)k, (const T*)v,          \
                     (const T*)dout, l, delta, (T*)dq)                                     \
       : run_wide(dq_wide_tc_kernel<T>, dq_wide_tc_smem<T>(), CL_ROWS, WT_G * WO,         \
                  NT_TC * WT_G, bh, n, d, scale, (cudaStream_t)stream, (const T*)q,        \
                  (const T*)k, (const T*)v, (const T*)dout, l, delta, (T*)dq))
  ATT_DISPATCH(d, bf, CALL, WIDE)
#undef WIDE
#undef CALL
}

ATT_EXPORT int attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* l, const float* delta, void* dk, void* dv, int bh,
                             int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) \
  run_dkv<DP, BF>(q, k, v, dout, l, delta, dk, dv, bh, n, d, scale, (cudaStream_t)stream)
#define WIDE(T)                                                                            \
  (d <= CL_MAX_D                                                                           \
       ? run_cluster(dkv_wide_kernel<T>, dkv_wide_smem<T>(), NT_WKV, bh, n, d, scale,      \
                     (cudaStream_t)stream, (const T*)q, (const T*)k, (const T*)v,          \
                     (const T*)dout, l, delta, (T*)dk, (T*)dv)                             \
       : run_wide(dkv_wide_tc_kernel<T>, dkv_wide_tc_smem<T>(), CL_ROWS, WT_G * WO,       \
                  NT_WKV, bh, n, d, scale, (cudaStream_t)stream, (const T*)q, (const T*)k, \
                  (const T*)v, (const T*)dout, l, delta, (T*)dk, (T*)dv))
  ATT_DISPATCH(d, bf, CALL, WIDE)
#undef WIDE
#undef CALL
}

namespace {
template <typename... K>
int occupancy(void (*kern)(K...), size_t smem, int threads, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
}

template <typename... K>
int max_clusters(void (*kern)(K...), size_t smem, int threads, int parts, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(attr, (unsigned)(parts * 1024), threads, smem,
                                                parts, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}
}  // namespace

// The most clusters of `parts` blocks of the forward (kind 0), dK/dV (1) or
// dQ (2) cluster body, in bf16 or f32, that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
ATT_EXPORT int attention_wide_clusters(int kind, int bf, int parts, int* clusters) {
  if (parts < 1 || parts > CL_MAX) return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  switch (kind) {
    case 0:
      return bf ? max_clusters(fwd_wide_kernel<B>, fwd_wide_smem<B>(), NT_TC, parts, clusters)
                : max_clusters(fwd_wide_kernel<float>, fwd_wide_smem<float>(), NT_TC, parts,
                               clusters);
    case 1:
      return bf ? max_clusters(dkv_wide_kernel<B>, dkv_wide_smem<B>(), NT_WKV, parts, clusters)
                : max_clusters(dkv_wide_kernel<float>, dkv_wide_smem<float>(), NT_WKV, parts,
                               clusters);
    case 2:
      return bf ? max_clusters(dq_wide_kernel<B>, dq_wide_smem<B>(), NT_WKV, parts, clusters)
                : max_clusters(dq_wide_kernel<float>, dq_wide_smem<float>(), NT_WKV, parts,
                               clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most blocks of the split-TF32 forward (kind 0), dK/dV (1) or dQ (2)
// body of head dims 160-256 at padded head dim dp (160, 192 or 256) that one
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks, and its threads a block into *threads.
ATT_EXPORT int attention_tf32w_blocks(int kind, int dp, int* blocks, int* threads) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  *threads = kind == 0 ? 4 * TW_ROWS : kind == 1 ? NT_WKV : 4 * DQW_ROWS;
#define TF32W_OCC(DP)                                                                        \
  (kind == 0   ? occupancy(fwd_tf32w_kernel<DP>, fwd_tf32w_smem<DP>(), *threads, blocks)     \
   : kind == 1 ? occupancy(dkv_tf32w_kernel<DP>, dkv_tf32w_smem<DP>(), *threads, blocks)     \
               : occupancy(dq_tf32w_kernel<DP>, dq_tf32w_smem<DP>(), *threads, blocks))
  switch (dp) {
    case 160:
      return TF32W_OCC(160);
    case 192:
      return TF32W_OCC(192);
    case 256:
      return TF32W_OCC(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TF32W_OCC
}
