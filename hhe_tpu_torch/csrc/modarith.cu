// Modular arithmetic on RNS residues for Hopper (sm_90a): the elementwise
// Montgomery product (K3, `mont_mul` / `mont_mul_lazy`), the Montgomery
// multiply-accumulate over one axis (K4, `mont_mac`), the modular add /
// sub / neg and the three-subtract reduction (K5, `mod_elem`), and the
// divide-and-round by the special prime (K6, `mod_down`).
//
// K5 and K6 stand for the XLA fusions of hhe_tpu/ops/modular.py `add_mod` /
// `sub_mod` / `neg_mod`, hhe_tpu/ops/rns.py `reduce_u32` and
// hhe_tpu/ops/bfv_eval.py `mod_down`, and for what the JAX package does
// around them: the galois gathers (`jnp.take` + `neg_mod` + `jnp.where` of
// `apply_galois` and the BSGS matmul), the chained `add_mod` sums of the
// giantsteps, BEHZ's centred `jnp.where` lifts, and the `add_mod` +
// `jnp.stack` after a key-switch.  Their plain versions are ops/modular.py
// `add_mod_plain` / `sub_mod_plain` / `neg_mod_plain` / `gather_mod_plain` /
// `sum_mod_plain`, ops/rns.py `reduce_u32_plain` / `center_lift_plain` and
// ops/bfv_eval.py `mod_down_plain`.  Both are bound by their bytes (a few
// integer ops a word): each operand word is read once and each output word
// written once, 16 bytes at a time where the rows allow.  K5 writes a
// broadcast output (a digit decomposition: every limb reduced modulo every
// modulus, larger than its input) from one read of the input row a thread,
// walking the moduli itself; its fused form (mod_fused_kernel, apart so
// that the elementwise layouts keep their registers and occupancy) reads
// an operand through an int32 index
// (one uncoalesced __ldg a word, coalesced 16-byte stores), keeping a
// broadcast index and sign mask in registers for every row it walks, and
// sums an axis exactly in u64.  K6 reads c's special-prime row, and a
// gathered addend's index and mask, once for all k limbs of a word, adds up
// to two addends (one of them read through the galois permutation) and
// writes into the caller's stacked output.  Where a launch has too few
// blocks to fill the card (one ciphertext), both split the rows a thread
// walks over the grid's third axis.  One launch replaces the 5-11 int64
// PyTorch passes of a plain call (29 for `mod_down`) and the gathers,
// wheres, stacks and adds around it.
//
// They stand for the XLA fusions that the JAX package gets from
// hhe_tpu/ops/modular.py `mont_mul` / `mont_mul_lazy` (one fused loop over a
// chain of 16-bit digit products) and `tree_add_mod(mont_mul(...))` (the
// key-switch, babystep/giantstep and base-conversion contractions): the JAX
// package has no Pallas kernel for them.  Their plain PyTorch versions are
// ops/modular.py `mont_mul_plain`, `mont_mul_lazy_plain` and
// `mont_mac_plain`, which they equal bit for bit.
//
// Arithmetic.  Residues are u32 bit patterns held in int32 (or int64, read
// as their low 32 bits); moduli q < 2^31 with qinv = -q^-1 mod 2^32.  REDC
// of a b (R = 2^32) is
//   t = hi(a b) + hi(m q) + (lo(a b) != 0),  m = lo(a b) qinv mod 2^32,
// in [0, 2q) whenever a b < q 2^32, the same formula and the same bits as
// the plain version.  K3 returns t (lazy) or t reduced once to [0, q)
// (eager).  Modular addition is exact, so K4 may sum its terms in any order
// and by any exact means: every form ends in the canonical residue in
// [0, q) that the plain version's log-depth tree of eager sums gives.
//
// Layout.  The wrapper (ops/mod_kernels.py) hands over the output's shape
// collapsed to MAXD dimensions, the output's strides over them, and for each
// of the four operands its element strides over those dimensions (0 where it
// is broadcast, never materialised) and along the reduction axis, or a
// scalar.  A warp's accesses of the innermost axis coalesce, with 16-byte
// loads and stores where every operand that runs along it does so
// contiguously and 16-byte aligned (the vector path), else one word a
// thread.  The wrapper picks the threads a block so that a launch has at
// least two blocks an SM wherever the output allows.
//
// K4 has four forms (the wrapper's `plan` picks one per layout):
// - general (the one-pass loop): a block takes one output row and 8 (4) words
//   of it a thread, a thread two groups of 4 consecutive words (four single
//   words); each thread walks the reduction axis with its sums in
//   registers, folding them below 2q after each term.  Where an operand is
//   broadcast over an output axis, it is read again for every output along
//   that axis: from L2 if it fits there, from HBM if it does not.
// - fanout: where one operand (S, operand 0 here) is broadcast over an
//   output axis (the fan-out, dimension 0 here) along which the other (W)
//   varies -- the BSGS key contraction's 31 babysteps times its k0/k1 pair,
//   a key-switch's k0/k1 pair, the BSGS plaintext sums' giantsteps -- a
//   block stages its tile of S, `terms` x tile words, in shared memory
//   once, then walks the fan-out streaming only W: S leaves HBM once a
//   launch.  A thread reads back only the words it staged, so no barrier
//   is needed.  W's loads are issued UNROLL terms at a time (4 x 16 bytes in
//   flight a thread).  Terms are hi(a b) - hi(m q) + q with m = lo(a b) q^-1
//   (no compare), summed exactly in u64 and reduced once an output word.
//   Where the fan-out is at most FAN_REG and the staged tile would not fit
//   128-thread blocks in 48 KB (the BSGS plaintext sums' 32 terms), the
//   sums stay in registers instead and nothing is staged (fanout_regs).
// - table: the fan-out form where W is constant along the innermost axis (a
//   base conversion's ka x kc constants, broadcast over words).  The block
//   loads the constants once into shared memory as Shoup pairs
//   (w = W mod q, floor(w 2^32 / q)); a term is then three 32-bit multiplies
//   and a 64-bit add (a w - floor(a w' / 2^32) q in [0, 2q) for any a <
//   2^32), and one REDC of the u64 sum gives sum_t a_t W_t 2^-32 mod q,
//   the plain version's residue.
//
// What bounds it.  Each term costs three 32-bit integer multiplies against
// 4-12 bytes of operands.  The general and fanout forms
// are bound by the bytes of their operands and output, read and written
// once; the table form streams no operand per term and is bound by its
// multiplies.  Tensor cores are no help for exact 31-bit modular products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 6;        // output dimensions after the wrapper's collapse
constexpr int NOPS = 4;        // a (or S), b (or W), q, qinv
constexpr int MAX_THREADS = 256;
constexpr int HEAD = 7;        // out, out64, lazy, terms, vec, form, threads
constexpr int DESC_WORDS = HEAD + NOPS * (4 + MAXD) + 2 * MAXD;
constexpr int UNROLL = 4;      // terms whose streamed loads a thread has in flight at once
constexpr int FAN_REG = 4;     // the most outputs FANOUT_REGS keeps sums of in registers
constexpr int SMEM_MAX = 227 * 1024;

enum Form { GENERAL = 0, FANOUT = 1, TABLE = 2, FANOUT_REGS = 3 };

struct Operand {
  const void* ptr;             // null: the scalar
  long long stride[MAXD];      // elements, over the output's dimensions
  long long rstride;           // elements, along the reduction axis
  unsigned int scalar;
  int is64;                    // int64 storage (else int32)
};

template <int NO>
struct ArgsT {
  Operand op[NO];
  void* out;
  long long terms;             // length of the reduction axis; 1 for K3
  long long rows;              // general: product of size[0 .. MAXD - 2]; fan-out: of size[1 .. MAXD - 2]
  unsigned int size[MAXD];
  long long ostride[MAXD];     // the output's element strides
  int out64;
  int lazy;                    // K3 only: leave [0, 2q)
};

using Args = ArgsT<NOPS>;

__device__ __forceinline__ uint32_t load(const Operand& o, long long i) {
  if (o.ptr == nullptr) return o.scalar;
  return o.is64 ? static_cast<uint32_t>(__ldg(static_cast<const long long*>(o.ptr) + i))
                : static_cast<uint32_t>(__ldg(static_cast<const int*>(o.ptr) + i));
}

// W consecutive words of the innermost axis from element i: one 16-byte
// load (two for int64) where the operand runs along that axis, one word
// repeated where it is broadcast over it
template <int W>
__device__ __forceinline__ void load_words(const Operand& o, long long i, uint32_t (&v)[W]) {
  if (W == 1 || o.ptr == nullptr || o.stride[MAXD - 1] == 0) {
    const uint32_t x = load(o, i);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = x;
  } else if (o.is64) {
    const long long* p = static_cast<const long long*>(o.ptr) + i;
#pragma unroll
    for (int h = 0; h < W / 2; ++h) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p) + h);
      v[2 * h] = static_cast<uint32_t>(x.x);
      v[2 * h + 1] = static_cast<uint32_t>(x.y);
    }
  } else {
    const int4 x = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(o.ptr) + i));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}

// V words to / from this thread's slot of the shared tile (16 bytes at once for V = 4)
template <int V>
__device__ __forceinline__ void put_words(uint32_t* p, const uint32_t (&v)[V]) {
  if (V == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[V > 1 ? 1 : 0], v[V > 2 ? 2 : 0], v[V > 3 ? 3 : 0]);
  else
    p[0] = v[0];
}

template <int V>
__device__ __forceinline__ void get_words(const uint32_t* p, uint32_t (&v)[V]) {
  if (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = x.x;
    v[V > 1 ? 1 : 0] = x.y;
    v[V > 2 ? 2 : 0] = x.z;
    v[V > 3 ? 3 : 0] = x.w;
  } else {
    v[0] = p[0];
  }
}

// V output words at element i of `out` (int64 if out64, else int32; 16
// bytes at once for V = 4 into int32)
template <int V>
__device__ __forceinline__ void store_words(void* out, int out64, long long i, const uint32_t (&v)[V]) {
  if (out64) {
#pragma unroll
    for (int w = 0; w < V; ++w) static_cast<long long*>(out)[i + w] = static_cast<long long>(v[w]);
  } else if (V == 4) {
    *reinterpret_cast<int4*>(static_cast<int*>(out) + i) =
        make_int4(v[0], v[V > 1 ? 1 : 0], v[V > 2 ? 2 : 0], v[V > 3 ? 3 : 0]);
  } else {
    static_cast<int*>(out)[i] = static_cast<int>(v[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_words(const Args& g, long long i, const uint32_t (&v)[V]) {
  store_words<V>(g.out, g.out64, i, v);
}

// a b 2^-32 mod q in [0, 2q) when a b < q 2^32 (the plain version's _redc)
__device__ __forceinline__ uint64_t redc(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(ab);
  const uint32_t m = lo * qinv;
  return (ab >> 32) + __umulhi(m, q) + (lo != 0u ? 1u : 0u);
}

// a b 2^-32 mod q in (0, 2q) when a b < q 2^32, as hi(a b) - hi(m q) + q with
// m = lo(a b) q^-1 mod 2^32 (qpos = q^-1): lo(m q) = lo(a b), so the low
// halves cancel exactly and no compare is needed
__device__ __forceinline__ uint32_t mont_term(uint32_t a, uint32_t b, uint32_t q, uint32_t qpos) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(ab) * qpos;
  return static_cast<uint32_t>(ab >> 32) - __umulhi(m, q) + q;
}

// x mod q for x < 2^53 and q > 2 (qrec = 1 / q rounded): the quotient in
// double precision is off by at most one
__device__ __forceinline__ uint32_t mod_q(uint64_t x, uint32_t q, double qrec) {
  const uint64_t quo = static_cast<uint64_t>(static_cast<double>(x) * qrec);
  long long r = static_cast<long long>(x - quo * q);
  if (r < 0)
    r += q;
  else if (r >= static_cast<long long>(q))
    r -= q;
  return static_cast<uint32_t>(r);
}

// x 2^-32 mod q in [0, q) for x < q 2^32 (REDC of a u64 sum; qinv = -q^-1)
__device__ __forceinline__ uint32_t redc64(uint64_t x, uint32_t q, uint32_t qinv) {
  const uint32_t m = static_cast<uint32_t>(x) * qinv;
  const uint64_t t = (x + static_cast<uint64_t>(m) * q) >> 32;
  return static_cast<uint32_t>(t >= q ? t - q : t);
}

// The offsets of row `row` of dimensions 1 .. MAXD - 2 (the fan-out forms)
template <int NO>
__device__ __forceinline__ void fan_row(const ArgsT<NO>& g, long long row, long long (&off)[NO],
                                        long long& ooff) {
  unsigned int r = static_cast<unsigned int>(row);
#pragma unroll
  for (int d = MAXD - 2; d >= 1; --d) {
    if (g.size[d] > 1) {
      const unsigned int c = r % g.size[d];
      r /= g.size[d];
#pragma unroll
      for (int o = 0; o < NO; ++o) off[o] += c * g.op[o].stride[d];
      ooff += c * g.ostride[d];
    }
  }
}

// The general form (and K3).  A thread takes GROUPS groups of W consecutive
// words, blockDim.x * W words apart.  W = 4: every group is 16-byte aligned
// and inner % 4 == 0 (the wrapper checks), so a group lies wholly inside the
// row or outside it.
template <int W, int GROUPS>
__global__ void __launch_bounds__(MAX_THREADS) mont_kernel(const Args g) {
  const long long SPAN = static_cast<long long>(blockDim.x) * W;  // words between a thread's loads
  const unsigned int inner = g.size[MAXD - 1];
  const long long j0 = static_cast<long long>(blockIdx.x) * (SPAN * GROUPS) + threadIdx.x * W;
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    long long off[NOPS] = {0, 0, 0, 0};
    unsigned int r = static_cast<unsigned int>(row);
#pragma unroll
    for (int d = MAXD - 2; d >= 0; --d) {
      if (g.size[d] > 1) {
        const unsigned int c = r % g.size[d];
        r /= g.size[d];
#pragma unroll
        for (int o = 0; o < NOPS; ++o) off[o] += c * g.op[o].stride[d];
      }
    }
#pragma unroll
    for (int o = 0; o < NOPS; ++o) off[o] += j0 * g.op[o].stride[MAXD - 1];

    uint64_t acc[GROUPS][W];
    uint32_t q[GROUPS][W], qinv[GROUPS][W];
#pragma unroll
    for (int e = 0; e < GROUPS; ++e) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        acc[e][w] = 0;
        q[e][w] = 1;
        qinv[e][w] = 0;
      }
      const long long step = e * SPAN;
      if (j0 + step < inner) {
        uint32_t a[W], b[W];
        load_words<W>(g.op[2], off[2] + step * g.op[2].stride[MAXD - 1], q[e]);
        load_words<W>(g.op[3], off[3] + step * g.op[3].stride[MAXD - 1], qinv[e]);
        load_words<W>(g.op[0], off[0] + step * g.op[0].stride[MAXD - 1], a);
        load_words<W>(g.op[1], off[1] + step * g.op[1].stride[MAXD - 1], b);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[e][w] = redc(a[w], b[w], q[e][w], qinv[e][w]);
      }
    }
#pragma unroll 2
    for (long long t = 1; t < g.terms; ++t) {
#pragma unroll
      for (int e = 0; e < GROUPS; ++e) {
        const long long step = e * SPAN;
        if (j0 + step < inner) {
          uint32_t a[W], b[W];
          load_words<W>(g.op[0], off[0] + step * g.op[0].stride[MAXD - 1] + t * g.op[0].rstride, a);
          load_words<W>(g.op[1], off[1] + step * g.op[1].stride[MAXD - 1] + t * g.op[1].rstride, b);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc[e][w] += redc(a[w], b[w], q[e][w], qinv[e][w]);
            const uint64_t q2 = 2ull * q[e][w];
            if (acc[e][w] >= q2) acc[e][w] -= q2;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < GROUPS; ++e) {
      const long long j = j0 + e * SPAN;
      if (j < inner) {
        uint32_t v[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint64_t x = acc[e][w];
          if (!g.lazy && x >= q[e][w]) x -= q[e][w];
          v[w] = static_cast<uint32_t>(x);
        }
        store_words<W>(g, row * inner + j, v);
      }
    }
  }
}

// floor(w 2^32 / q) for w < q < 2^31 (Shoup's companion of w): a quotient
// in double precision, corrected by one
__device__ __forceinline__ uint32_t shoup_companion(uint32_t w, uint32_t q) {
  const uint64_t x = static_cast<uint64_t>(w) << 32;
  uint64_t c = static_cast<uint64_t>(static_cast<double>(x) * __drcp_rn(static_cast<double>(q)));
  const long long r = static_cast<long long>(x - c * q);
  if (r < 0)
    --c;
  else if (r >= static_cast<long long>(q))
    ++c;
  return static_cast<uint32_t>(c);
}

// a w mod q in [0, 2q) for w < q and wp = floor(w 2^32 / q), any a < 2^32 (Shoup)
__device__ __forceinline__ uint32_t shoup_term(uint32_t a, uint32_t w, uint32_t wp, uint32_t q) {
  return a * w - __umulhi(a, wp) * q;
}

// The fanout and table forms of K4.  Operand 0 (S) is broadcast over
// dimension 0 (the fan-out, F = size[0]), operand 1 (W) varies along it; q
// and qinv are constant along the innermost axis.  A block takes one row of
// dimensions 1 .. MAXD - 2 and blockDim.x * V words of the innermost axis
// (a one-dimensional grid, rows fastest, so that blocks that re-read W's
// tile -- rows W is broadcast over, the fastest of them -- run together and
// find it in L2); it stages S's `terms` x V words a thread in shared memory
// (a slot no other thread reads), then for each of the F outputs sums the
// terms against W.
// TAB: W is constant along the innermost axis; the block loads its F x
// terms values into shared memory as Shoup pairs, with the F moduli, for
// each (row, tile) it takes (one, unless the grid's 2^30 blocks run out).
template <int V, bool TAB>
__global__ void __launch_bounds__(MAX_THREADS) mont_fan_kernel(const Args g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nthr = blockDim.x;
  const int terms = static_cast<int>(g.terms);
  const unsigned int F = g.size[0];
  const unsigned int inner = g.size[MAXD - 1];
  const Operand& S = g.op[0];
  const Operand& W = g.op[1];
  const Operand& Q = g.op[2];
  const Operand& QI = g.op[3];
  const int tstride = nthr * V;                       // words between a thread's terms
  uint32_t* const mine = smem + threadIdx.x * V;      // term t at mine[t * tstride]
  uint2* const tab = reinterpret_cast<uint2*>(smem + terms * tstride);  // [F][terms] (w, w')
  uint2* const qtab = tab + F * terms;                                   // [F] (q, qinv)
  const long long tiles = (inner + tstride - 1) / tstride;

  for (long long blk = blockIdx.x; blk < g.rows * tiles; blk += gridDim.x) {
    const long long j = (blk / g.rows) * tstride + threadIdx.x * V;
    const bool active = j < inner;
    long long off[NOPS] = {0, 0, 0, 0};
    long long ooff = j;
    fan_row(g, blk % g.rows, off, ooff);
    if (active) {
      const long long s0 = off[0] + j * S.stride[MAXD - 1];
      int t = 0;
      for (; t + UNROLL <= terms; t += UNROLL) {
        uint32_t v[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) load_words<V>(S, s0 + (t + u) * S.rstride, v[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) put_words<V>(mine + (t + u) * tstride, v[u]);
      }
      for (; t < terms; ++t) {
        uint32_t v[V];
        load_words<V>(S, s0 + t * S.rstride, v);
        put_words<V>(mine + t * tstride, v);
      }
    }
    if (TAB) {
      __syncthreads();  // every thread is done with the previous table
      for (int e = threadIdx.x; e < static_cast<int>(F) * terms; e += nthr) {
        const int f = e / terms, t = e - f * terms;
        const uint32_t q = load(Q, off[2] + f * Q.stride[0]);
        const uint32_t w = load(W, off[1] + f * W.stride[0] + t * W.rstride) % q;
        tab[e] = make_uint2(w, shoup_companion(w, q));
      }
      for (int f = threadIdx.x; f < static_cast<int>(F); f += nthr)
        qtab[f] = make_uint2(load(Q, off[2] + f * Q.stride[0]), load(QI, off[3] + f * QI.stride[0]));
      __syncthreads();
    }
    if (!active) continue;
    for (unsigned int f = 0; f < F; ++f) {
      uint64_t acc[V];
#pragma unroll
      for (int w = 0; w < V; ++w) acc[w] = 0;
      uint32_t res[V];
      if (TAB) {
        const uint2 qq = qtab[f];
        const uint2* tf = tab + f * terms;
#pragma unroll 4
        for (int t = 0; t < terms; ++t) {
          uint32_t s[V];
          get_words<V>(mine + t * tstride, s);
          const uint2 c = tf[t];
#pragma unroll
          for (int w = 0; w < V; ++w) acc[w] += shoup_term(s[w], c.x, c.y, qq.x);
        }
#pragma unroll
        for (int w = 0; w < V; ++w) res[w] = redc64(acc[w], qq.x, qq.y);
      } else {
        const uint32_t q = load(Q, off[2] + f * Q.stride[0]);
        const uint32_t qpos = 0u - load(QI, off[3] + f * QI.stride[0]);
        const long long w0 = off[1] + f * W.stride[0] + j * W.stride[MAXD - 1];
        int t = 0;
        for (; t + UNROLL <= terms; t += UNROLL) {
          uint32_t v[UNROLL][V];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) load_words<V>(W, w0 + (t + u) * W.rstride, v[u]);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            uint32_t s[V];
            get_words<V>(mine + (t + u) * tstride, s);
#pragma unroll
            for (int w = 0; w < V; ++w) acc[w] += mont_term(s[w], v[u][w], q, qpos);
          }
        }
        for (; t < terms; ++t) {
          uint32_t v[V], s[V];
          load_words<V>(W, w0 + t * W.rstride, v);
          get_words<V>(mine + t * tstride, s);
#pragma unroll
          for (int w = 0; w < V; ++w) acc[w] += mont_term(s[w], v[w], q, qpos);
        }
        const double qrec = __drcp_rn(static_cast<double>(q));
#pragma unroll
        for (int w = 0; w < V; ++w) res[w] = mod_q(acc[w], q, qrec);
      }
      store_words<V>(g, ooff + f * g.ostride[0], res);
    }
  }
}

// The fanout form for a fan-out of at most FAN_REG outputs whose staged
// tile would not fit (form FANOUT_REGS): nothing staged.  A thread loads
// each term's S words once and multiplies them into all F sums, kept in
// registers, with the term's 1 + F loads in flight.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS, 2) mont_fan_reg_kernel(const Args g) {
  const int terms = static_cast<int>(g.terms);
  const int F = static_cast<int>(g.size[0]);
  const unsigned int inner = g.size[MAXD - 1];
  const Operand& S = g.op[0];
  const Operand& W = g.op[1];
  const int tstride = blockDim.x * V;
  const long long tiles = (inner + tstride - 1) / tstride;

  for (long long blk = blockIdx.x; blk < g.rows * tiles; blk += gridDim.x) {
    const long long j = (blk / g.rows) * tstride + threadIdx.x * V;
    if (j >= inner) continue;
    long long off[NOPS] = {0, 0, 0, 0};
    long long ooff = j;
    fan_row(g, blk % g.rows, off, ooff);
    uint32_t q[FAN_REG], qpos[FAN_REG];
    uint64_t acc[FAN_REG][V];
#pragma unroll
    for (int f = 0; f < FAN_REG; ++f) {
      q[f] = f < F ? load(g.op[2], off[2] + f * g.op[2].stride[0]) : 1u;
      qpos[f] = f < F ? 0u - load(g.op[3], off[3] + f * g.op[3].stride[0]) : 1u;
#pragma unroll
      for (int w = 0; w < V; ++w) acc[f][w] = 0;
    }
    const long long s0 = off[0] + j * S.stride[MAXD - 1];
    const long long w0 = off[1] + j * W.stride[MAXD - 1];
    for (int t = 0; t < terms; ++t) {
      uint32_t s[V], v[FAN_REG][V];
      load_words<V>(S, s0 + t * S.rstride, s);
#pragma unroll
      for (int f = 0; f < FAN_REG; ++f)
        if (f < F) load_words<V>(W, w0 + f * W.stride[0] + t * W.rstride, v[f]);
#pragma unroll
      for (int f = 0; f < FAN_REG; ++f) {
        if (f < F) {
#pragma unroll
          for (int w = 0; w < V; ++w) acc[f][w] += mont_term(s[w], v[f][w], q[f], qpos[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FAN_REG; ++f) {
      if (f < F) {
        const double qrec = __drcp_rn(static_cast<double>(q[f]));
        uint32_t res[V];
#pragma unroll
        for (int w = 0; w < V; ++w) res[w] = mod_q(acc[f][w], q[f], qrec);
        store_words<V>(g, ooff + f * g.ostride[0], res);
      }
    }
  }
}

// K5: one modular elementwise op on u32 words, the JAX package's
// add_mod / sub_mod / neg_mod (hhe_tpu/ops/modular.py) and reduce_u32
// (hhe_tpu/ops/rns.py), in the same u32 arithmetic; CENTER lifts a residue
// x mod m, taken as centred (x > h: x - m), to q: the jnp.where of BEHZ's
// hhe_tpu/ops/bfv_eval.py `_to_bsk` / `_bsk_to_q` (b = m mod q); COPY
// passes the (gathered, signed) operand through
enum ElemOp { ADD = 0, SUB = 1, NEG = 2, REDUCE = 3, CENTER = 4, COPY = 5 };

__device__ __forceinline__ uint32_t mod_elem(int op, uint32_t a, uint32_t b, uint32_t q, uint32_t h = 0u) {
  if (op == ADD) {
    const uint32_t s = a + b;
    return s >= q ? s - q : s;
  }
  if (op == SUB) return a >= b ? a - b : a + q - b;
  if (op == NEG) return a == 0u ? a : q - a;
  if (op == COPY) return a;
  uint32_t r = a;  // REDUCE: exactly three conditional subtracts
#pragma unroll
  for (int i = 0; i < 3; ++i) r = r >= q ? r - q : r;
  if (op == CENTER && a > h) r = r >= b ? r - b : r + q - b;
  return r;
}

// K5's operands: a, b, q, h (CENTER's threshold, a scalar), the int32 index
// a is read through along the innermost axis, and the bool mask of the
// words negated mod q after the read
constexpr int NELEM = 6;
enum ElemOperand { EA = 0, EB = 1, EQ = 2, EH = 3, EIDX = 4, ESIGN = 5 };
constexpr int ELEM_DESC_WORDS = HEAD + NELEM * (4 + MAXD) + 2 * MAXD;
using ElemArgs = ArgsT<NELEM>;

// W words of bool mask S from element i (one byte a word)
template <int W>
__device__ __forceinline__ void load_sign(const Operand& S, long long i, uint32_t (&v)[W]) {
  const unsigned char* p = static_cast<const unsigned char*>(S.ptr) + i;
  const bool bcast = S.stride[MAXD - 1] == 0;
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = __ldg(p + (bcast ? 0 : w));
}

// W words of a at row offset `off`: through the index ix where a is
// gathered (one load a word: the uncoalesced side), else words j0 ..
// j0 + W - 1 of the row; negated mod q where the mask sg is set
template <int W>
__device__ __forceinline__ void load_a(const Operand& A, long long off, long long j0, bool gathered,
                                       const uint32_t (&ix)[W], bool sgn, const uint32_t (&sg)[W],
                                       const uint32_t (&q)[W], uint32_t (&v)[W]) {
  if (gathered) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = load(A, off + static_cast<long long>(ix[w]) * A.stride[MAXD - 1]);
  } else {
    load_words<W>(A, off + j0 * A.stride[MAXD - 1], v);
  }
  if (sgn) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (sg[w]) v[w] = mod_elem(NEG, v[w], 0u, q[w]);
  }
}

// K5, an elementwise op.  Operands a, b, q and h (kernel operands 0-3).  A
// thread takes W consecutive words of the innermost axis of one row of
// dimensions 1 .. MAXD - 2 (blockIdx.y, rows) and walks dimension 0, the
// fan-out, at blockIdx.z, blockIdx.z + gridDim.z, ...: where a and b are
// broadcast over it (a digit decomposition: one limb reduced modulo every
// modulus), it reads them once and writes one output row a modulus.  Any
// other layout has a fan-out of 1.  Kept apart from mod_fused_kernel, whose
// index, mask and terms would cost these layouts registers and occupancy.
template <int W>
__global__ void __launch_bounds__(MAX_THREADS) mod_elem_kernel(const Args g, int op) {
  const unsigned int inner = g.size[MAXD - 1];
  const unsigned int F = g.size[0];
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (j >= inner) return;
  const Operand& A = g.op[0];
  const Operand& Bo = g.op[1];
  const Operand& Q = g.op[2];
  const uint32_t h = g.op[3].scalar;
  const unsigned int f0 = blockIdx.z;
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    long long off[NOPS] = {0, 0, 0, 0};
    long long ooff = j;
    fan_row(g, row, off, ooff);
#pragma unroll
    for (int o = 0; o < 3; ++o) off[o] += j * g.op[o].stride[MAXD - 1];
    uint32_t a[W], b[W];
    load_words<W>(A, off[0] + f0 * A.stride[0], a);
    load_words<W>(Bo, off[1] + f0 * Bo.stride[0], b);
    for (unsigned int f = f0; f < F; f += gridDim.z) {
      if (f != f0 && A.stride[0] != 0) load_words<W>(A, off[0] + f * A.stride[0], a);
      if (f != f0 && Bo.stride[0] != 0) load_words<W>(Bo, off[1] + f * Bo.stride[0], b);
      uint32_t q[W], r[W];
      load_words<W>(Q, off[2] + f * Q.stride[0], q);
#pragma unroll
      for (int w = 0; w < W; ++w) r[w] = mod_elem(op, a[w], b[w], q[w], h);
      store_words<W>(g, ooff + f * g.ostride[0], r);
    }
  }
}

// K5 with a read through an index, a sign mask or a sum (ElemArgs: the
// elementwise kernel's operands, the index and the mask).  The walk is
// mod_elem_kernel's; where the index and mask are broadcast over the
// fan-out (a galois permutation of every limb), a thread keeps their words
// in registers for every row it walks.  With g.terms > 1 (ADD only: a sum
// over an axis) each output word is b plus the sum of a's terms along that
// axis (each term gathered and signed through its own index row where the
// index varies along it), taken exactly in u64 and reduced once.
template <int W>
__global__ void __launch_bounds__(MAX_THREADS) mod_fused_kernel(const ElemArgs g, int op) {
  const unsigned int inner = g.size[MAXD - 1];
  const unsigned int F = g.size[0];
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (j >= inner) return;
  const Operand& A = g.op[EA];
  const Operand& Bo = g.op[EB];
  const Operand& Q = g.op[EQ];
  const Operand& X = g.op[EIDX];
  const Operand& S = g.op[ESIGN];
  const bool gathered = X.ptr != nullptr;
  const bool sgn = S.ptr != nullptr;
  const uint32_t h = g.op[EH].scalar;
  const int terms = static_cast<int>(g.terms);
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    long long off[NELEM] = {0, 0, 0, 0, 0, 0};
    long long ooff = j;
    fan_row(g, row, off, ooff);
#pragma unroll
    for (int o = 1; o < NELEM; ++o) off[o] += j * g.op[o].stride[MAXD - 1];
    uint32_t a[W], b[W], ix[W], sg[W];
#pragma unroll
    for (int w = 0; w < W; ++w) ix[w] = sg[w] = 0u;
    bool first = true;
    for (unsigned int f = blockIdx.z; f < F; f += gridDim.z, first = false) {
      uint32_t q[W], r[W];
      load_words<W>(Q, off[EQ] + f * Q.stride[0], q);
      if (first || Bo.stride[0] != 0) load_words<W>(Bo, off[EB] + f * Bo.stride[0], b);
      if (terms == 1) {
        const bool newix = gathered && (first || X.stride[0] != 0);
        const bool newsg = sgn && (first || S.stride[0] != 0);
        if (newix) load_words<W>(X, off[EIDX] + f * X.stride[0], ix);
        if (newsg) load_sign<W>(S, off[ESIGN] + f * S.stride[0], sg);
        if (first || A.stride[0] != 0 || newix || newsg || (sgn && Q.stride[0] != 0))
          load_a<W>(A, off[EA] + f * A.stride[0], j, gathered, ix, sgn, sg, q, a);
#pragma unroll
        for (int w = 0; w < W; ++w) r[w] = mod_elem(op, a[w], b[w], q[w], h);
      } else {
        uint64_t acc[W];
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = b[w];
        for (int t = 0; t < terms; ++t) {
          if (gathered) load_words<W>(X, off[EIDX] + f * X.stride[0] + t * X.rstride, ix);
          if (sgn) load_sign<W>(S, off[ESIGN] + f * S.stride[0] + t * S.rstride, sg);
          load_a<W>(A, off[EA] + f * A.stride[0] + t * A.rstride, j, gathered, ix, sgn, sg, q, a);
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += a[w];
        }
#pragma unroll
        for (int w = 0; w < W; ++w) r[w] = mod_q(acc[w], q[w], __drcp_rn(static_cast<double>(q[w])));
      }
      store_words<W>(g.out, g.out64, ooff + f * g.ostride[0], r);
    }
  }
}

// K6: divide-and-round by the special prime P, the JAX package's
// bfv_eval.mod_down (hhe_tpu/ops/bfv_eval.py), fused.  For limb i < k and
// word n of c [..., k + 1, N] (row k: the residues mod P):
//   a1 = reduce(xp, q_i), xp = c[k, n];
//   fix = xp > p_half ? sub_mod(a1, P mod q_i, q_i) : a1;
//   out[i, n] = mont_mul(sub_mod(c[i, n], fix, q_i), Mont(P^-1 mod q_i)),
// plus, mod q_i, up to NADD addends in the output rows each covers: the
// add_mod after a key-switch (apply_galois' permuted c0, relinearize's c0
// and c1, a rotation's running sum), each addend read directly or through
// an [N] index and sign mask (the galois permutation of apply_galois'
// c0).  The output is [..., k, N], contiguous, fresh or the caller's slice
// (the torch.stack of d0 and d1).
constexpr int MAXL = MAXD - 2;  // c's leading dimensions after the wrapper's collapse
constexpr int NCOLS = 4;        // q, qinv, P mod q, Mont(P^-1 mod q): [k] columns
constexpr int NADD = 2;         // addends an output row may have
constexpr int DOWN_HEAD = 9;    // out, out64, vec, threads, zsplit, k, inner, limb stride, p_half
constexpr int ADD_WORDS = 8 + MAXL;  // ptr, is64, inner stride, limb stride, rows, idx, sign, spare, lead strides
constexpr int DOWN_DESC_WORDS = DOWN_HEAD + 3 + 2 * MAXL + 3 * NCOLS + NADD * ADD_WORDS;

struct Addend {
  Operand x;                   // null: none; stride[MAXD - 1] along the innermost axis
  Operand idx;                 // int32 [N] read through, or null
  Operand sign;                // bool [N] negate mask, or null
  long long lead_stride[MAXL];
  long long limb_stride;
  long long rows;              // covers the output's leading rows 0 .. rows - 1
};

struct DownArgs {
  Operand c;                   // stride[MAXD - 1]: along the innermost axis
  Operand col[NCOLS];          // stride[0]: along the limbs
  Addend add[NADD];
  void* out;                   // [..., k, N], contiguous
  long long lead_size[MAXL];
  long long lead_stride[MAXL];
  long long limb_stride;       // c's, between limbs
  long long rows;              // product of lead_size
  unsigned int k;
  unsigned int inner;
  unsigned int p_half;
  int out64;
};

// A thread takes W consecutive words of one leading row (blockIdx.y, rows)
// and walks the limbs blockIdx.z, blockIdx.z + gridDim.z, ...: it reads the
// P row's words and a gathered addend's index and mask once, each limb's
// words once, and writes each output word once.  The wrapper splits the
// limbs over gridDim.z where the rows and words alone would give too few
// blocks to fill the card (one ciphertext's key-switch: one limb a block).
template <int W>
__global__ void __launch_bounds__(MAX_THREADS) mod_down_kernel(const DownArgs g) {
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (j >= g.inner) return;
  const long long istride = g.c.stride[MAXD - 1];
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    long long coff = j * istride;
    long long aoff[NADD] = {0, 0};
    unsigned int r = static_cast<unsigned int>(row);
#pragma unroll
    for (int d = MAXL - 1; d >= 0; --d) {
      const unsigned int size = static_cast<unsigned int>(g.lead_size[d]);
      if (size > 1) {
        const unsigned int c = r % size;
        coff += c * g.lead_stride[d];
#pragma unroll
        for (int e = 0; e < NADD; ++e) aoff[e] += c * g.add[e].lead_stride[d];
        r /= size;
      }
    }
    bool has[NADD];
    uint32_t ix[NADD][W], sg[NADD][W];
#pragma unroll
    for (int e = 0; e < NADD; ++e) {
      const Addend& ad = g.add[e];
      has[e] = ad.x.ptr != nullptr && row < ad.rows;
#pragma unroll
      for (int w = 0; w < W; ++w) ix[e][w] = sg[e][w] = 0u;
      if (has[e] && ad.idx.ptr != nullptr) load_words<W>(ad.idx, j, ix[e]);
      if (has[e] && ad.sign.ptr != nullptr) load_sign<W>(ad.sign, j, sg[e]);
    }
    uint32_t xp[W];
    load_words<W>(g.c, coff + g.k * g.limb_stride, xp);
    const long long obase = row * g.k * g.inner + j;
#pragma unroll 2
    for (unsigned int i = blockIdx.z; i < g.k; i += gridDim.z) {
      const uint32_t q = load(g.col[0], i * g.col[0].stride[0]);
      const uint32_t qinv = load(g.col[1], i * g.col[1].stride[0]);
      const uint32_t pm = load(g.col[2], i * g.col[2].stride[0]);
      const uint32_t pinv = load(g.col[3], i * g.col[3].stride[0]);
      uint32_t c[W], res[W];
      load_words<W>(g.c, coff + i * g.limb_stride, c);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t a1 = mod_elem(REDUCE, xp[w], 0u, q);
        const uint32_t fix = xp[w] > g.p_half ? mod_elem(SUB, a1, pm, q) : a1;
        const uint64_t t = redc(mod_elem(SUB, c[w], fix, q), pinv, q, qinv);
        res[w] = static_cast<uint32_t>(t >= q ? t - q : t);
      }
#pragma unroll
      for (int e = 0; e < NADD; ++e) {
        if (!has[e]) continue;
        const Addend& ad = g.add[e];
        uint32_t qq[W], v[W];
#pragma unroll
        for (int w = 0; w < W; ++w) qq[w] = q;
        load_a<W>(ad.x, aoff[e] + i * ad.limb_stride, j, ad.idx.ptr != nullptr, ix[e],
                  ad.sign.ptr != nullptr, sg[e], qq, v);
#pragma unroll
        for (int w = 0; w < W; ++w) res[w] = mod_elem(ADD, res[w], v[w], q);
      }
      store_words<W>(g.out, g.out64, obase + static_cast<long long>(i) * g.inner, res);
    }
  }
}

// shared memory a fan-out block needs
long long fan_smem(int form, long long terms, long long fan, int threads, int v) {
  if (form == FANOUT_REGS) return 0;
  return 4 * terms * threads * v + (form == TABLE ? 8 * fan * terms + 8 * fan : 0);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, long long smem, cudaStream_t st, const Args& g) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, static_cast<size_t>(smem), st>>>(g);
  return cudaGetLastError();
}

// Runs launch_fn() with `device` current and leaves the caller's current
// device as it was; the launch's error code, else the first CUDA error
template <typename F>
int on_device(int device, F launch_fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = static_cast<int>(launch_fn());
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0) rc = static_cast<int>(err);
  }
  return rc;
}

// hhe_mont's and hhe_mod_elem's descriptor into g, but for g.rows; false
// if a size is out of range
template <int NO>
bool read_desc(const long long* desc, ArgsT<NO>& g) {
  g.out = reinterpret_cast<void*>(desc[0]);
  g.out64 = static_cast<int>(desc[1]);
  g.lazy = static_cast<int>(desc[2]);
  g.terms = desc[3];
  const long long* p = desc + HEAD;
  for (int o = 0; o < NO; ++o, p += 4 + MAXD) {
    g.op[o].ptr = reinterpret_cast<const void*>(p[0]);
    g.op[o].is64 = static_cast<int>(p[1]);
    g.op[o].scalar = static_cast<unsigned int>(p[2]);
    g.op[o].rstride = p[3];
    for (int d = 0; d < MAXD; ++d) g.op[o].stride[d] = p[4 + d];
  }
  for (int d = 0; d < MAXD; ++d) {
    if (p[d] < 1 || p[d] >= (1LL << 31)) return false;
    g.size[d] = static_cast<unsigned int>(p[d]);
    g.ostride[d] = p[MAXD + d];
  }
  return true;
}

dim3 row_grid(long long tiles, long long rows, long long z = 1) {
  return dim3(static_cast<unsigned int>(tiles), static_cast<unsigned int>(rows < 65535 ? rows : 65535),
              static_cast<unsigned int>(z));
}

}  // namespace

extern "C" {

// desc (DESC_WORDS int64): out, out64, lazy, terms, vec, form, threads;
// then for operands 0-3: ptr (0: scalar), is64, scalar, rstride,
// stride[MAXD]; then size[MAXD], then the output's ostride[MAXD].  vec:
// every operand that runs along the innermost axis does so contiguously
// from a 16-byte aligned word, with outer and reduction strides that are
// multiples of 4, and size[MAXD - 1] % 4 == 0 (the wrapper checks).
// General form (and K3): operands a, b, q, qinv, the output contiguous over
// size.  Fan-out forms: operand 0 is broadcast over dimension 0, which
// operand 1 varies along; q and qinv constant along the innermost axis.
// Launches on `device` and leaves the caller's current device as it was.
int hhe_mont(const long long* desc, int device, void* stream) {
  Args g;
  if (!read_desc(desc, g)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = desc[4] != 0;
  const int form = static_cast<int>(desc[5]);
  const int threads = static_cast<int>(desc[6]);
  g.rows = 1;
  for (int d = 0; d < MAXD - 1; ++d)
    if (form == GENERAL || d > 0) g.rows *= g.size[d];
  const bool fan = form != GENERAL;
  if (g.rows >= (1LL << 31) || g.terms < 1 || (g.lazy && g.terms != 1) ||
      (vec && g.size[MAXD - 1] % 4 != 0) || form < GENERAL || form > FANOUT_REGS ||
      (form == FANOUT_REGS && g.size[0] > FAN_REG) ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      (fan && (g.lazy || g.terms >= (1LL << 20) || g.op[0].ptr == nullptr ||
               g.op[0].stride[0] != 0 || g.op[2].stride[MAXD - 1] != 0 ||
               g.op[3].stride[MAXD - 1] != 0 ||
               (form == TABLE) != (g.op[1].stride[MAXD - 1] == 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = vec ? 4 : 1;
  const long long smem = fan ? fan_smem(form, g.terms, g.size[0], threads, v) : 0;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);

  const long long per_block = static_cast<long long>(threads) * (fan ? v : (vec ? 4 * 2 : 4));
  const long long tiles = (g.size[MAXD - 1] + per_block - 1) / per_block;
  const long long blocks = g.rows * tiles;
  const dim3 grid = fan ? dim3(static_cast<unsigned int>(blocks < (1LL << 30) ? blocks : (1LL << 30)))
                        : row_grid(tiles, g.rows);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (form == FANOUT_REGS)
      return vec ? launch(mont_fan_reg_kernel<4>, grid, threads, 0, st, g)
                 : launch(mont_fan_reg_kernel<1>, grid, threads, 0, st, g);
    if (form == FANOUT)
      return vec ? launch(mont_fan_kernel<4, false>, grid, threads, smem, st, g)
                 : launch(mont_fan_kernel<1, false>, grid, threads, smem, st, g);
    if (form == TABLE)
      return vec ? launch(mont_fan_kernel<4, true>, grid, threads, smem, st, g)
                 : launch(mont_fan_kernel<1, true>, grid, threads, smem, st, g);
    return vec ? launch(mont_kernel<4, 2>, grid, threads, 0, st, g)
               : launch(mont_kernel<1, 4>, grid, threads, 0, st, g);
  });
}

// K5.  desc (ELEM_DESC_WORDS int64): out, out64, 0, terms, vec, zsplit,
// threads; then hhe_mont's operand words for a, b, q, h, the index and the
// mask (ptr 0: a scalar, or none for the index and the mask); then
// size[MAXD] and the output's ostride[MAXD].  Dimension 0 is the fan-out,
// split over zsplit blocks; a is read through the index (its innermost
// stride scales the index) where one is given; terms > 1 only for ADD (a
// sum along the axis of the operands' rstrides).  vec: as hhe_mont's, a
// gathered a and the mask aside (read a word at a time).
int hhe_mod_elem(const long long* desc, int op, int device, void* stream) {
  ElemArgs g;
  if (!read_desc(desc, g)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = desc[4] != 0;
  const long long zsplit = desc[5];
  const int threads = static_cast<int>(desc[6]);
  g.rows = 1;
  for (int d = 1; d < MAXD - 1; ++d) g.rows *= g.size[d];
  if (g.rows >= (1LL << 31) || g.terms < 1 || g.terms >= (1LL << 20) || (g.terms > 1 && op != ADD) ||
      g.lazy || op < ADD || op > COPY || zsplit < 1 || zsplit > g.size[0] || zsplit > 65535 ||
      g.op[EA].ptr == nullptr || (g.op[EIDX].ptr != nullptr && g.op[EIDX].is64) ||
      (g.op[ESIGN].ptr != nullptr && g.op[ESIGN].is64) || (vec && g.size[MAXD - 1] % 4 != 0) ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(threads) * (vec ? 4 : 1);
  const dim3 grid = row_grid((g.size[MAXD - 1] + per_block - 1) / per_block, g.rows, zsplit);
  const auto st = static_cast<cudaStream_t>(stream);
  if (g.op[EIDX].ptr != nullptr || g.op[ESIGN].ptr != nullptr || g.terms > 1) {
    return on_device(device, [&]() {
      if (vec)
        mod_fused_kernel<4><<<grid, threads, 0, st>>>(g, op);
      else
        mod_fused_kernel<1><<<grid, threads, 0, st>>>(g, op);
      return cudaGetLastError();
    });
  }
  Args e;  // the elementwise op: the first NOPS operands
  for (int o = 0; o < NOPS; ++o) e.op[o] = g.op[o];
  e.out = g.out;
  e.terms = g.terms;
  e.rows = g.rows;
  for (int d = 0; d < MAXD; ++d) {
    e.size[d] = g.size[d];
    e.ostride[d] = g.ostride[d];
  }
  e.out64 = g.out64;
  e.lazy = g.lazy;
  return on_device(device, [&]() {
    if (vec)
      mod_elem_kernel<4><<<grid, threads, 0, st>>>(e, op);
    else
      mod_elem_kernel<1><<<grid, threads, 0, st>>>(e, op);
    return cudaGetLastError();
  });
}

// K6.  desc (DOWN_DESC_WORDS int64): out, out64, vec, threads, zsplit, k,
// inner, c's limb stride, p_half; c: ptr, is64, innermost stride; c's
// leading sizes[MAXL] and strides[MAXL] (the output's rows, in order); then
// for q, qinv, P mod q and Mont(P^-1 mod q): ptr, is64, stride along the
// limbs; then for each of the NADD addends: ptr (0: none), is64, innermost
// stride, limb stride, the leading rows it covers, the [N] int32 index and
// bool mask (0: none), 0, and its strides over c's leading sizes.  vec: c
// and every addend not read through an index run contiguously along the
// innermost axis from a 16-byte aligned word, with limb and leading strides
// that are multiples of 4, the output and the indices are 16-byte aligned,
// and inner % 4 == 0.
int hhe_mod_down(const long long* desc, int device, void* stream) {
  DownArgs g;
  g.out = reinterpret_cast<void*>(desc[0]);
  g.out64 = static_cast<int>(desc[1]);
  const bool vec = desc[2] != 0;
  const int threads = static_cast<int>(desc[3]);
  const long long zsplit = desc[4];
  const long long k = desc[5], inner = desc[6];
  g.limb_stride = desc[7];
  g.c = Operand{};
  g.c.ptr = reinterpret_cast<const void*>(desc[DOWN_HEAD]);
  g.c.is64 = static_cast<int>(desc[DOWN_HEAD + 1]);
  g.c.stride[MAXD - 1] = desc[DOWN_HEAD + 2];
  const long long* p = desc + DOWN_HEAD + 3;
  g.rows = 1;
  for (int d = 0; d < MAXL; ++d) {
    g.lead_size[d] = p[d];
    g.lead_stride[d] = p[MAXL + d];
    if (p[d] < 1 || p[d] >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    g.rows *= p[d];
  }
  p += 2 * MAXL;
  bool cols = true;
  for (int o = 0; o < NCOLS; ++o, p += 3) {
    g.col[o] = Operand{};
    g.col[o].ptr = reinterpret_cast<const void*>(p[0]);
    g.col[o].is64 = static_cast<int>(p[1]);
    g.col[o].stride[0] = p[2];
    cols = cols && p[0] != 0;
  }
  bool adds = true;
  for (int e = 0; e < NADD; ++e, p += ADD_WORDS) {
    Addend& ad = g.add[e];
    ad.x = Operand{};
    ad.idx = Operand{};
    ad.sign = Operand{};
    ad.x.ptr = reinterpret_cast<const void*>(p[0]);
    ad.x.is64 = static_cast<int>(p[1]);
    ad.x.stride[MAXD - 1] = p[2];
    ad.limb_stride = p[3];
    ad.rows = p[4];
    ad.idx.ptr = reinterpret_cast<const void*>(p[5]);
    ad.idx.stride[MAXD - 1] = 1;
    ad.sign.ptr = reinterpret_cast<const void*>(p[6]);
    ad.sign.stride[MAXD - 1] = 1;
    for (int d = 0; d < MAXL; ++d) ad.lead_stride[d] = p[8 + d];
    adds = adds && ad.rows >= 0 && ad.rows <= g.rows && (ad.x.ptr != nullptr || (p[5] == 0 && p[6] == 0));
  }
  if (k < 1 || k >= (1LL << 31) || inner < 1 || inner >= (1LL << 31) || g.rows >= (1LL << 31) ||
      desc[8] < 0 || desc[8] >= (1LL << 32) || g.c.ptr == nullptr || !cols || !adds || zsplit < 1 ||
      zsplit > k || zsplit > 65535 || (vec && (inner % 4 != 0 || g.c.stride[MAXD - 1] != 1)) ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  g.k = static_cast<unsigned int>(k);
  g.inner = static_cast<unsigned int>(inner);
  g.p_half = static_cast<unsigned int>(desc[8]);
  const long long per_block = static_cast<long long>(threads) * (vec ? 4 : 1);
  const dim3 grid = row_grid((inner + per_block - 1) / per_block, g.rows, zsplit);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (vec)
      mod_down_kernel<4><<<grid, threads, 0, st>>>(g);
    else
      mod_down_kernel<1><<<grid, threads, 0, st>>>(g);
    return cudaGetLastError();
  });
}

int hhe_mont_desc_words() { return DESC_WORDS; }

int hhe_mod_elem_desc_words() { return ELEM_DESC_WORDS; }

int hhe_mod_down_desc_words() { return DOWN_DESC_WORDS; }

const char* hhe_mont_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
