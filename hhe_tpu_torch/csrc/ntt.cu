// Negacyclic NTT over RNS limbs for Hopper (sm_90a): the forward and the
// inverse transform of every (batch row, limb) polynomial of an int32
// [..., k, N] tensor, modulo that limb's q < 2^31, for N = 2^5 ... 2^16.
//
// Replaces the TPU kernels hhe_tpu/ops/ntt_pallas.py `_fwd_kernel` (forward,
// natural -> bit-reversed order) and `_inv_kernel` (inverse, bit-reversed ->
// natural order, then the factor N^-1).  Output is the canonical residue in
// [0, q), bit-identical to the plain PyTorch stage loop in ops/ntt.py
// (ntt_fwd_plain / ntt_inv_plain), which it is tested against.
//
// Design.
// - Tiles.  The rows are cut into tiles of 2^14 words (one row at N = 16384,
//   16384 / N rows below it), each one contiguous 64 KB of the tensor.  A
//   persistent grid of one 1024-thread block per SM takes the tiles in turn
//   with two (forward) or three (inverse) tile buffers in shared memory:
//   thread 0 loads tile i+1 with one bulk copy (`cp.async.bulk`, the TMA's
//   1-D path, completing on an mbarrier) while the block transforms tile i,
//   and writes each finished tile back with one bulk store.  No thread
//   spends a load or store instruction on device memory except for the
//   twiddles.
// - Register passes.  Each thread holds 16 coefficients whose tile index
//   differs in 4 bits, and runs up to 4 butterfly stages on them in
//   registers (radix 16); then the block exchanges through shared memory.
//   The log2 N stages run as one radix-4 pass (the stages of distance 2 and
//   1, on 4 groups of 4 neighbours) and passes of 4 stages above it: for
//   N = 16384 four passes and six barriers per tile, where one stage per
//   barrier took 14.  Which tile bits a pass gives to the registers, the
//   lane and the warp is fixed at compile time (`make_pass`).  The lanes take
//   5 bits that map to 5 distinct banks: bits 0-4 where the stages leave them
//   free, and an exchange in natural order; otherwise bits that the XOR
//   swizzle of the exchange layout spreads.  No access has bank conflicts at
//   N = 16384.  The tile is in natural order whenever it meets a bulk copy;
//   the radix-4 pass moves 16 bytes per shared-memory access there.
// - Twiddles.  Each distinct twiddle of a pass is loaded once per thread, as
//   a Shoup pair (w, floor(w 2^32 / q)) from ntt.build_tables, two pairs per
//   16-byte load where neighbours: w*y mod q in [0, 2q) is then umulhi, mul,
//   mad, one multiply fewer than Montgomery's REDC and no carry.  The last
//   stages of a pass run depth first on groups of registers, so that their
//   many twiddles never wait in registers all at once (at 1024 threads a
//   thread has 64 registers).  Values stay in [0, 4q) (forward) or [0, 2q)
//   (inverse) between stages when every q < 2^30 (Harvey's lazy butterflies,
//   LAZY); the 31-bit BEHZ moduli keep them canonical.  K2's factor N^-1 is
//   folded into its last stage, whose one twiddle becomes two Shoup pairs
//   (N^-1 and ipsi_br[1] N^-1).
//
// What bounds it.  The transform must read and write 8N bytes per row and
// does (N/2) log2(N) butterflies.  A lazy butterfly is 7 integer
// instructions (3 multiplies), an eager one 9-11, so at N = 16384 a row costs
// about as many issue slots (14 * 8192 * 7 / 128 per clock per SM) as its
// 128 KB take at the SM's share of the HBM rate; the shared-memory exchange
// and the twiddle loads add to the issue side.  Both roofs are near, and the
// bulk copies overlapping the arithmetic are what lets the kernel approach
// the byte bound (PERF.md has its times beside the bound).  Launches with
// fewer tiles than SMs are bound by one block's latency for one tile.
// Tensor cores are no help: the work is exact 30-31-bit modular products,
// which int8 tensor cores would assemble from 16 byte products plus carries
// and a reduction, more instructions than the three integer multiplies they
// would replace.
//
// Rows longer than a tile (N = 2^15, 2^16: 128 and 256 KB, where a block
// may hold at most 227 KB of shared memory) take two launches.  The row is
// cut into P = N / 2^14 parts of 64 KB.  In the merged-psi order of the
// plain stage loop the log2 P stages of distance >= 2^14 mix the parts; all
// later forward stages stay inside one part, and the stage with m groups
// uses psi_br[m + g] = psi_br[(P + p) m' + g'] in part p (m' = m / P
// sub-groups, g' the sub-group).  So:
// - forward: the top pass (`ntt_fwd_top_kernel`) runs the log2 P stages
//   elementwise, each thread holding the P coefficients j, j + 2^14, ... of
//   one (row, limb) with the twiddles psi_br[1 .. P-1]; then the tile kernel
//   transforms each part as a row of 2^14 words, reading the part's own
//   table ([k, P, 2^14] Shoup pairs, entry j in [m', 2m') of part p holding
//   psi_br[(P + p) m' + j - m'], ntt.build_tables);
// - inverse: the tile kernel on each part with the parts' ipsi_br tables
//   and without N^-1, then the top pass (`ntt_inv_top_kernel`) runs the
//   last log2 P Gentleman-Sande stages and folds N^-1 into the last one.
// Between the two launches device memory holds, lazy (every q < 2^30):
// forward [0, 4q), inverse [0, 2q); eager: [0, q).  Those are the ranges
// the next launch's butterflies take; each direction ends in [0, q).  The
// split reads and writes each row twice, so it can reach at best half of
// the single-pass byte bound (PERF.md has both launches' times).  A cluster
// of P blocks exchanging the top stages through distributed shared memory
// would make one trip; not done.
//
// C interface for ctypes: the functions launch on the given stream, do not
// synchronise, allocate nothing and return cudaGetLastError().  The tensor
// must be 16-byte aligned (the bulk copies need it; the wrapper checks).

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int TILE_LOG = 14;
constexpr int TILE = 1 << TILE_LOG;  // words per tile
constexpr int THREADS = 1024;
// log2 of the transform length in a tile: the row, or one part of a longer row
__host__ __device__ constexpr int tile_log(int logn) { return logn < TILE_LOG ? logn : TILE_LOG; }
constexpr int E = 16;  // coefficients per thread in a pass
// Tile buffers: one transforming while the others drain their bulk store
// and load.  A third buffer lets each store drain for a whole tile.  On an
// H100 it saves the inverse about 2% and costs the forward about 2% at its
// eager shape (tools/torch_ntt_variants.py times both counts for both
// directions in alternating rounds).
__host__ __device__ constexpr int nbuf(bool fwd) { return fwd ? 2 : 3; }
__host__ __device__ constexpr int smem_bytes(bool fwd) { return nbuf(fwd) * TILE * 4; }

// One register pass: stages of butterfly distance 2^lt for lt in [lo, lo+r).
// pos[b] is the tile-index bit of the thread's local index bit b: bits 0-3
// pick the register, 4-8 are the lane, 9-13 the warp.
struct Pass {
  int lo, r;
  int pos[TILE_LOG];
};

__host__ __device__ constexpr int num_passes(int logn) { return 1 + (logn + 1) / 4; }

// Pass idx in order of ascending distance: idx 0 is the radix-4 pass (lt 0
// and 1), then passes of 4 stages (the top one shorter if log2 N - 2 is not
// a multiple of 4).  Registers take the pass's stage bits, then (when r < 4)
// the highest free coefficient bits, so one thread never spans two rows.
// Lanes take the lowest free bits of distinct value mod 5 among bits 0-9:
// the swizzle below maps bits b and b+5 onto the same bank bit.
__host__ __device__ constexpr Pass make_pass(int logn, int idx) {
  Pass p{0, 0, {}};
  p.lo = idx == 0 ? 0 : 2 + 4 * (idx - 1);
  p.r = idx == 0 ? 2 : (logn - p.lo < 4 ? logn - p.lo : 4);
  bool used[TILE_LOG] = {};
  int b = 0;
  for (; b < p.r; ++b) {
    p.pos[b] = p.lo + b;
    used[p.lo + b] = true;
  }
  for (int i = logn - 1; b < 4; --i)
    if (!used[i]) {
      p.pos[b++] = i;
      used[i] = true;
    }
  bool cls[5] = {};
  for (int i = 0; i < 10 && b < 9; ++i)
    if (!used[i] && !cls[i % 5]) {
      p.pos[b++] = i;
      used[i] = true;
      cls[i % 5] = true;
    }
  for (int i = 0; i < TILE_LOG; ++i)
    if (!used[i]) {
      p.pos[b++] = i;
      used[i] = true;
    }
  return p;
}

// tile-index offset of register e in pass p
__host__ __device__ constexpr uint32_t reg_off(const Pass& p, int e) {
  uint32_t o = 0;
  for (int b = 0; b < 4; ++b)
    if ((e >> b) & 1) o |= 1u << p.pos[b];
  return o;
}

// exchange layout: bits 0-4 XOR bits 5-9 (linear, so swz(a ^ b) = swz(a) ^ swz(b))
__host__ __device__ constexpr uint32_t swz(uint32_t i) { return i ^ ((i >> 5) & 31u); }

// the lanes of pass idx take tile bits 0-4: natural order is conflict-free
__host__ __device__ constexpr bool lanes_low(int logn, int idx) {
  const Pass p = make_pass(logn, idx);
  for (int j = 0; j < 5; ++j)
    if (p.pos[4 + j] != j) return false;
  return true;
}

template <int LOGN, int IDX>
__device__ __forceinline__ uint32_t thread_base(uint32_t tid) {
  constexpr Pass P = make_pass(LOGN, IDX);
  uint32_t o = 0;
#pragma unroll
  for (int b = 0; b < 10; ++b) o |= ((tid >> b) & 1u) << P.pos[4 + b];
  return o;
}

// every pass's thread_base, two 14-bit values to a register (64 registers a
// thread leave none to spare)
template <int LOGN, int I = 0>
__device__ __forceinline__ void fill_bases(uint32_t* base, uint32_t tid) {
  if constexpr (I < num_passes(LOGN)) {
    if (I % 2 == 0) base[I / 2] = 0;
    base[I / 2] |= thread_base<LOGN, I>(tid) << (16 * (I % 2));
    fill_bases<LOGN, I + 1>(base, tid);
  }
}

// a in [0, 2m) -> a mod m
__device__ __forceinline__ uint32_t red(uint32_t a, uint32_t m) { return min(a, a - m); }

// y * w mod q in [0, 2q) for any y < 2^32, w < q < 2^31, wp = floor(w 2^32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t y, uint32_t w, uint32_t wp, uint32_t q) {
  return y * w - __umulhi(y, wp) * q;
}

template <bool FWD, bool LAZY>
__device__ __forceinline__ void butterfly(uint32_t& x0, uint32_t& x1, uint2 w, uint32_t q) {
  const uint32_t q2 = q + q;
  if (FWD) {  // Cooley-Tukey: (u + w v, u - w v)
    if (LAZY) {  // [0, 4q) in and out
      const uint32_t u = red(x0, q2);
      const uint32_t v = shoup(x1, w.x, w.y, q);
      x0 = u + v;
      x1 = u + q2 - v;
    } else {  // [0, q) in and out
      const uint32_t u = x0;
      const uint32_t v = red(shoup(x1, w.x, w.y, q), q);
      const uint32_t d = u - v;
      x0 = red(u + v, q);
      x1 = min(d, d + q);
    }
  } else {  // Gentleman-Sande: (u + v, w (u - v))
    if (LAZY) {  // [0, 2q) in and out
      const uint32_t u = x0, v = x1;
      x0 = red(u + v, q2);
      x1 = shoup(u + q2 - v, w.x, w.y, q);
    } else {  // [0, q) in and out; Shoup takes u - v + q < 2q unreduced
      const uint32_t u = x0, v = x1;
      x0 = red(u + v, q);
      x1 = red(shoup(u + q - v, w.x, w.y, q), q);
    }
  }
}

// The inverse's last stage has the one twiddle ipsi_br[1]; N^-1 is folded
// into it: (u + v) N^-1 and (u - v) ipsi_br[1] N^-1, in [0, q)
template <bool LAZY>
__device__ __forceinline__ void fold_last(uint32_t& x0, uint32_t& x1, uint2 n0, uint2 n1,
                                          uint32_t q) {
  const uint32_t u = x0, v = x1;
  x0 = red(shoup(u + v, n0.x, n0.y, q), q);
  x1 = red(shoup(u + (LAZY ? q + q : q) - v, n1.x, n1.y, q), q);
}

struct Operands {
  const uint32_t* x;
  uint32_t* y;
  // Shoup pairs: tile kernels [k, P, N / P] (the parts' tables, P = 1 up to
  // N = 2^14), top passes [k, N] (psi_br or ipsi_br)
  const uint2* tw;
  const uint32_t* q;  // [k]
  const uint2* ninv;  // [k, 2] Shoup pairs N^-1, N^-1 ipsi_br[1] (inverse only)
  long long rows;
  int k;
};

// One register pass over the tile in s.  It reads the tile in natural order
// if IN_NAT (always after the bulk copy) and swz() order otherwise, and
// writes it in natural order if OUT_NAT (always before the bulk store).
// LOGN is the row's; the pass transforms rows (or parts of a row) of
// N = 2^tile_log(LOGN) words, and `row` counts those.
template <int LOGN, int IDX, bool FWD, bool LAZY, bool IN_NAT, bool OUT_NAT, bool LAST>
__device__ __forceinline__ void run_pass(uint32_t* s, uint32_t base, uint32_t row0,
                                         const Operands& op) {
  constexpr int TL = tile_log(LOGN), LOGP = LOGN - TL;  // P = 2^LOGP parts a row
  constexpr Pass P = make_pass(TL, IDX);
  constexpr int N = 1 << TL;
  uint32_t row = row0;
  if constexpr (TL < TILE_LOG) row += base >> TL;
  const uint32_t part = row % (static_cast<uint32_t>(op.k) << LOGP);  // limb * P + p
  const uint32_t limb = part >> LOGP;
  const uint32_t q = __ldg(op.q + limb);
  const uint2* tw = op.tw + static_cast<size_t>(part) * N;
  const uint32_t sbase = swz(base);

  uint32_t a[E];
  if (IN_NAT && P.lo == 0) {  // 4 groups of 4 neighbours, 16 bytes each
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + base + reg_off(P, 4 * h));
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      a[e] = IN_NAT ? s[base + reg_off(P, e)] : s[sbase ^ swz(reg_off(P, e))];
  }

  const uint32_t cbase = base & (N - 1);
  // registers per depth-first group (below): 4, or 8 for the eager inverse;
  // of 2, 4, 8 and 16 the fastest that no instance spills with on the H100
  constexpr int DF_BITS = (FWD || LAZY) ? 2 : 3;
  // the butterflies of stage p (register bit p) among the registers whose
  // bits DF_BITS-3 are hi, or among all 16 if hi < 0
  auto stage = [&](const int p, const int hi) {
    const int lt = P.lo + p;
    // the inverse's last stage folds N^-1 (a split row's top pass does it)
    if (!FWD && LAST && LOGP == 0 && lt == TL - 1) {
      const uint2 n0 = __ldg(op.ninv + 2 * limb), n1 = __ldg(op.ninv + 2 * limb + 1);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (((e >> p) & 1) || (hi >= 0 && (e >> DF_BITS) != hi)) continue;
        fold_last<LAZY>(a[e], a[e | (1 << p)], n0, n1, q);
      }
      return;
    }
    // twiddle index (N >> (lt+1)) + (coefficient >> (lt+1)), as in ntt.py
    const uint2* twg = tw + (N >> (lt + 1)) + (cbase >> (lt + 1));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (((e >> p) & 1) || (hi >= 0 && (e >> DF_BITS) != hi)) continue;
      if (p + 1 < P.r && (hi < 0 || p + 1 < DF_BITS)) {
        // registers e and f = e + 2^(p+1) (of the same group) take
        // neighbouring twiddles: one 16-byte load (an even index, since bit
        // lt+1 is a register bit)
        if ((e >> (p + 1)) & 1) continue;
        const int f = e | (1 << (p + 1));
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(twg + (reg_off(P, e) >> (lt + 1))));
        butterfly<FWD, LAZY>(a[e], a[e | (1 << p)], make_uint2(w.x, w.y), q);
        butterfly<FWD, LAZY>(a[f], a[f | (1 << p)], make_uint2(w.z, w.w), q);
      } else {
        const uint2 w = __ldg(twg + (reg_off(P, e) >> (lt + 1)));
        butterfly<FWD, LAZY>(a[e], a[e | (1 << p)], w, q);
      }
    }
  };
  // The stages below DF_BITS run depth first, on one group of 2^DF_BITS
  // registers at a time: their twiddles (up to 8 pairs at stage 0) then
  // never all wait in registers at once.  Forward: stages r-1 ... DEEP, then
  // per group DEEP-1 ... 0; the inverse the other way round.
  constexpr int DEEP = P.r < DF_BITS ? P.r : DF_BITS;
  if (FWD) {
#pragma unroll
    for (int p = P.r - 1; p >= DEEP; --p) stage(p, -1);
  }
#pragma unroll
  for (int h = 0; h < (DEEP ? E >> DF_BITS : 0); ++h) {
#pragma unroll
    for (int j = 0; j < DEEP; ++j) stage(FWD ? DEEP - 1 - j : j, h);
  }
  if (!FWD) {
#pragma unroll
    for (int p = DEEP; p < P.r; ++p) stage(p, -1);
  }

  if (FWD && LAZY && LAST) {
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = red(red(a[e], q + q), q);
  }
  // a pass that changes layout must not overwrite words others still read
  if (IN_NAT != OUT_NAT) __syncthreads();
  if (OUT_NAT && P.lo == 0) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      *reinterpret_cast<uint4*>(s + base + reg_off(P, 4 * h)) =
          make_uint4(a[4 * h], a[4 * h + 1], a[4 * h + 2], a[4 * h + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (OUT_NAT)
        s[base + reg_off(P, e)] = a[e];
      else
        s[sbase ^ swz(reg_off(P, e))] = a[e];
    }
  }
  // the bulk store reads through the async proxy
  if (LAST) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

template <int LOGN, bool FWD, bool LAZY, int J = 0>
__device__ __forceinline__ void run_passes(uint32_t* s, const uint32_t* base, uint32_t row0,
                                           const Operands& op) {
  constexpr int TL = tile_log(LOGN), NP = num_passes(TL);
  if constexpr (J < NP) {
    constexpr int I = FWD ? NP - 1 - J : J;  // forward: largest distance first
    constexpr int PREV = FWD ? I + 1 : I - 1, NEXT = FWD ? I - 1 : I + 1;
    // an exchange is in natural order when both its passes allow it
    constexpr bool IN_NAT = J == 0 || (lanes_low(TL, I) && lanes_low(TL, PREV));
    constexpr bool OUT_NAT = J == NP - 1 || (lanes_low(TL, I) && lanes_low(TL, NEXT));
    run_pass<LOGN, I, FWD, LAZY, IN_NAT, OUT_NAT, J == NP - 1>(
        s, (base[I / 2] >> (16 * (I % 2))) & 0xffffu, row0, op);
    run_passes<LOGN, FWD, LAZY, J + 1>(s, base, row0, op);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bulk copy of `bytes` from device memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int LOGN, bool FWD, bool LAZY>
__device__ __forceinline__ void ntt_tiles(const Operands& op) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int NBUF = nbuf(FWD);
  __shared__ __align__(8) uint64_t full[NBUF];
  constexpr int TL = tile_log(LOGN);
  constexpr int RPT = TILE >> TL;  // rows (or parts of rows) per tile
  constexpr uint32_t ROW_BYTES = 4u << TL;
  const uint32_t tid = threadIdx.x;
  const long long rows = op.rows << (LOGN - TL);  // of 2^TL words
  // 32-bit tile counts (tiles < 2^31, launch() checks) keep registers free
  const int ntiles = static_cast<int>((rows + RPT - 1) / RPT);
  const uint32_t bar = smem_addr(&full[0]);
  const uint32_t buf = smem_addr(smem);
  auto tile_bytes = [&](int t) {
    const long long left = rows - static_cast<long long>(t) * RPT;
    return static_cast<uint32_t>(left < RPT ? left : RPT) * ROW_BYTES;
  };
  auto tile_ptr = [](auto* p, int t) { return p + static_cast<size_t>(t) * TILE; };

  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar + 8 * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (static_cast<int>(blockIdx.x) < ntiles)
      bulk_load(buf, tile_ptr(op.x, blockIdx.x), tile_bytes(blockIdx.x), bar);
  }
  uint32_t base[(num_passes(TL) + 1) / 2];
  fill_bases<TL>(base, tid);
  __syncthreads();

  int it = 0;
  // tiles in turn: at any moment the SMs work on rows of every limb, which
  // spreads the twiddle reads over k tables
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int b = it % NBUF, nb = (it + 1) % NBUF;
    const int next = t + gridDim.x;
    if (tid == 0 && next < ntiles) {
      // buffer nb's bulk store, issued NBUF - 1 tiles ago, must have read it
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(NBUF - 2) : "memory");
      bulk_load(buf + nb * TILE * 4, tile_ptr(op.x, next), tile_bytes(next), bar + nb * 8);
    }
    mbar_wait(bar + b * 8, (it / NBUF) & 1);
    run_passes<LOGN, FWD, LAZY>(smem + b * TILE, base, static_cast<uint32_t>(t) * RPT, op);
    if (tid == 0) bulk_store(tile_ptr(op.y, t), buf + b * TILE * 4, tile_bytes(t));
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// K1: forward NTT, natural -> bit-reversed order
template <int LOGN, bool LAZY>
__global__ void __launch_bounds__(THREADS, 1) ntt_fwd_kernel(const Operands op) {
  ntt_tiles<LOGN, true, LAZY>(op);
}

// K2: inverse NTT, bit-reversed -> natural order, times N^-1
template <int LOGN, bool LAZY>
__global__ void __launch_bounds__(THREADS, 1) ntt_inv_kernel(const Operands op) {
  ntt_tiles<LOGN, false, LAZY>(op);
}

constexpr int TOP_THREADS = 256;
constexpr int TOP_WORDS = 4;  // consecutive words of each part a thread takes: 16 bytes
constexpr int TOP_BLOCKS_PER_ROW = TILE / (TOP_THREADS * TOP_WORDS);

// The stages of distance >= 2^14 of a row of N = P 2^14 words, elementwise:
// thread i of a row holds words 4i .. 4i+3 of each of the P parts (one
// 16-byte load and store each, neighbouring threads on neighbouring
// addresses).  Forward: the first log2 P stages (twiddles psi_br[1 .. P-1]);
// inverse: the last log2 P, N^-1 folded into the last.  x may be y.
template <int LOGN, bool FWD, bool LAZY>
__device__ __forceinline__ void ntt_top(const Operands& op) {
  constexpr int P = 1 << (LOGN - TILE_LOG);
  const uint32_t row = blockIdx.x / TOP_BLOCKS_PER_ROW;
  const uint32_t j = ((blockIdx.x % TOP_BLOCKS_PER_ROW) * TOP_THREADS + threadIdx.x) * TOP_WORDS;
  const uint32_t limb = row % static_cast<uint32_t>(op.k);
  const uint32_t q = __ldg(op.q + limb);
  const uint2* tw = op.tw + (static_cast<size_t>(limb) << LOGN);
  const size_t off = (static_cast<size_t>(row) << LOGN) + j;
  uint2 w[P];
#pragma unroll
  for (int i = 1; i < P; ++i) w[i] = __ldg(tw + i);
  uint32_t a[P][TOP_WORDS];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint4 v = *reinterpret_cast<const uint4*>(op.x + off + p * TILE);
    a[p][0] = v.x, a[p][1] = v.y, a[p][2] = v.z, a[p][3] = v.w;
  }
  // the stage with m groups pairs part i of group g with part i + d,
  // d = P / 2m, twiddle [m + g]
  if (FWD) {
#pragma unroll
    for (int m = 1; m < P; m *= 2) {
      const int d = P / (2 * m);
#pragma unroll
      for (int g = 0; g < m; ++g)
#pragma unroll
        for (int i = 0; i < d; ++i)
#pragma unroll
          for (int e = 0; e < TOP_WORDS; ++e)
            butterfly<true, LAZY>(a[2 * d * g + i][e], a[2 * d * g + i + d][e], w[m + g], q);
    }
  } else {
#pragma unroll
    for (int m = P / 2; m > 1; m /= 2) {
      const int d = P / (2 * m);
#pragma unroll
      for (int g = 0; g < m; ++g)
#pragma unroll
        for (int i = 0; i < d; ++i)
#pragma unroll
          for (int e = 0; e < TOP_WORDS; ++e)
            butterfly<false, LAZY>(a[2 * d * g + i][e], a[2 * d * g + i + d][e], w[m + g], q);
    }
    const uint2 n0 = __ldg(op.ninv + 2 * limb), n1 = __ldg(op.ninv + 2 * limb + 1);
#pragma unroll
    for (int i = 0; i < P / 2; ++i)
#pragma unroll
      for (int e = 0; e < TOP_WORDS; ++e) fold_last<LAZY>(a[i][e], a[i + P / 2][e], n0, n1, q);
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<uint4*>(op.y + off + p * TILE) =
        make_uint4(a[p][0], a[p][1], a[p][2], a[p][3]);
}

// K1's first launch for N > 2^14
template <int LOGN, bool LAZY>
__global__ void __launch_bounds__(TOP_THREADS) ntt_fwd_top_kernel(const Operands op) {
  ntt_top<LOGN, true, LAZY>(op);
}

// K2's second launch for N > 2^14
template <int LOGN, bool LAZY>
__global__ void __launch_bounds__(TOP_THREADS) ntt_inv_top_kernel(const Operands op) {
  ntt_top<LOGN, false, LAZY>(op);
}

// the shared-memory opt-in, once per kernel instance and device
cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

template <int LOGN, bool FWD, bool LAZY>
int launch(const Operands& op, int max_blocks, cudaStream_t stream) {
  void (*kernel)(const Operands) =
      FWD ? ntt_fwd_kernel<LOGN, LAZY> : ntt_inv_kernel<LOGN, LAZY>;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem_bytes(FWD));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int TL = tile_log(LOGN), RPT = TILE >> TL;
  if (op.rows >= (1LL << 31) >> (LOGN - TL)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = ((op.rows << (LOGN - TL)) + RPT - 1) / RPT;
  const long long grid = ntiles < max_blocks ? ntiles : max_blocks;
  kernel<<<static_cast<unsigned int>(grid), THREADS, smem_bytes(FWD), stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGN, bool FWD, bool LAZY>
int launch_top(const Operands& op, cudaStream_t stream) {
  void (*kernel)(const Operands) =
      FWD ? ntt_fwd_top_kernel<LOGN, LAZY> : ntt_inv_top_kernel<LOGN, LAZY>;
  if (op.rows >= (1LL << 31) / TOP_BLOCKS_PER_ROW) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(op.rows * TOP_BLOCKS_PER_ROW);
  kernel<<<grid, TOP_THREADS, 0, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <bool FWD, bool LAZY>
int dispatch(const Operands& op, int logn, bool top, int max_blocks, cudaStream_t stream) {
  if (top) {
    switch (logn) {
      case 15: return launch_top<15, FWD, LAZY>(op, stream);
      case 16: return launch_top<16, FWD, LAZY>(op, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (logn) {
    // N = 32 ... 128: the four-step NTT's local transforms (parallel/ntt_shard.py)
    case 5: return launch<5, FWD, LAZY>(op, max_blocks, stream);
    case 6: return launch<6, FWD, LAZY>(op, max_blocks, stream);
    case 7: return launch<7, FWD, LAZY>(op, max_blocks, stream);
    case 8: return launch<8, FWD, LAZY>(op, max_blocks, stream);
    case 9: return launch<9, FWD, LAZY>(op, max_blocks, stream);
    case 10: return launch<10, FWD, LAZY>(op, max_blocks, stream);
    case 11: return launch<11, FWD, LAZY>(op, max_blocks, stream);
    case 12: return launch<12, FWD, LAZY>(op, max_blocks, stream);
    case 13: return launch<13, FWD, LAZY>(op, max_blocks, stream);
    case 14: return launch<14, FWD, LAZY>(op, max_blocks, stream);
    case 15: return launch<15, FWD, LAZY>(op, max_blocks, stream);
    case 16: return launch<16, FWD, LAZY>(op, max_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// launches on `device`, leaving the caller's current device as it was
int run(bool fwd, bool top, const void* x, void* y, const void* tw, const void* q,
        const void* ninv, long long rows, int k, int logn, int lazy, int max_blocks, int device,
        void* stream) {
  const Operands op{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
                    static_cast<const uint2*>(tw), static_cast<const uint32_t*>(q),
                    static_cast<const uint2*>(ninv), rows, k};
  auto st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc;
  if (fwd)
    rc = lazy ? dispatch<true, true>(op, logn, top, max_blocks, st)
              : dispatch<true, false>(op, logn, top, max_blocks, st);
  else
    rc = lazy ? dispatch<false, true>(op, logn, top, max_blocks, st)
              : dispatch<false, false>(op, logn, top, max_blocks, st);
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0) rc = static_cast<int>(err);
  }
  return rc;
}

}  // namespace

extern "C" {

// The tile kernels.  tw: [k, P, N / P, 2] Shoup pairs of the parts' psi_br
// tables (P = 1 and the plain table up to N = 2^14); max_blocks: the grid's
// cap (one per SM).  N > 2^14: the forward's second launch.
int hhe_ntt_fwd(const void* x, void* y, const void* tw, const void* q, long long rows, int k,
                int logn, int lazy, int max_blocks, int device, void* stream) {
  return run(true, false, x, y, tw, q, nullptr, rows, k, logn, lazy, max_blocks, device, stream);
}

// tw: the same of ipsi_br; ninv: [k, 2, 2] Shoup pairs of N^-1 and
// N^-1 ipsi_br[1] (read only up to N = 2^14).  N > 2^14: the inverse's first
// launch, values left in [0, 2q) (lazy) or [0, q).
int hhe_ntt_inv(const void* x, void* y, const void* tw, const void* q, const void* ninv,
                long long rows, int k, int logn, int lazy, int max_blocks, int device,
                void* stream) {
  return run(false, false, x, y, tw, q, ninv, rows, k, logn, lazy, max_blocks, device, stream);
}

// The top passes for N = 2^15, 2^16.  tw: [k, N, 2] Shoup pairs of psi_br;
// the forward's first launch, values left in [0, 4q) (lazy) or [0, q).
int hhe_ntt_fwd_top(const void* x, void* y, const void* tw, const void* q, long long rows, int k,
                    int logn, int lazy, int device, void* stream) {
  return run(true, true, x, y, tw, q, nullptr, rows, k, logn, lazy, 0, device, stream);
}

// tw: [k, N, 2] Shoup pairs of ipsi_br; ninv as for hhe_ntt_inv
int hhe_ntt_inv_top(const void* x, void* y, const void* tw, const void* q, const void* ninv,
                    long long rows, int k, int logn, int lazy, int device, void* stream) {
  return run(false, true, x, y, tw, q, ninv, rows, k, logn, lazy, 0, device, stream);
}

const char* hhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
