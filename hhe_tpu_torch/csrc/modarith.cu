// Montgomery arithmetic on RNS residues for Hopper (sm_90a): the elementwise
// Montgomery product (K3, `mont_mul` / `mont_mul_lazy`) and the Montgomery
// multiply-accumulate over one axis (K4, `mont_mac`).
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
// (eager).  K4 sums the terms t_d of one output word over the reduction
// axis, folding the sum back below 2q after each term, and reduces it once
// at the end: modular addition is exact, so any order of summation gives
// the bits of the plain version's log-depth tree of eager sums.
//
// Layout.  The wrapper (ops/mod_kernels.py) hands over the output's shape
// collapsed to MAXD dimensions (leading ones of size 1), and for each of the
// four operands a, b, q, qinv its element strides over those dimensions
// (0 where it is broadcast, never materialised) and along the reduction
// axis, or a scalar.  The output is contiguous.  A block takes one output
// row (all dimensions but the last) and 1024 (2048) words of it; a thread
// holds 4 words 256 apart or, where every operand that runs along the
// innermost axis does so contiguously and 16-byte aligned, two groups of 4
// consecutive words taken with 16-byte loads and stores 1024 apart.  A
// warp's accesses of the innermost axis coalesce either way, and K4's
// running sums stay in registers while the thread walks the reduction axis.
//
// What bounds it.  Each term costs three 32-bit integer multiplies (the
// wide product, m, hi(m q)) against 8-12 bytes of operands, far below the
// card's ratio of integer issue to memory bandwidth: both kernels are bound
// by the bytes of their operands and output, read and written once.  The
// JAX package's key contraction at production shapes reads ~0.74 GB of keys
// per call, which is what K4 streams at the site that dominates.  Tensor
// cores are no help for exact 31-bit modular products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 6;        // output dimensions after the wrapper's collapse
constexpr int NOPS = 4;        // a, b, q, qinv
constexpr int THREADS = 256;
constexpr int DESC_WORDS = 5 + NOPS * (4 + MAXD) + MAXD;

struct Operand {
  const void* ptr;             // null: the scalar
  long long stride[MAXD];      // elements, over the output's dimensions
  long long rstride;           // elements, along the reduction axis
  unsigned int scalar;
  int is64;                    // int64 storage (else int32)
};

struct Args {
  Operand op[NOPS];
  void* out;
  long long terms;             // length of the reduction axis; 1 for K3
  long long rows;              // product of size[0 .. MAXD - 2]
  unsigned int size[MAXD];
  int out64;
  int lazy;                    // K3 only: leave [0, 2q)
};

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

// a b 2^-32 mod q in [0, 2q) when a b < q 2^32 (the plain version's _redc)
__device__ __forceinline__ uint64_t redc(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(ab);
  const uint32_t m = lo * qinv;
  return (ab >> 32) + __umulhi(m, q) + (lo != 0u ? 1u : 0u);
}

// A thread takes GROUPS groups of W consecutive words, THREADS * W words
// apart.  W = 4: every group is 16-byte aligned and inner % 4 == 0 (the
// wrapper checks), so a group lies wholly inside the row or outside it.
template <int W, int GROUPS>
__global__ void __launch_bounds__(THREADS) mont_kernel(const Args g) {
  constexpr long long SPAN = static_cast<long long>(THREADS) * W;  // words between a thread's loads
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
          if (g.out64) static_cast<long long*>(g.out)[row * inner + j + w] = static_cast<long long>(x);
        }
        if (!g.out64) {
          int* out = static_cast<int*>(g.out) + row * inner + j;
          if (W == 4)
            *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
          else
            out[0] = static_cast<int>(v[0]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// desc (DESC_WORDS int64): out, out64, lazy, terms, vec; then for a, b, q,
// qinv: ptr (0: scalar), is64, scalar, rstride, stride[MAXD]; then
// size[MAXD].  vec: every operand that runs along the innermost axis does so
// contiguously from a 16-byte aligned word, with outer and reduction strides
// that are multiples of 4, and size[MAXD - 1] % 4 == 0 (the wrapper checks).
// Launches on `device` and leaves the caller's current device as it was.
int hhe_mont(const long long* desc, int device, void* stream) {
  Args g;
  g.out = reinterpret_cast<void*>(desc[0]);
  g.out64 = static_cast<int>(desc[1]);
  g.lazy = static_cast<int>(desc[2]);
  g.terms = desc[3];
  const bool vec = desc[4] != 0;
  const long long* p = desc + 5;
  for (int o = 0; o < NOPS; ++o, p += 4 + MAXD) {
    g.op[o].ptr = reinterpret_cast<const void*>(p[0]);
    g.op[o].is64 = static_cast<int>(p[1]);
    g.op[o].scalar = static_cast<unsigned int>(p[2]);
    g.op[o].rstride = p[3];
    for (int d = 0; d < MAXD; ++d) g.op[o].stride[d] = p[4 + d];
  }
  g.rows = 1;
  for (int d = 0; d < MAXD; ++d) {
    if (p[d] < 1 || p[d] >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    g.size[d] = static_cast<unsigned int>(p[d]);
    if (d < MAXD - 1) g.rows *= p[d];
  }
  if (g.rows >= (1LL << 31) || g.terms < 1 || (g.lazy && g.terms != 1) ||
      (vec && g.size[MAXD - 1] % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(THREADS) * (vec ? 4 * 2 : 4);
  const dim3 grid(static_cast<unsigned int>((g.size[MAXD - 1] + per_block - 1) / per_block),
                  static_cast<unsigned int>(g.rows < 65535 ? g.rows : 65535));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    mont_kernel<4, 2><<<grid, THREADS, 0, st>>>(g);
  else
    mont_kernel<1, 4><<<grid, THREADS, 0, st>>>(g);
  int rc = static_cast<int>(cudaGetLastError());
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0) rc = static_cast<int>(err);
  }
  return rc;
}

int hhe_mont_desc_words() { return DESC_WORDS; }

const char* hhe_mont_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
