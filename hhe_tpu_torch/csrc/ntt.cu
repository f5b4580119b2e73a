// Negacyclic NTT over RNS limbs for Hopper (sm_90a): the forward and the
// inverse transform of every (batch row, limb) polynomial of an int32
// [..., k, N] tensor, modulo that limb's q < 2^31.
//
// Replaces the TPU kernels hhe_tpu/ops/ntt_pallas.py `_fwd_kernel` (forward,
// natural -> bit-reversed order) and `_inv_kernel` (inverse, bit-reversed ->
// natural order, then the factor N^-1).  Output is the canonical residue in
// [0, q), bit-identical to the plain PyTorch stage loop in ops/ntt.py
// (ntt_fwd_plain / ntt_inv_plain), which it is tested against.
//
// Design.  One thread block transforms one row: the row is loaded once into
// dynamic shared memory (4N bytes, 64 KB at N = 16384, hence the
// cudaFuncSetAttribute below), all log2(N) butterfly stages run there with a
// __syncthreads() between stages, and the row is written back once.  Each of
// the min(1024, N/2) threads does N/2 / blockDim butterflies per stage.
// Twiddles come from the same Montgomery tables as the plain version
// (psi_br / ipsi_br, indexed m + group), read through the cache.  The TPU
// kernel's roll+mask stage form, [R,128] transposes and per-position lane
// tables were workarounds for the TPU's vector layout and are not carried
// over.
//
// What bounds it.  The transform must read and write 8N bytes per row and
// does (N/2) log2(N) butterflies, each one 32x32->64 Montgomery product
// (lo = a*b, hi = umulhi(a,b), m = lo*qinv, umulhi(m,q)): 2 log2(N)
// multiplies per 8 bytes moved, 28 at N = 16384, so by the roofline (HBM at
// 3.35 TB/s against 32-bit multiplies) the bytes bound it.  In practice each
// butterfly also costs adds, compares, shared-memory address arithmetic and
// bank conflicts at strides below 32, and every stage ends in a barrier, so
// this simple form issues far more instructions than the bound assumes
// (chip_smoke.py reports its time beside the bound).  Hopper multiplies
// 32x32->64 natively, so the 16-bit digit products of the TPU version are
// not needed; lazy (Harvey) reduction saves a compare-and-subtract per
// butterfly when every modulus is below 2^30, and the 31-bit moduli of the
// BEHZ base take the eager form.  Radix-4 stages held in registers (fewer
// barriers and shared-memory round trips) are the next step for speed.
//
// C interface for ctypes: the functions launch on the given stream, do not
// synchronise, allocate nothing and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a * b * 2^-32 mod q in [0, 2q); needs a * b < q * 2^32.
__device__ __forceinline__ uint32_t redc(uint32_t a, uint32_t b, uint32_t q,
                                         uint32_t qinv_neg) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = lo * qinv_neg;
  // lo + lo(m*q) == 0 mod 2^32, so the carry out of the low half is lo != 0
  return hi + __umulhi(m, q) + (lo != 0u);
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q,
                                             uint32_t qinv_neg) {
  const uint32_t t = redc(a, b, q, qinv_neg);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

template <bool LAZY>
__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ psi_br,
                   const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ qinvs, int k, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % k);
  const uint32_t q = qs[limb];
  const uint32_t qi = qinvs[limb];
  const uint32_t two_q = q + q;  // < 2^31 when LAZY (q < 2^30)
  const uint32_t* tw = psi_br + static_cast<size_t>(limb) * n;
  const uint32_t* src = x + row * n;
  uint32_t* dst = y + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  // stage with m groups of butterflies at distance t = 2^lt
  for (int m = 1, lt = logn - 1; m < n; m <<= 1, --lt) {
    for (int b = threadIdx.x; b < (n >> 1); b += blockDim.x) {
      const int g = b >> lt;
      const int i0 = (g << (lt + 1)) + (b & ((1 << lt) - 1));
      const int i1 = i0 + (1 << lt);
      const uint32_t w = tw[m + g];
      uint32_t u = s[i0];
      if (LAZY) {  // values in [0, 4q)
        if (u >= two_q) u -= two_q;
        const uint32_t v = redc(s[i1], w, q, qi);  // [0, 2q)
        s[i0] = u + v;
        s[i1] = u + two_q - v;
      } else {  // values in [0, q)
        const uint32_t v = mont_mul(s[i1], w, q, qi);
        s[i0] = add_mod(u, v, q);
        s[i1] = sub_mod(u, v, q);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = s[i];
    if (LAZY) {
      if (v >= two_q) v -= two_q;
      if (v >= q) v -= q;
    }
    dst[i] = v;
  }
}

template <bool LAZY>
__global__ void __launch_bounds__(1024)
    ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ ipsi_br,
                   const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ qinvs,
                   const uint32_t* __restrict__ ninvs, int k, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % k);
  const uint32_t q = qs[limb];
  const uint32_t qi = qinvs[limb];
  const uint32_t two_q = q + q;
  const uint32_t* tw = ipsi_br + static_cast<size_t>(limb) * n;
  const uint32_t* src = x + row * n;
  uint32_t* dst = y + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  // stage with h groups of butterflies at distance t = 2^lt
  for (int lt = 0; lt < logn; ++lt) {
    const int h = n >> (lt + 1);
    for (int b = threadIdx.x; b < (n >> 1); b += blockDim.x) {
      const int g = b >> lt;
      const int i0 = (g << (lt + 1)) + (b & ((1 << lt) - 1));
      const int i1 = i0 + (1 << lt);
      const uint32_t w = tw[h + g];
      const uint32_t u = s[i0];
      const uint32_t v = s[i1];
      if (LAZY) {  // values in [0, 2q)
        uint32_t sum = u + v;
        if (sum >= two_q) sum -= two_q;
        s[i0] = sum;
        s[i1] = redc(u + two_q - v, w, q, qi);  // [0, 2q)
      } else {
        s[i0] = add_mod(u, v, q);
        s[i1] = mont_mul(sub_mod(u, v, q), w, q, qi);
      }
    }
    __syncthreads();
  }

  // x * N^-1: lazy x < 2q keeps x * ninv < q * 2^32, result in [0, q)
  const uint32_t ninv = ninvs[limb];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = mont_mul(s[i], ninv, q, qi);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long rows, int logn, cudaStream_t stream,
           Args... args) {
  const int n = 1 << logn;
  const int smem = n * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  kernel<<<static_cast<unsigned int>(rows), threads, smem, stream>>>(args...,
                                                                    logn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hhe_ntt_fwd(const void* x, void* y, const void* psi_br, const void* q,
                const void* qinv_neg, long long rows, int k, int logn, int lazy,
                void* stream) {
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* ys = static_cast<uint32_t*>(y);
  const auto* tw = static_cast<const uint32_t*>(psi_br);
  const auto* qs = static_cast<const uint32_t*>(q);
  const auto* qis = static_cast<const uint32_t*>(qinv_neg);
  auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch(ntt_fwd_kernel<true>, rows, logn, st, xs, ys, tw, qs, qis, k)
              : launch(ntt_fwd_kernel<false>, rows, logn, st, xs, ys, tw, qs, qis, k);
}

int hhe_ntt_inv(const void* x, void* y, const void* ipsi_br, const void* q,
                const void* qinv_neg, const void* ninv, long long rows, int k,
                int logn, int lazy, void* stream) {
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* ys = static_cast<uint32_t*>(y);
  const auto* tw = static_cast<const uint32_t*>(ipsi_br);
  const auto* qs = static_cast<const uint32_t*>(q);
  const auto* qis = static_cast<const uint32_t*>(qinv_neg);
  const auto* nis = static_cast<const uint32_t*>(ninv);
  auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch(ntt_inv_kernel<true>, rows, logn, st, xs, ys, tw, qs, qis, nis, k)
              : launch(ntt_inv_kernel<false>, rows, logn, st, xs, ys, tw, qs, qis, nis, k);
}

const char* hhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
