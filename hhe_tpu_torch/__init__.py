"""hhe_tpu_torch — the PyTorch/CUDA port of ``hhe_tpu`` for NVIDIA Hopper.

Same module layout as ``hhe_tpu`` so each piece has a named counterpart:

- ``ops``       — RNS-BFV engine (modular, ntt, rns, bfv, bfv_eval), PASTA-3,
  the homomorphic transcipher and HE linear algebra (helin); the NTT runs as
  hand-written CUDA kernels (``csrc/ntt.cu``, bound in ``ops/ntt_kernels``)
  for tensors on the card and as plain PyTorch for tensors on the CPU;
- ``models``    — the integer sigmoids of the HHE pipeline;
- ``workloads`` — the encrypted ECG inference (``hhe_inference``);
- ``utils``     — checks and the array container;
- ``convert``   — keys and ciphertexts to and from the JAX package's arrays.

Residues are int32 tensors holding the JAX package's uint32 bits.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.  This package
imports neither JAX nor ``hhe_tpu``.
"""

__version__ = "0.1.0"
