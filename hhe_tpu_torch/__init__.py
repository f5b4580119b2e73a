"""hhe_tpu_torch — the PyTorch/CUDA port of ``hhe_tpu`` for NVIDIA Hopper.

Same module layout as ``hhe_tpu`` so each piece has a named counterpart:

- ``ops``       — RNS-BFV engine (modular, ntt, rns, bfv, bfv_eval), PASTA-3,
  the homomorphic transcipher and HE linear algebra (helin); the NTT runs as
  hand-written CUDA kernels (``csrc/ntt.cu``, bound in ``ops/ntt_kernels``)
  for tensors on the card and as plain PyTorch for tensors on the CPU;
- ``models``    — the integer network (PocketNN: activations, batch norm,
  DFA/backprop steps, integer conv) and the dataset loaders;
- ``workloads`` — the encrypted inference pipelines (``hhe_inference``,
  ``he_conv``), QAT (``qat``), integer DFA training (``training``) and the
  float/integer/encrypted accuracy report (``float_baseline``);
- ``parties``   — the three-party gRPC protocol;
- ``utils``     — checks, configuration, metrics and serialization;
- ``convert``   — keys, ciphertexts and training state to and from the JAX
  package's arrays.

Residues are int32 tensors holding the JAX package's uint32 bits.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.  This package
imports neither JAX nor ``hhe_tpu``.
"""

__version__ = "0.1.0"
