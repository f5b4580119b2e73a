"""Multi-device parallelism of the port: process-group meshes over the
ciphertext batch and its RNS limbs (``mesh``), evaluation on one rank's
limbs (``limb_shard``) and the four-step NTT of one polynomial split over
ranks (``ntt_shard``) — counterpart of ``hhe_tpu.parallel``.

One process per device (``torch.distributed``: NCCL between cards, gloo on
the CPU).  The JAX package's two mesh axes keep their names: ``batch``
splits samples with no communication; ``limb`` splits the RNS limbs where
its size divides them, and the key-switches, BEHZ multiplies and the
keystream all-gather what crosses limbs (``limb_shard.LimbView``).
"""
