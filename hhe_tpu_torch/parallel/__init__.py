"""Multi-device parallelism of the port: process-group meshes over the
ciphertext batch (``mesh``) and the four-step NTT of one polynomial split
over ranks (``ntt_shard``) — counterpart of ``hhe_tpu.parallel``.

One process per device (``torch.distributed``: NCCL between cards, gloo on
the CPU).  The JAX package's two mesh axes keep their names: ``batch``
splits samples with no communication; ``limb`` is laid out, but every rank
keeps all RNS limbs (the JAX package shards them through every key-switch;
a tensor-parallel key-switch is not ported, ROADMAP F17).
"""
