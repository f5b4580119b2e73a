"""Typed configuration for the HHE stack — counterpart of
``hhe_tpu.utils.config``: the reference's compiled-in global namespace
(``configs/config.{h,cpp}``) as frozen dataclasses with the same parameter
names, defaults and semantics.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HEConfig:
    """BFV parameters (reference ``configs/config.cpp:15-26``).

    The reference uses SEAL's BFVDefault coefficient modulus for
    ``mod_degree=16384`` (9 primes, 438 bits, 128-bit security).  This
    package, like the JAX one, keeps the degree, plaintext modulus and
    security level but cuts the chain into <=31-bit NTT-friendly primes, so
    that every residue fits a 32-bit word (see ``ops.primes``).
    """

    plain_mod: int = 65537
    mod_degree: int = 16384
    seclevel: int = 128
    # Total data-modulus bits (excl. special prime): SEAL's BFVDefault(16384)
    # leaves ~389 usable bits after the key-switch prime.
    data_modulus_bits: int = 390
    limb_bits: int = 30
    # The reference defaults use_bsgs=false with N1=16, N2=8
    # (config.cpp:20-21, pasta_3_seal.h:34-35); both packages default to the
    # BSGS matmul with a 32 x 4 split (ops/transcipher.py BSGS_N1, BSGS_N2).
    use_bsgs: bool = True
    bsgs_n1: int = 32
    bsgs_n2: int = 4
    use_batch: bool = True

    def replace(self, **kw) -> "HEConfig":
        return dataclasses.replace(self, **kw)

    def to_bfv_params(self, seed: int = 0):
        """Bridge to the engine's parameter object (ops.bfv.BFVParams)."""
        from ..ops.bfv import BFVParams

        return BFVParams(
            n=self.mod_degree,
            t=self.plain_mod,
            data_limb_bits=self.limb_bits,
            data_limbs=-(-self.data_modulus_bits // self.limb_bits),
            seed=seed,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Integer NN training hyperparameters (reference ``configs/config.cpp:29-43``)."""

    epoch: int = 50
    mini_batch_size: int = 4
    lr_inv: int = 50
    weight_lower_bound: int = -127
    weight_upper_bound: int = 128
    # MNIST dims
    dim_input: int = 784
    num_classes: int = 10
    fc1_dim: int = 100
    fc2_dim: int = 50


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime switches (reference ``configs/config.cpp:9-12``).

    ``dry_run`` caps dataset-scale runs at ``dry_run_num_samples`` (the
    reference slices its 13k-sample loops, ``hhe_pktnn_examples.cpp:188-207``);
    ``debugging`` enables per-stage noise-budget telemetry (the reference's
    debug path prints noise inside the transcipher rounds,
    ``pasta_3_seal.cpp:73``); ``verbose`` prints the experiment report."""

    debugging: bool = False
    verbose: bool = False
    dry_run: bool = True
    dry_run_num_samples: int = 2

    def sample_limit(self, n: int) -> int:
        """Number of samples a dataset-scale run should process."""
        return min(n, self.dry_run_num_samples) if self.dry_run else n


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Dataset / weight asset locations (reference ``configs/config.cpp:63-67``)."""

    dataset_input_path: str = "data/SpO2/inputs"
    dataset_output_path: str = "data/SpO2/labels"
    save_weight_path: str = "weights/SpO2/qat/quant_fc_5bits_data_2bits_weights.csv"
    save_bias_path: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    he: HEConfig = dataclasses.field(default_factory=HEConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)


DEFAULT = Config()
