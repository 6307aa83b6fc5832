"""tendermint_tpu_torch: the port of tendermint_tpu from JAX on a TPU to
PyTorch and hand-written CUDA kernels on an NVIDIA H100.

This slice: ``ValidatorSet.verify_commit`` on the generic batched ed25519
path, through three CUDA kernels (``ops/ed25519.py``, ``csrc/``). The
package imports torch, numpy and the standard library, never jax and
nothing of tendermint_tpu. Entry points run on the card unless the caller
passes device="cpu".
"""

from tendermint_tpu_torch.crypto.batch import BatchVerifier, TorchBatchVerifier
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
from tendermint_tpu_torch.models.verifier import VerifierModel
from tendermint_tpu_torch.ops.ed25519 import (
    verify_stage_finish,
    verify_stage_prepare,
    verify_stage_scan,
)
from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import (
    ErrInvalidCommit,
    ErrInvalidCommitSignature,
    ErrNotEnoughVotingPower,
    ValidatorSet,
)
from tendermint_tpu_torch.utils.device import resolve_device

__all__ = [
    "BatchVerifier",
    "BlockID",
    "Commit",
    "CommitSig",
    "Ed25519PrivKey",
    "Ed25519PubKey",
    "ErrInvalidCommit",
    "ErrInvalidCommitSignature",
    "ErrNotEnoughVotingPower",
    "PartSetHeader",
    "TorchBatchVerifier",
    "Validator",
    "ValidatorSet",
    "VerifierModel",
    "resolve_device",
    "verify_stage_finish",
    "verify_stage_prepare",
    "verify_stage_scan",
]
