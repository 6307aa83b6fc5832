"""tendermint_tpu_torch: the port of tendermint_tpu from JAX on a TPU to
PyTorch and hand-written CUDA kernels on an NVIDIA H100.

So far: ``ValidatorSet.verify_commit`` and the light client's
``ValidatorSet.verify_commit_trusting``, on the per-valset tabled ed25519
path (the set's keys tabulated once, three CUDA kernels for that and the
per-commit work, then the generic path's finish kernel), and on the
generic batched path for providers without tables (three CUDA kernels;
``ops/ed25519.py``, ``csrc/``); the light client's header verification
(``light.verifier``: ``verify``, ``verify_chain``, ``verify_backwards``),
with many commits in one device call (``verify_commits_batched``); and
the merkle roots ``ValidatorSet.hash`` and ``Commit.hash`` through two
SHA-256 CUDA kernels (``ops/sha256.py``, ``models/hasher.py``,
``crypto/merkle.py``); and BLS12-381 validators: per-signature BLS
commits and ``AggregatedCommit``s (one aggregate signature and a signer
bitmap) through ``ValidatorSet.verify_commit``, on three CUDA kernels,
the pairing check, the hash-to-G2 map and the G1 aggregate
(``ops/bls12.py``, ``models/bls.py``, ``crypto/bls.py``), in sets of BLS
keys or of BLS and ed25519 keys together; and the mesh runtime
(``parallel/``: ``DeviceTopology``, ``MeshRouter``), which splits a
bundle of rows over several devices for the verifier
(``TorchBatchVerifier(router=...)``, ``MeshRoutedVerifier``), the BLS
engine and the merkle engine, with the tally summed on the host; and
the block's data hash (``Txs.hash`` and proofs, ``Data``;
``types/tx.py``) through the same merkle kernels, and the mempool's tx
keys in bundles through the leaf kernel (``ingest.TxKeyHasher``). The
package imports torch,
numpy and the standard library, never jax and nothing of
tendermint_tpu. Entry points run on the card unless the caller passes
device="cpu".
"""

from tendermint_tpu_torch.crypto.batch import (
    BatchVerifier,
    CPUBatchVerifier,
    MeshRoutedVerifier,
    TorchBatchVerifier,
    default_provider,
    get_default_provider,
    make_provider,
    set_default_provider,
)
from tendermint_tpu_torch.crypto.bls import (
    BLSBatchVerifier,
    BLSPrivKey,
    BLSPubKey,
    get_default_bls_provider,
    make_bls_provider,
)
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
from tendermint_tpu_torch.ingest import TxKeyHasher
from tendermint_tpu_torch.models.bls import BLSEngine
from tendermint_tpu_torch.models.hasher import MerkleHasher
from tendermint_tpu_torch.models.verifier import VerifierModel
from tendermint_tpu_torch.ops.ed25519 import (
    build_valset_tables,
    verify_stage_finish,
    verify_stage_prepare,
    verify_stage_prepare_tabled,
    verify_stage_scan,
    verify_stage_scan_tabled,
)
from tendermint_tpu_torch.parallel import DeviceTopology, MeshRouter
from tendermint_tpu_torch.types.aggregate import AggregatedCommit, aggregate_commit_votes
from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, Data, Header, PartSetHeader
from tendermint_tpu_torch.types.tx import TxProof, Txs
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import (
    ErrInvalidCommit,
    ErrInvalidCommitSignature,
    ErrNotEnoughVotingPower,
    CommitVerifySpec,
    ValidatorSet,
    verify_commits_batched,
)
from tendermint_tpu_torch.utils.device import resolve_device

__all__ = [
    "AggregatedCommit",
    "BLSBatchVerifier",
    "BLSEngine",
    "BLSPrivKey",
    "BLSPubKey",
    "BatchVerifier",
    "BlockID",
    "CPUBatchVerifier",
    "Commit",
    "CommitSig",
    "CommitVerifySpec",
    "Data",
    "DeviceTopology",
    "Ed25519PrivKey",
    "Ed25519PubKey",
    "ErrInvalidCommit",
    "ErrInvalidCommitSignature",
    "ErrNotEnoughVotingPower",
    "Header",
    "MerkleHasher",
    "MeshRoutedVerifier",
    "MeshRouter",
    "PartSetHeader",
    "TorchBatchVerifier",
    "TxKeyHasher",
    "TxProof",
    "Txs",
    "Validator",
    "ValidatorSet",
    "VerifierModel",
    "aggregate_commit_votes",
    "build_valset_tables",
    "default_provider",
    "get_default_bls_provider",
    "get_default_provider",
    "make_bls_provider",
    "make_provider",
    "resolve_device",
    "set_default_provider",
    "verify_stage_finish",
    "verify_stage_prepare",
    "verify_stage_prepare_tabled",
    "verify_stage_scan",
    "verify_stage_scan_tabled",
    "verify_commits_batched",
]
