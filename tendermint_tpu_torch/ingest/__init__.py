"""Mempool ingest: batched tx keys (``hashing.TxKeyHasher``)."""

from tendermint_tpu_torch.ingest.hashing import TxKeyHasher, host_keys, pack_msg_blocks

__all__ = ["TxKeyHasher", "host_keys", "pack_msg_blocks"]
