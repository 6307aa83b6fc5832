"""Fixed-width canonical sign-bytes: the port's own copy of the JAX
package's ``codec/signbytes.py`` (the parts the commit path needs).

Every vote signs a fixed 160-byte layout, so a commit's N signatures form
a rectangular (N, 160) uint8 array and the ed25519 preimage
R(32) || A(32) || msg(160) is 224 bytes: two SHA-512 blocks for every row.

Layout (big-endian):

    offset  size  field
    0       1     signed-msg type (1=prevote, 2=precommit, 32=proposal)
    1       8     height (u64)
    9       8     round (i64)
    17      8     pol_round (i64; -1 for votes)
    25      32    block_id.hash (zeros for nil BlockID)
    57      4     block_id.parts.total (u32)
    61      32    block_id.parts.hash (zeros for nil)
    93      8     timestamp (i64 unix nanoseconds)
    101     32    chain-id commitment (utf-8 zero-padded if <= 32 bytes,
                  else sha256(chain_id))
    133     27    zero padding
"""

from __future__ import annotations

import hashlib
import struct

SIGN_BYTES_LEN = 160

PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32

BLOCK_ID_OFFSET = 25
BLOCK_ID_END = 93
TIMESTAMP_OFFSET = 93

_EMPTY32 = b"\x00" * 32


def chain_id_commitment(chain_id: str) -> bytes:
    raw = chain_id.encode("utf-8")
    if len(raw) <= 32:
        return raw.ljust(32, b"\x00")
    return hashlib.sha256(raw).digest()


def canonical_sign_bytes(
    msg_type: int,
    height: int,
    round_: int,
    block_hash: bytes,
    parts_total: int,
    parts_hash: bytes,
    timestamp_ns: int,
    chain_id: str,
    pol_round: int = -1,
) -> bytes:
    """Build the fixed 160-byte canonical sign-bytes."""
    if len(block_hash) not in (0, 32):
        raise ValueError("block hash must be empty or 32 bytes")
    if len(parts_hash) not in (0, 32):
        raise ValueError("parts hash must be empty or 32 bytes")
    out = struct.pack(
        ">BQqq32sI32sq32s",
        msg_type,
        height,
        round_,
        pol_round,
        block_hash or _EMPTY32,
        parts_total,
        parts_hash or _EMPTY32,
        timestamp_ns,
        chain_id_commitment(chain_id),
    )
    return out + b"\x00" * (SIGN_BYTES_LEN - len(out))


def splice_timestamps(rows, ts8):
    """Write each row's 8 big-endian timestamp bytes at TIMESTAMP_OFFSET,
    in place, and return the rows: the host form of what the tabled
    prepare kernel reads from a template and a timestamp."""
    rows[:, TIMESTAMP_OFFSET : TIMESTAMP_OFFSET + 8] = ts8
    return rows
