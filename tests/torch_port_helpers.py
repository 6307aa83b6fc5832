"""Inputs shared by the port's tests (tests/test_torch_*.py): signature
rows made from a numpy seed, with the adversarial cases of the JAX
package's own ed25519 tests, signed by the port's pure-Python oracle."""

import numpy as np

from tendermint_tpu_torch.ops import ref_ed25519 as ref

MSG_LEN = 160


def _first_undecodable(rng) -> bytes:
    while True:
        pk = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        if ref.pt_decode(pk) is None:
            return pk


def _random_msg(rng) -> bytes:
    return rng.integers(0, 256, MSG_LEN, dtype=np.uint8).tobytes()


def adversarial_rows(seed: int, n: int = 16, new_msg=_random_msg, flip_at: int = 0):
    """n rows (pubkey, msg, sig) and the oracle's verdicts. Besides honest
    rows: a flipped R bit, a flipped message byte (at `flip_at`), a
    flipped s bit, s + L, a pubkey that does not decompress, a
    non-canonical A.y (y = p + 1, sign bit set, so x = 0: accepted by
    Go), and small-order A and R. `new_msg(rng)` draws a message."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        msg = new_msg(rng)
        rows.append([ref.pubkey_from_seed(s), msg, ref.sign(s, msg)])
    pk, msg, sig = rows[1]
    rows[1][2] = bytes([sig[0] ^ 0x04]) + sig[1:]
    m = rows[2][1]
    rows[2][1] = m[:flip_at] + bytes([m[flip_at] ^ 0xFF]) + m[flip_at + 1:]
    sig = rows[3][2]
    rows[3][2] = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    sig = rows[4][2]
    s_plus_l = int.from_bytes(sig[32:], "little") + ref.L
    rows[4][2] = sig[:32] + s_plus_l.to_bytes(32, "little")
    rows[5][0] = _first_undecodable(rng)
    # A = (0, 1) written as y = p + 1 with the sign bit: [s]B - [k]A = [s]B
    r = int(rng.integers(1, 2**62))
    noncanon = ((ref.P + 1) | (1 << 255)).to_bytes(32, "little")
    rows[6][0] = noncanon
    rows[6][2] = ref.pt_encode(ref.pt_mul_base(r)) + r.to_bytes(32, "little")
    # A of order 2 (0, -1), R the identity, s = 0: accepted iff k is
    # even, so draw messages until Go's verifier accepts one
    rows[7][0] = (ref.P - 1).to_bytes(32, "little")
    rows[7][2] = (1).to_bytes(32, "little") + bytes(32)
    while not ref.verify(*rows[7]):
        rows[7][1] = new_msg(rng)
    want = [ref.verify(*row) for row in rows]
    return [tuple(row) for row in rows], want


def stack(rows, k: int) -> np.ndarray:
    return np.stack([np.frombuffer(r[k], dtype=np.uint8) for r in rows])


TIMESTAMP_OFFSET = 93  # of the canonical sign-bytes (codec/signbytes.py)


def templated_rows(seed: int, n: int = 16):
    """adversarial_rows whose messages are two seeded 160-byte templates
    with an 8-byte timestamp spliced in at TIMESTAMP_OFFSET (the flipped
    message byte is a timestamp byte). Returns (rows, want, templates
    (2,160), tmpl_idx (n,) int32, ts8 (n,8))."""
    o = TIMESTAMP_OFFSET
    templates = np.random.default_rng(seed + 1).integers(0, 256, (2, MSG_LEN), dtype=np.uint8)
    templates[:, o:o + 8] = 0

    def new_msg(rng):
        m = templates[int(rng.integers(0, 2))].copy()
        m[o:o + 8] = rng.integers(0, 256, 8, dtype=np.uint8)
        return m.tobytes()

    rows, want = adversarial_rows(seed, n, new_msg=new_msg, flip_at=o + 2)
    msgs = stack(rows, 1)
    blank = msgs.copy()
    blank[:, o:o + 8] = 0
    tmpl_idx = (blank != templates[0]).any(axis=1).astype(np.int32)
    assert (blank == templates[tmpl_idx]).all()
    return rows, want, templates, tmpl_idx, msgs[:, o:o + 8].copy()
